"""Application shell: lifecycle, the frame loop (headless) and the
offline-render entry point.

Port of `pt.run.app` (≙ the reference's Application, Application.{h,cpp}):
ordered init of config → scene manager → renderer
(Application.cpp:193-249), the main loop (scene update → UpdateSceneData →
OnUpdate → Render, Application.cpp:251-365) with its debug-frame switch,
the background-task progress counters (Application.h:15-36), the shader
hot-reload (`reload_shaders`, the viewer's H key) and the offline-rendering
entry point (BeginOfflineRendering, Application.cpp:412-439).

Of the four counters `pt` declares, it drives "SceneImport" and
"Rendering"; the port also drives "ShaderCompilation", which counts the
modules `reload_shaders` has re-imported. "TextureUpload" is declared and,
as in `pt`, nothing advances it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from pt_torch.core.config import Config
from pt_torch.core.stats import Stats, Timer
from pt_torch.post.pipeline import PostProcessSettings
from pt_torch.render.integrator import PathTracingSettings
from pt_torch.run.offline import OfflineRenderer, RenderSettings
from pt_torch.run.renderer import Renderer
from pt_torch.scene.manager import SceneManager


class BackgroundTasks:
    """Atomic {total, done} progress counters per task type
    (≙ BackgroundTask, Application.h:15-36)."""

    TYPES = ("ShaderCompilation", "TextureUpload", "SceneImport", "Rendering")

    def __init__(self):
        self._lock = threading.Lock()
        self._tasks: Dict[str, list] = {t: [0, 0] for t in self.TYPES}

    def begin(self, task: str, total: int) -> None:
        with self._lock:
            self._tasks[task] = [total, 0]

    def advance(self, task: str, done: int = 1) -> None:
        with self._lock:
            self._tasks[task][1] += done

    def set_progress(self, task: str, done: int) -> None:
        with self._lock:
            self._tasks[task][1] = done

    def progress(self, task: str):
        with self._lock:
            total, done = self._tasks[task]
        return done, total


class Application:
    """≙ Application::Init/Run/Shutdown and the offline entry point."""

    def __init__(self, config: Optional[Config] = None, device=None):
        """`config`: the scene manager's Scenes and Assets directories and
        the renderer's samples-per-frame limits (`pt`'s defaults without
        one). `device`: the renderer's (None → `cuda:0`, raising without a
        card; "cpu" runs the kernels' plain versions)."""
        self.config = config or Config()
        self.tasks = BackgroundTasks()
        self.scene_manager = SceneManager(self.config)
        self.scene_manager.on_scene_loaded(
            lambda _scene: self.tasks.advance("SceneImport"))
        self.renderer = Renderer(
            device=device, min_refresh_rate=self.config.min_refresh_rate,
            max_samples_per_frame=self.config.max_samples_per_frame)
        self._running = False
        self._idle_published = False
        # the debug-pipeline switch (≙ SetDebugRaytracingPipeline and the
        # Debug tab's mode/flag buttons, UserInterface.cpp:1700-1764): when
        # set, run() presents single-trace debug frames instead of
        # accumulating path-traced samples
        self.debug_mode = None            # DebugRenderMode | None
        self.debug_flags = None           # DebugFlags | None

    # -- lifecycle -------------------------------------------------------
    def init(self, group: str = "Test Scenes", scene: str = "Default",
             width: int = 1280, height: int = 720) -> None:
        """≙ Application::Init boot sequence (ends with the Default scene
        active, SceneManager.cpp:100-105)."""
        self.scene_manager.set_active_scene(group, scene, blocking=True)
        sc = self.scene_manager.get_active_scene()
        if sc is None:
            raise RuntimeError(f"failed to load scene {group}/{scene}")
        self.renderer.set_scene(sc)
        self.renderer.on_resize(width, height)

    def set_scene(self, group: str, name: str, blocking: bool = True) -> None:
        self.tasks.begin("SceneImport", 1)
        self.scene_manager.set_active_scene(group, name, blocking=blocking)
        if blocking:
            sc = self.scene_manager.get_active_scene()
            if sc is not None:
                self.renderer.set_scene(sc)
            self.tasks.advance("SceneImport")
        # async: the manager keeps the previous scene active until its
        # worker finishes; the run loop's update step adopts the new one
        # when it lands, and the on_scene_loaded callback advances the
        # task counter

    # -- the frame loop ----------------------------------------------------
    def run(self, duration_seconds: float = 1.0,
            on_frame: Optional[Callable[[np.ndarray, int], None]] = None,
            target_frames: Optional[int] = None,
            adaptive_tol: Optional[float] = None,
            adaptive_frame_seconds: float = 0.25) -> int:
        """Progressive loop (≙ Application::Run): scene update → renderer
        update → one accumulation step; `on_frame(snapshot, total_samples)`
        stands in for the swapchain present. Returns the frames looped.

        `adaptive_tol` makes the step the adaptive film (`render_adaptive`)
        with `adaptive_frame_seconds` of refinement a frame: a fully
        converged view idles instead of sampling. With `debug_mode` set,
        each frame is one debug frame (`_render_debug_frame`) handed to
        `on_frame`, and nothing accumulates."""
        self._running = True
        frames = 0
        start = time.perf_counter()
        last = start
        while self._running:
            now = time.perf_counter()
            dt = now - last
            last = now
            with Timer("Frame total"):
                idle = False
                with Timer("Update"):
                    self._update_scene(dt)
                self.renderer.on_update(dt)
                # render()/render_adaptive() time themselves under the
                # "Render" stat
                if self.debug_mode is not None:
                    # the debug pipeline is active: a single-trace debug
                    # frame, no accumulation (≙ the reference swapping the
                    # active RT pipeline while the Debug tab is enabled)
                    if on_frame is not None:
                        on_frame(self._render_debug_frame(),
                                 self.renderer.total_samples)
                    idle = True      # no film to publish
                elif adaptive_tol is not None:
                    stats = self.renderer.render_adaptive(
                        tol=adaptive_tol, max_seconds=adaptive_frame_seconds,
                        min_spp=4, check_every=1)
                    if stats["steps"] == 0:
                        # a converged still view: idle, and after its first
                        # publish skip the postprocess and the copy too
                        time.sleep(0.05)
                        idle = self._idle_published
                        self._idle_published = True
                    else:
                        self._idle_published = False
                else:
                    self.renderer.render()
                if on_frame is not None and not idle:
                    on_frame(self.renderer.snapshot(),
                             self.renderer.total_samples)
            Stats.flush_timers()
            frames += 1
            if target_frames is not None:
                if frames >= target_frames:
                    break
            elif time.perf_counter() - start >= duration_seconds:
                break
        self._running = False
        return frames

    def _update_scene(self, dt: float) -> None:
        """The loop's update step: adopt a scene an async switch finished
        loading, advance the scene's animation by `dt`, and reset the film
        on a camera-only move (a moved instance also rebuilds the accel)."""
        r = self.renderer
        sc = self.scene_manager.get_active_scene()
        if sc is not None and sc is not r.scene:
            r.set_scene(sc)
        cam_changed = anim_changed = False
        if r.scene:
            cam_changed, anim_changed = r.scene.update_split(dt)
        r.update_scene_data(scene_changed=anim_changed)
        if cam_changed:
            r.reset_accumulation()
        if cam_changed or anim_changed:
            self._idle_published = False

    def stop(self) -> None:
        self._running = False

    def reload_shaders(self) -> None:
        """Dev hot-reload (≙ Renderer::ReloadShaders, Renderer.cpp:756,
        bound to the H key): re-import the shader-equivalent modules
        (shading, rng, rays, sampling, bsdf, materials, differentials,
        textures, the post stack, and the integrator that composes them)
        from disk, then the renderer module; move the live renderer onto
        the reloaded class and restart accumulation (≙ recompiling changed
        GLSL and relinking the pipelines, ShaderLibrary.cpp:224-298). Each
        re-imported module advances the "ShaderCompilation" counter.

        As in `pt`, the accel and kernel modules (`pt_torch.accel.*`) and
        the built kernel libraries are not reloaded: the live accel keeps
        its structures, as the reference's BLASes survive a shader reload,
        and the launch counters keep counting. The renderer's class-wide
        accel cache starts empty on the reloaded class. Modules that
        imported integrator names elsewhere (`pt_torch.render.debug`, the
        benches) keep the old code until the process restarts; the render
        path does not."""
        import importlib

        from pt_torch.post import pipeline
        from pt_torch.render import (bsdf, differentials, integrator,
                                     materials, rays, rng, sampling, shading,
                                     textures)
        import pt_torch.run.renderer as renderer_mod
        # leaf modules first, so that the integrator binds fresh names
        mods = (shading, rng, rays, sampling, bsdf, materials, differentials,
                textures, pipeline, integrator, renderer_mod)
        self.tasks.begin("ShaderCompilation", len(mods))
        for mod in mods:
            reloaded = importlib.reload(mod)
            self.tasks.advance("ShaderCompilation")
        # the live instance keeps its state (scene, film, accel, settings);
        # its methods now run the reloaded code
        self.renderer.__class__ = reloaded.Renderer
        if self.renderer.width:
            self.renderer.reset_accumulation()

    def _render_debug_frame(self) -> np.ndarray:
        """One frame of the debug renderer at the film size with the active
        camera (≙ RecordPathTracingCommands with the debug pipeline bound),
        clipped to [0, 1] on the host."""
        from pt_torch.render.debug import DebugFlags, render_debug_image
        r = self.renderer
        inv_view, inv_proj = r._camera_mats()
        img = render_debug_image(r.ds, r.tex, inv_view, inv_proj, r.width,
                                 r.height, self.debug_mode,
                                 flags=self.debug_flags or DebugFlags(),
                                 device=r.device)
        return np.clip(img.cpu().numpy(), 0.0, 1.0)

    # -- offline ----------------------------------------------------------
    def render_offline(self, settings: RenderSettings,
                       path_settings: Optional[PathTracingSettings] = None,
                       post: Optional[PostProcessSettings] = None,
                       progress=None) -> int:
        """≙ the UI Render button flow (SURVEY §3.4)."""
        if path_settings is not None or post is not None:
            self.renderer.set_settings(path_settings, post)
        self.tasks.begin("Rendering", settings.frame_count)
        offline = OfflineRenderer(self.renderer)

        def wrapped_progress(frame, total, samples):
            # frame is the 0-based index of the frame in progress; the
            # task counter reports completed frames
            self.tasks.set_progress("Rendering", frame)
            if progress:
                progress(frame, total, samples)

        frames = offline.render(settings, wrapped_progress)
        self.tasks.set_progress("Rendering", frames)
        return frames

    def shutdown(self) -> None:
        self.scene_manager.wait()
