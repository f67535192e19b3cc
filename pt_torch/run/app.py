"""Application shell: lifecycle and the offline-render entry point.

Port of `pt.run.app` (≙ the reference's Application, Application.{h,cpp}):
ordered init of scene manager → renderer (Application.cpp:193-249), the
scene-import and rendering progress counters (Application.h:15-36), and
the offline-rendering entry point (BeginOfflineRendering,
Application.cpp:412-439).

The progressive loop (`run`), the config it reads (the refresh-rate
controller's limits), the shader hot-reload and the debug-frame switch
come with queue 1, item 8 of the port (the app shell and the viewer).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from pt_torch.post.pipeline import PostProcessSettings
from pt_torch.render.integrator import PathTracingSettings
from pt_torch.run.offline import OfflineRenderer, RenderSettings
from pt_torch.run.renderer import Renderer
from pt_torch.scene.manager import SceneManager


class BackgroundTasks:
    """Atomic {total, done} progress counters per task type
    (≙ BackgroundTask, Application.h:15-36): the two this shell advances."""

    TYPES = ("SceneImport", "Rendering")

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
    """≙ Application::Init/Shutdown and the offline entry point."""

    def __init__(self, device=None):
        """`device`: the renderer's (None → `cuda:0`, raising without a
        card; "cpu" runs the kernels' plain versions)."""
        self.tasks = BackgroundTasks()
        self.scene_manager = SceneManager()
        self.scene_manager.on_scene_loaded(
            lambda _scene: self.tasks.advance("SceneImport"))
        self.renderer = Renderer(device=device)

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
        # worker finishes; pt's run loop adopts the new one when it lands,
        # and the on_scene_loaded callback advances the task counter

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
