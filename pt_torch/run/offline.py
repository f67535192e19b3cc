"""Offline rendering: sample/time-budgeted frames to image files.

Port of `pt.run.offline` (≙ the reference's offline-render flow): the UI's
Render button sets RenderSettings{OutputInfo, FrameCount, MaxSampleCount,
MaxTime} (Renderer.cpp:836-852) and each main-loop iteration accumulates
until TotalSamples ≥ MaxSampleCount or the time budget is hit
(Renderer.cpp:1696-1704), saves the frame, advances the animation by the
fixed 1/framerate step (deterministic video stepping,
Application.cpp:333-335), and finishes after FrameCount frames
(Renderer.cpp:1785-1807). Input is disabled during rendering
(BeginOfflineRendering, Application.cpp:412-439).

As in `pt`, a single-frame render can resume from a film checkpoint and
save one periodically; a render that is cancelled or raises deletes its
partial output and keeps the checkpoint. With `adaptive_tol` or
`adaptive_target_mse` each frame is one `render_adaptive` call (`pt`'s
rules: at least min(16, max_sample_count) samples a pixel, the time
budget at allocation-round granularity), and a checkpoint of the other
kind of film is not resumed. With `hdr` the PNG frames hold the HDR10 PQ
encoding (`Renderer.snapshot(hdr=True)`); an `.hdr` file keeps the linear
film either way. The "Rendering" stat counts the frames written (and says
where a resumed render started). Unlike `pt`, the render first waits for
the renderer's streamed textures, so no frame is shaded with the
placeholder pool.

Under a mesh (`Renderer(mesh=)`) every rank runs `render` with the same
settings: each renders its band and takes part in every snapshot and
checkpoint, and only the mesh's first rank writes the image, video or
checkpoint file. The loop's decisions (cancel, the time budget, a
checkpoint's turn) are OR-ed over the ranks after each step, so every rank
steps, saves and stops together. A render that raises under a mesh keeps
its last periodic checkpoint: saving one then would wait for ranks that
may be gone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Callable, Optional

from pt_torch.core.camera import InputCamera
from pt_torch.core.stats import Stats
from pt_torch.out.saver import OutputInfo, OutputSaver
from pt_torch.run.renderer import Renderer

log = logging.getLogger("pt_torch")


@dataclasses.dataclass
class RenderSettings:
    """≙ RenderSettings (Renderer.h): output + budgets."""
    output: OutputInfo
    frame_count: int = 1                 # >1 → numbered animation frames
    max_sample_count: int = 256          # ≤10000 in the reference UI
    max_time_seconds: Optional[float] = None
    samples_per_step: int = 8            # accumulation granularity
    hdr: bool = False                    # HDR10 PQ encoding of the frames
    # periodic film checkpointing for long single-frame renders: an
    # existing checkpoint is resumed with the exact RNG stream, deleted on
    # success
    checkpoint_path: Optional[str] = None     # frame_count == 1 only
    checkpoint_interval_seconds: float = 300.0
    # noise-driven per-pixel stopping (render_adaptive): pixels stop at a
    # 95% CI below this tonemapped tolerance instead of running the full
    # max_sample_count everywhere. None = uniform accumulation. One call
    # per frame; checkpoints and cancel() cannot interrupt it
    adaptive_tol: Optional[float] = None
    # global-MSE stopping instead; wins over adaptive_tol when both are set
    adaptive_target_mse: Optional[float] = None

    @property
    def adaptive(self) -> bool:
        return (self.adaptive_tol is not None
                or self.adaptive_target_mse is not None)


class OfflineRenderer:
    """Drives a Renderer through the offline state machine."""

    def __init__(self, renderer: Renderer, saver: Optional[OutputSaver] = None):
        self.renderer = renderer
        self.saver = saver or OutputSaver()
        self._cancelled = False

    def cancel(self) -> None:
        """≙ CancelRendering (Renderer.cpp:810-823). Under a mesh it takes
        effect after the ranks' next step, on every rank."""
        self._cancelled = True

    def _agreed_cancel(self) -> bool:
        self._cancelled = self.renderer.any_rank(self._cancelled)[0]
        return self._cancelled

    def _resume(self, ckpt: str, adaptive: bool) -> None:
        """Load the checkpoint at `ckpt` if there is one; an unusable file,
        or one of the other kind of film than `adaptive` asks for (an
        adaptive resume needs the per-pixel counts and moments), is logged
        and the render starts fresh."""
        r = self.renderer
        if not os.path.exists(ckpt):
            return
        try:
            r.load_checkpoint(ckpt)
        except Exception as exc:
            log.warning("checkpoint %s unusable (%s); starting fresh",
                        ckpt, exc)
            r.reset_accumulation()
            return
        have = r._spp_map is not None
        if r.total_samples and have != adaptive:
            log.warning("checkpoint %s holds a%s film but --adaptive is%s "
                        "set: cannot resume, starting fresh", ckpt,
                        "n adaptive" if have else " uniform",
                        "" if adaptive else " not")
            r.reset_accumulation()
        else:
            Stats.add_stat("Rendering", f"resumed at {r.total_samples} spp")

    def render(self, settings: RenderSettings,
               progress: Optional[Callable[[int, int, int], None]] = None) -> int:
        """Run to completion (or cancellation). Returns frames written.
        progress(frame, total_frames, samples) is called per step."""
        r = self.renderer
        out = settings.output
        if settings.frame_count > 1 and out.format != "mp4":
            out = out._replace(sequence=True)   # numbered image frames
        self._cancelled = False

        ckpt = settings.checkpoint_path if settings.frame_count == 1 else None
        writes = r.band == 0          # one device, or the mesh's first rank
        InputCamera.disable_input()
        r.on_resize(out.width, out.height)
        # the first sample sees the scene's own textures, and a swap can no
        # longer reset a film resumed from its checkpoint
        r.wait_for_textures()
        if writes:
            self.saver.register_output(out)
        frames_written = 0
        completed = False
        try:
            for frame in range(settings.frame_count):
                r.reset_accumulation()
                if ckpt and frame == 0:
                    self._resume(ckpt, settings.adaptive)
                start = time.perf_counter()
                last_ckpt = start
                if settings.adaptive:
                    r.render_adaptive(
                        tol=(5e-3 if settings.adaptive_tol is None
                             else settings.adaptive_tol),
                        target_mse=settings.adaptive_target_mse,
                        max_spp=settings.max_sample_count,
                        min_spp=min(16, settings.max_sample_count),
                        max_seconds=settings.max_time_seconds)
                    if progress:
                        progress(frame, settings.frame_count,
                                 r.total_samples)
                else:
                    while (not self._agreed_cancel()
                           and r.total_samples < settings.max_sample_count):
                        # clamp the last step so a resume never overshoots
                        # the requested budget
                        step = min(settings.samples_per_step,
                                   settings.max_sample_count
                                   - r.total_samples)
                        r.render(step)
                        if progress:
                            progress(frame, settings.frame_count,
                                     r.total_samples)
                        if r.total_samples >= settings.max_sample_count:
                            break
                        now = time.perf_counter()
                        out_of_time, ckpt_due = r.any_rank(
                            settings.max_time_seconds is not None
                            and now - start >= settings.max_time_seconds,
                            ckpt and (now - last_ckpt
                                      >= settings.checkpoint_interval_seconds))
                        if out_of_time:
                            break
                        if ckpt_due:
                            r.save_checkpoint(ckpt)
                            last_ckpt = now
                if self._agreed_cancel():
                    break
                # HDR files keep linear radiance; the rest goes through the
                # post stack
                image = (r.film_mean() if out.format == "hdr"
                         else r.snapshot(hdr=settings.hdr))
                if writes:
                    self.saver.submit_frame(image)
                frames_written += 1
                Stats.add_stat("Rendering",
                               f"{frames_written}/{settings.frame_count}")

                # deterministic fixed-dt animation stepping between frames
                if settings.frame_count > 1 and r.scene is not None:
                    changed = r.scene.update(1.0 / out.framerate)
                    r.update_scene_data(scene_changed=changed)
            completed = True
        finally:
            if self._cancelled or not completed:
                # cancelled or died mid-render: delete the partial output
                # but keep a checkpoint so the render can resume
                if writes:
                    self.saver.cancel_output()
                if (ckpt and r.total_samples > 0
                        and (completed or r.mesh is None)):
                    with contextlib.suppress(Exception):
                        r.save_checkpoint(ckpt)
            else:
                if writes:
                    self.saver.end_output()
                if ckpt and writes:
                    with contextlib.suppress(OSError):
                        os.remove(ckpt)
            InputCamera.enable_input()
        return frames_written
