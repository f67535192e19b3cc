"""Traffic kind `video`: numbered frames, one render step each, the
animation stepped by 1/framerate between frames and every frame handed to
the saver. The seed sets the tick of the clip the video starts at (the
configuration's `CLIP_TICKS` at `TICKS_PER_SECOND`). The window closes at
the first hand-off past its length, and the render is then cancelled.

Its check (`check`) has two numbers, over `check_frames` frames drawn from
the seed among the window's first `VIDEO_CHECK_RANGE` (frame 0 always):

- `film_mismatch_pct`: the share, in percent, of `check_pixels` pixels
  drawn from the seed whose film disagrees with the reference's, the
  reference having stepped its own copy of the scene through the same
  clip;
- `post_max_abs`: the largest difference between a checked frame's image,
  as handed to the saver, and the reference's post stack (bloom, tone map)
  applied to that frame's film, both clipped to [0, 1] as the saver's 8-bit
  writers clip them (a film can hold negative radiance, which the tone map
  turns into values far below 0). This stage is judged from the port's own
  film; the film itself is checked from scratch above.
"""

from __future__ import annotations

import pathlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.lib.drive import pixel_sample, traversal_counted
from portbench.reference.compare import mismatch_pct

# video frames whose films the check keeps, drawn from the seed among the
# window's first VIDEO_CHECK_RANGE frames (frame 0 always among them)
VIDEO_CHECK_RANGE = 48


def run(cell, r, workdir: pathlib.Path) -> None:
    from pt_torch.out.saver import OutputInfo
    from pt_torch.run.offline import OfflineRenderer, RenderSettings
    t = cell.traffic
    rate = float(t["framerate"])
    skip, steps = int(t["trace_skip"]), int(t["trace_steps"])
    clip = int(getattr(cell.config, "CLIP_TICKS", 1))
    tps = float(getattr(cell.config, "TICKS_PER_SECOND", rate))
    scene = r.scene
    start = (cell.seed % clip) / tps
    r.update_scene_data(scene_changed=scene.update(start))
    cell.dts.append(start)
    fmt = t["format"]

    def settings(path, frames):
        path.parent.mkdir(parents=True, exist_ok=True)
        return RenderSettings(
            output=OutputInfo(str(path), cell.width, cell.height,
                              framerate=rate, format=fmt),
            frame_count=frames, max_sample_count=1, samples_per_step=1)
    # warm-up: two whole frames (update, rebuild, render, post, saver)
    warm = int(t["warm_frames"])
    OfflineRenderer(r).render(settings(workdir / "warm" / f"w.{fmt}",
                                       warm))
    cell.dts += [1.0 / rate] * warm
    dts = list(cell.dts)         # the clip's steps before the window
    cell.sync()

    rng = np.random.default_rng([cell.seed & ((1 << 63) - 1), 2])
    keep = {0} | set(rng.choice(np.arange(1, VIDEO_CHECK_RANGE),
                                size=int(t["check_frames"]) - 1,
                                replace=False).tolist())
    offline = OfflineRenderer(r)
    rec, tracing = cell.record, cell.tracing
    starts: List[float] = []
    kept: Dict[int, tuple] = {}
    deadline = [None]
    render, submit = r.render, offline.saver.submit_frame

    def timed_render(samples=None):
        now = time.perf_counter()
        starts.append(now)
        if deadline[0] is None:
            deadline[0] = now + cell.seconds
            rec.setup_s = now - cell.t_process
        return render(samples)

    def progress(frame, total, samples):
        cell.sync()

    if tracing is not None:
        submit = tracing.span("handoff", submit)

    def handoff(image):
        profiled = tracing is not None and tracing.profiling
        submit(image)
        now = time.perf_counter()
        j = len(rec.frames)
        begin = rec.frames[-1][1] if rec.frames else starts[0]
        rec.frames.append((begin, now))
        if j in keep:
            kept[j] = (image, r.accum.clone(), r.total_samples)
        if tracing is not None:
            tracing.frame = j + 1
            if j + 1 == skip:
                tracing.start_profile()
            elif j + 1 == skip + steps:
                tracing.stop_profile()
                rec.profiled_samples = steps
            if not profiled:
                rec.rays.append((r.rays_traced, now - begin))
        if now >= deadline[0]:
            offline.cancel()

    r.render = timed_render
    offline.saver.submit_frame = handoff
    if tracing is not None:
        r.render = tracing.span("render", timed_render)
        r.snapshot = tracing.span("snapshot", r.snapshot)
        r.update_scene_data = tracing.span("update", r.update_scene_data,
                                           timed=True)
        r._ensure_accel = tracing.span("rebuild", r._ensure_accel,
                                       timed=True)
        scene.update = tracing.span("scene_update", scene.update)
    with traversal_counted(tracing):
        offline.render(settings(workdir / "frames" / f"f.{fmt}", 1 << 24),
                       progress)
        if tracing is not None:
            if tracing.profiling:
                tracing.stop_profile()
                rec.profiled_samples = max(0, len(rec.frames) - skip)
            tracing.finish()
    for name in ("render", "snapshot", "update_scene_data",
                 "_ensure_accel"):
        r.__dict__.pop(name, None)
    scene.__dict__.pop("update", None)
    # the offline loop steps the clip after every frame it hands off
    cell.dts += [1.0 / rate] * len(rec.frames)
    rec.samples = len(rec.frames)
    rec.window_s = rec.frames[-1][1] - rec.frames[0][0]
    xs, ys = pixel_sample(cell.seed, cell.width, cell.height,
                          int(t["check_pixels"]))
    ix = (torch.as_tensor(ys, device=cell.device),
          torch.as_tensor(xs, device=cell.device))
    cell.outputs = dict(
        xs=xs, ys=ys, dts=dts, rate=rate,
        frames={j: dict(image=np.asarray(img), film_full=film.cpu(),
                        film=film[ix].cpu().numpy(), samples=n)
                for j, (img, film, n) in sorted(kept.items())})


def check(cell, outputs: dict, lowp: bool = False,
          cache: Optional[dict] = None) -> dict:
    """The compared numbers; with `lowp` the reference computes in
    bfloat16 storage, as the control. The reference steps its own scene
    from the clip's start, so no scene is kept across calls (`cache`)."""
    from portbench.reference.render import ReferenceScene
    ref = ReferenceScene(cell.calls, cell.config.NAME, cell.config.SETTINGS,
                         cell.device, lowp=lowp)
    xs, ys = outputs["xs"], outputs["ys"]
    step = 1.0 / outputs["rate"]
    ref.advance(outputs["dts"])
    done, port, mine, post = 0, [], [], 0.0
    for j, f in sorted(outputs["frames"].items()):
        ref.advance([step] * (j - done))
        done = j
        port.append(f["film"] / max(f["samples"], 1))
        # a frame's film holds one sample at RNG frame index 0: the offline
        # video restarts the film, and its counter, every frame
        mine.append(ref.film(xs, ys, range(f["samples"]), cell.width,
                             cell.height) / max(f["samples"], 1))
        image = ref.post(f["film_full"].to(ref.device), f["samples"])
        post = max(post, float(np.max(np.abs(
            np.clip(image, 0.0, 1.0) - np.clip(f["image"], 0.0, 1.0)))))
    return {"film_mismatch_pct": mismatch_pct(np.concatenate(port),
                                              np.concatenate(mine)),
            "post_max_abs": post}
