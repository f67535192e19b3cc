"""Traffic kind `still`: one frame, `samples_per_step` samples a step,
steps back to back until `max_time_seconds` (the window) runs out, the
film accumulating. The seed sets the RNG's first frame index, given to the
renderer as a film checkpoint of zeros that it resumes.

Its check (`check`) has two numbers:

- `early_mismatch_pct`: the share, in percent, of `early_pixels` pixels
  drawn from the seed whose film disagrees with the reference's after the
  window's first `early_steps` steps, read inside the window once those
  steps have ended. A fixed count of samples, so it reads the same whatever
  the program's speed, and a fault in a few percent of the pixels (one
  material, the foliage) shows.
- `final_mismatch_per_sample_pct`: the share of the first `check_pixels` of
  those pixels that disagree once the window has closed, its N samples
  each, as the share of samples that would give it: 100 x (1 - (1 - share)
  ^ (1 / N)). A sound film disagrees where one of a pixel's samples took
  another branch, so its share of pixels grows with N, and this number
  does not.
"""

from __future__ import annotations

import pathlib
import time
from typing import List, Optional

import numpy as np
import torch

from portbench.lib.drive import pixel_sample, traversal_counted
from portbench.reference.compare import mismatch_pct, per_sample_pct

# the first RNG frame index is the seed modulo this: far below the 32-bit
# wrap of the frame counter whatever the window adds
FRAME_SPAN = 1 << 30


def run(cell, r, workdir: pathlib.Path) -> None:
    from pt_torch.out.saver import OutputInfo
    from pt_torch.run.offline import OfflineRenderer, RenderSettings
    t = cell.traffic
    spp = int(t["samples_per_step"])
    frame0 = cell.seed % FRAME_SPAN
    # warm-up: the accel build, the kernels' first use and the compaction
    # plans of this film size
    r.render(spp)
    cell.sync()
    ckpt = workdir / "start.npz"
    np.savez_compressed(ckpt, accum=np.zeros((cell.height, cell.width, 3),
                                             np.float32),
                        total_samples=frame0, rays_total=0,
                        width=cell.width, height=cell.height)
    xs, ys = pixel_sample(cell.seed, cell.width, cell.height,
                          int(t["early_pixels"]))
    ix = (torch.as_tensor(ys, device=cell.device),
          torch.as_tensor(xs, device=cell.device))
    early_steps = int(t["early_steps"])
    early: List[np.ndarray] = []
    offline = OfflineRenderer(r)
    starts: List[float] = []
    rec, tracing = cell.record, cell.tracing
    render = r.render

    def timed_render(samples=None):
        starts.append(time.perf_counter())
        return render(samples)
    r.render = timed_render
    if tracing is not None:
        r.render = tracing.span("render", timed_render)
    skip, steps = int(t["trace_skip"]), int(t["trace_steps"])
    seen_rays = [0]

    def progress(frame, total, samples):
        cell.sync()
        end = time.perf_counter()
        rec.steps.append((starts[-1], end, spp))
        if tracing is not None:
            tracing.frame = len(rec.steps)
            if not tracing.profiling:
                total_rays = r.rays_traced
                rec.rays.append((total_rays - seen_rays[0],
                                 end - starts[-1]))
                seen_rays[0] = total_rays
            else:
                seen_rays[0] = r.rays_traced
            if len(rec.steps) == skip:
                tracing.start_profile()
            elif len(rec.steps) == skip + steps:
                tracing.stop_profile()
                rec.profiled_samples = steps * spp
        if len(rec.steps) == early_steps:
            # the early check's pixels, after the step's sync and outside
            # the profiled sub-window: a gather of a few thousand values
            early.append(r.accum[ix].cpu().numpy())
        if len(rec.steps) == 1:
            rec.setup_s = starts[0] - cell.t_process
    settings = RenderSettings(
        output=OutputInfo(str(workdir / "still.png"), cell.width,
                          cell.height, format=t["format"]),
        frame_count=1, max_sample_count=frame0 + (1 << 24),
        max_time_seconds=cell.seconds, samples_per_step=spp,
        checkpoint_path=str(ckpt), checkpoint_interval_seconds=1e9)
    with traversal_counted(tracing):
        offline.render(settings, progress)
        if tracing is not None:
            if tracing.profiling:
                tracing.stop_profile()
                rec.profiled_samples = (len(rec.steps) - skip) * spp
            tracing.finish()
    r.__dict__.pop("render", None)
    rec.samples = sum(s for _, _, s in rec.steps)
    rec.window_s = rec.steps[-1][1] - rec.steps[0][0]
    if r.total_samples != frame0 + rec.samples:
        raise RuntimeError(f"the film holds {r.total_samples - frame0} "
                           f"samples, the window counted {rec.samples}")
    n = int(t["check_pixels"])
    cell.outputs = dict(
        xs=xs, ys=ys, early=early[0] if early else None,
        early_frames=list(range(frame0, frame0 + early_steps * spp)),
        film=r.accum[ix[0][:n], ix[1][:n]].cpu().numpy(),
        frames=list(range(frame0, frame0 + rec.samples)))


def check(cell, outputs: dict, lowp: bool = False,
          cache: Optional[dict] = None) -> dict:
    """The compared numbers; with `lowp` the reference computes in
    bfloat16 storage, as the control. `cache` keeps the reference scene
    across calls (readings of several seeds)."""
    import copy

    from portbench.reference.render import ReferenceScene
    cache = {} if cache is None else cache
    if False not in cache:
        cache[False] = ReferenceScene(cell.calls, cell.config.NAME,
                                      cell.config.SETTINGS, cell.device)
    if lowp and True not in cache:
        low = copy.copy(cache[False])
        low.lowp, low._accel = True, None
        cache[True] = low
    ref = cache[lowp]
    xs, ys = outputs["xs"], outputs["ys"]
    out = {}
    k = len(outputs["early_frames"])
    if outputs["early"] is None:
        # the window ended before the early steps: no answer to judge
        out["early_mismatch_pct"] = float("nan")
    else:
        mine = ref.film(xs, ys, outputs["early_frames"], cell.width,
                        cell.height)
        out["early_mismatch_pct"] = mismatch_pct(outputs["early"] / k,
                                                 mine / k)
    n, frames = len(outputs["film"]), outputs["frames"]
    samples = max(len(frames), 1)
    mine = ref.film(xs[:n], ys[:n], frames, cell.width, cell.height)
    share = mismatch_pct(outputs["film"] / samples, mine / samples)
    out["final_mismatch_per_sample_pct"] = per_sample_pct(share, samples)
    return out
