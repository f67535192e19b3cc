"""Drain model: what re-balancing laggard warps could save, from K1's pops.

Port of `benches/drain_sim.py`. `pt`'s BF8 packet kernel runs each program
until its slowest 1024-ray sub-packet is done; `pt` read each sub's
completion round (its kernel's diagnostic row 5) and bounded what a drain
scheme would save: stop every program after B rounds, repack the unfinished
subs densely, continue. On the card the unit that steps in lockstep is the
warp. This reads each lane's pops from K1's pops launch
(`kernels.closest_bf8(..., pops=)`, the warp kernel's pops instance; its
hits are K1's). Each lane of the warp kernel walks its own stack and pops
what its per-ray walk pops, in the same order, pausing only while the warp
tests the pending leaves together; so the pops, and every number below,
are those of K1's first design, one thread per ray (`closest_bf8_per_ray(
..., pops=)`, the same pops bit for bit). The rounds and the lockstep are
a model of that one-thread-per-ray schedule, computed from each lane's
pops: they are not the warp kernel's own leaf-group rounds, which `pt` has
no counterpart of.

    pt (TPU packet kernel)                 port (one thread per ray)
    sub-packet: 1024 lanes in lockstep     warp: 32 lanes in lockstep
    program: n_sub subs in a grid step     block: T/32 warps (T threads,
                                           read from the library); its SM
                                           slot is held until its last warp
    round: one pop of the sub's stack      lane iteration: one pop of the
                                           lane's own stack (node or leaf)
    done[p, s]: round sub s drained        done[b, w]: max pops over the 32
                                           lanes of warp w in block b
    rounds[p] = max_s done[p, s]           rounds[b] = max_w done[b, w]

Lane i sits in block i // T and warp (i % T) // 32; lanes past N in the
last block count 0. `simulate` is `pt`'s, unchanged: on `done` it models
warps within blocks, and on the (warps, 32) lane pops it gives the lockstep
cost itself (the lanes' mean pops over their warp's max).

    python -m pt_torch.benches.drain_sim [heightfield|courtyard]
        [--device cpu] [--width W] [--bounces B] [--n N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pt_torch import default_device
from pt_torch.accel import kernels
from pt_torch.benches import bench_frame
from pt_torch.render.integrator import bounce_once
from pt_torch.render.rays import TMIN

WARP = 32           # lanes of a warp, which step in lockstep


def lanes_of(pops: torch.Tensor, threads: int) -> np.ndarray:
    """Per-lane pops (N,) laid out as the launch ran them: (B, threads //
    WARP, WARP) int64 with lane i at [i // T, (i % T) // 32, i % 32]; the
    lanes past N in the last block count 0."""
    p = pops.cpu().numpy().astype(np.int64)
    out = np.zeros(-(-p.size // threads) * threads, np.int64)
    out[:p.size] = p
    return out.reshape(-1, threads // WARP, WARP)


def done_rounds_of(bvh8, origins, dirs, tmax=1e30, pops=None):
    """(rounds per block (B,), per-warp completion rounds (B, W)) as numpy
    int64, from one pops launch of K1 (`closest_bf8(..., pops=)`) over the
    rays (tmax a scalar or (N,)): a warp's rounds are its lanes' most pops,
    a block's the most of its warps', as a one-thread-per-ray schedule of
    the same walks would step. `pops`, an (N,) int32 tensor on the rays'
    device, also receives each lane's pops."""
    n = origins.shape[0]
    limit = torch.as_tensor(tmax, dtype=torch.float32,
                            device=origins.device).expand(n).contiguous()
    if pops is None:
        pops = torch.empty(n, dtype=torch.int32, device=origins.device)
    kernels.closest_bf8(bvh8, origins.contiguous(), dirs.contiguous(), limit,
                        TMIN, pops=pops)
    done = lanes_of(pops, kernels.bf8_threads_per_block(
        origins.device)).max(axis=2)
    return done.max(axis=1), done


def simulate(done):
    """Drain-model costs from per-sub completion rounds (p, n_sub)."""
    p, n_sub = done.shape
    current = int(done.max(axis=1).sum())
    flat = np.sort(done.reshape(-1))[::-1]
    lower = max(int(np.ceil(flat.sum() / n_sub)), int(flat[0]))

    def packed_cost(rem):
        rem = np.sort(rem[rem > 0])[::-1]
        if rem.size == 0:
            return 0
        # descending LPT into groups of n_sub: group max = every n_sub-th
        return int(rem[::n_sub].sum())

    rows = []
    for b_q in (0.5, 0.6, 0.7, 0.8, 0.9):
        B = int(np.quantile(done.reshape(-1), b_q))
        pass1 = int(np.minimum(done.max(axis=1), B).sum())
        pass2 = packed_cost((done - B).reshape(-1))
        rows.append((B, pass1, pass2, pass1 + pass2))
    return current, lower, rows


def make_scene(name: str, n: int = 224, tex_scale: float = 1.0):
    """`pt`'s drain scenes: the Heightfield at grid size `n`, or the
    Courtyard at detail 1.0 (`tex_scale` cuts its texture sizes only)."""
    if name == "heightfield":
        from pt_torch.scene.examples import make_heightfield_scene
        return make_heightfield_scene(n)
    from pt_torch.scene.standin import make_courtyard_scene
    return make_courtyard_scene(tex_scale=tex_scale)


def _model_lines(what, unit, current, lower, rows):
    lines = [f"  {what}: current {current} {unit}; perfect-balance bound "
             f"{lower} ({current / max(lower, 1):.2f}x headroom)"]
    for B, p1, p2, tot in rows:
        lines.append(f"  {what} two-pass B={B:4d}: pass1 {p1:6d} + packed "
                     f"pass2 {p2:6d} = {tot:6d}  "
                     f"({current / max(tot, 1):.2f}x)")
    return lines


def main(device=None, scene: str = "heightfield", width: int = 512,
         bounces: int = 3, n: int = 224, emit=print,
         tex_scale: float = 1.0) -> dict:
    """The drain model on `device` (the card unless "cpu" is named) for
    `scene` at width², over `bounces` bounces of sample 0: per bounce one
    `done_rounds_of` (K1's pops launch), `simulate` of warps within blocks
    and of lanes within warps, then the carry advances through
    `bounce_once`. Returns {"scene", "tree" (the BF8BVH), "triangles",
    "device", "bounces": per bounce its alive lanes, rounds, done, pops,
    the traced rays ("wavefront": origins, dirs, tmax), both models and
    the lockstep share}."""
    dev = default_device(device)
    f = bench_frame(make_scene(scene, n, tex_scale), width, 5, dev,
                    block=32 if scene == "heightfield" else 64, spatial=True)
    bvh8 = f.bvh8
    emit(f"{scene}: {bvh8.n8} bf8 nodes, {bvh8.n_leaves} leaves, "
         f"{int(f.ds.tri_idx.shape[0])} triangles, "
         f"{kernels.bf8_threads_per_block(dev)} threads per block")
    carry = f.carry
    out = []
    for b in range(bounces):
        o, d = carry.origin, carry.direction
        pops = torch.empty(o.shape[0], dtype=torch.int32, device=dev)
        rounds, done = done_rounds_of(bvh8, o, d, pops=pops)
        lanes = lanes_of(pops, kernels.bf8_threads_per_block(dev))
        alive = int(carry.alive.sum())
        w = done.reshape(-1)
        current, lower, rows = simulate(done)
        l_current, l_lower, l_rows = simulate(lanes.reshape(-1, WARP))
        lockstep = float(lanes.sum()) / max(WARP * l_current, 1)
        emit(f"bounce {b} (alive {alive}): per-warp rounds mean "
             f"{w.mean():.1f} p50 {int(np.median(w))} p95 "
             f"{int(np.quantile(w, 0.95))} max {int(w.max())}; per-block max "
             f"p50 {int(np.median(rounds))} ({len(rounds)} blocks of "
             f"{done.shape[1]} warps)")
        for line in (_model_lines("warps in blocks", "rounds", current, lower,
                                  rows)
                     + _model_lines("lanes in warps", "warp iterations",
                                    l_current, l_lower, l_rows)):
            emit(line)
        emit(f"  lockstep: lanes' mean pops over their warp's max "
             f"{lockstep:.3f} ({int(lanes.sum())} lane pops in "
             f"{l_current} warp iterations x {WARP} lanes)")
        out.append(dict(bounce=b, alive=alive, rounds=rounds, done=done,
                        pops=pops, wavefront=(o, d, 1e30), current=current,
                        lower=lower, rows=rows, lane_current=l_current,
                        lane_lower=l_lower, lane_rows=l_rows,
                        lockstep=lockstep))
        carry = bounce_once(f.ds, f.tex, f.accel, carry, f.settings, b)
    return dict(scene=scene, tree=bvh8, triangles=int(f.ds.tri_idx.shape[0]),
                device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"), bounces=out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="heightfield",
                    choices=["heightfield", "courtyard"])
    ap.add_argument("--device", default=None)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--n", type=int, default=224)
    a = ap.parse_args()
    main(a.device, a.scene, a.width, a.bounces, a.n)
