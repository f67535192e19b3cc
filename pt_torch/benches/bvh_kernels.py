"""Kernel A/B over binary trees: pt's closest-hit generations on the card.

Port of `benches/bvh_kernels.py`. The workload is the Heightfield at n=224
(99,458 triangles) under the native SAH tree at default arguments, with
65,536 seeded incoherent rays, once sorted by the integrator's coherence
keys and once unsorted, and their shadow rays toward a light at (0, -8, 0).
The arms are `pt`'s entry points: closest v1 `packet_closest`, v2
`packet_closest_sub`, v3 `packet_closest_v3` (all three the ordered walk,
`closest_ordered`) and v4 (K3 `closest_v4`, the stackless walk); occlusion
v1 `packet_occluded`, v2 `packet_occluded_sub` and v4 (all three K4's
threaded preorder walk).

The checks come first: every arm against the brute oracle on the first
4,096 rays (`pt`'s measure, |dt| > 1e-3; for occlusion, the oracle's hit
within dist), and every occlusion arm against v1 on all rays. Then each arm
is timed with CUDA events, over `reps` launches after a warm one (`pt`
chained them in a fori_loop). One JSON line per arm.

    python -m pt_torch.benches.bvh_kernels [--device cpu] [--rays N] [--n N]

With `--device cpu` the arms run their plain versions and nothing is timed.
"""

from __future__ import annotations

import argparse
import json

import torch

from pt_torch import default_device
from pt_torch.accel import archive, kernels
from pt_torch.accel.bvh8 import build_packet_bvh_sah
from pt_torch.accel.intersect import intersect_brute
from pt_torch.benches import cuda_ms, oracle_mismatches, random_rays
from pt_torch.render.integrator import _coherence_keys
from pt_torch.scene.examples import make_heightfield_scene
from pt_torch.scene.flatten import flatten_scene, world_vertices

N_RAYS = 65536
REPS = 10
ORACLE_RAYS = 4096
LIGHT = (0.0, -8.0, 0.0)

CLOSEST = (("closest v1 monolithic", archive.packet_closest),
           ("closest v2 sub-packet", archive.packet_closest_sub),
           ("closest v3 full-vreg", archive.packet_closest_v3),
           ("closest v4 phase-split", kernels.closest_v4))
OCCLUDED = (("occluded v1 monolithic shadow", archive.packet_occluded),
            ("occluded v2 sub-packet shadow", archive.packet_occluded_sub),
            ("occluded v4 phase-split shadow", kernels.occluded_v4))


def main(device=None, n_rays: int = N_RAYS, n: int = 224, reps: int = REPS,
         emit=print) -> dict:
    """Run the A/B on `device` (the card unless "cpu" is named) over the
    Heightfield at grid size `n`. Returns {"arms": one dict per arm (the
    JSON lines), "tree": the SAH PacketBVH, "workloads": {"sorted",
    "unsorted", "shadow"}: (origins, dirs, tmax or dist)}."""
    dev = default_device(device)
    on_card = dev.type == "cuda"
    device_name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    ds = flatten_scene(make_heightfield_scene(n), device=dev)
    wpos = world_vertices(ds)[0]
    sah = build_packet_bvh_sah(wpos.cpu().numpy(), ds.tri_idx.cpu().numpy(),
                               device=dev)
    if sah is None:
        raise RuntimeError("the SAH build gave no tree")
    o, d = random_rays(n_rays, (-9, 9, 0, 3), dev)
    alive = torch.ones(n_rays, dtype=torch.bool, device=dev)
    perm = torch.argsort(_coherence_keys(sah, o, d, alive), stable=True)
    tmax = torch.full((n_rays,), 1e4, device=dev)
    closest_sets = {"sorted": (o[perm], d[perm], tmax),
                    "unsorted": (o, d, tmax)}
    m = min(ORACLE_RAYS, n_rays)

    # checks first: every closest arm against the brute oracle
    checks = []
    for order, (oo, dd, tt) in closest_sets.items():
        oracle = intersect_brute(wpos, ds.tri_idx, oo[:m], dd[:m])
        for label, fn in CLOSEST:
            hit = fn(sah, oo, dd, tt)
            checks.append((f"{label} {order}", fn, (oo, dd, tt),
                           dict(oracle_mismatches=oracle_mismatches(
                               hit.t[:m], oracle.t))))
            if fn is archive.packet_closest_sub and order == "sorted":
                shadow_from = hit

    # shadow rays from just before the v2 hits toward the light
    o_s, d_s, _ = closest_sets["sorted"]
    t = shadow_from.t
    hit_t = torch.where(torch.isfinite(t) & (t < 1e3), t, 2.0)
    sp = o_s + d_s * (hit_t[:, None] * 0.99)
    to_l = torch.tensor(LIGHT, device=dev) - sp
    dist = torch.linalg.norm(to_l, dim=-1)
    d_sh = (to_l / dist[:, None]).contiguous()
    oracle_occ = intersect_brute(wpos, ds.tri_idx, sp[:m], d_sh[:m],
                                 tmax=dist[:m]).is_hit
    reference = None
    for label, fn in OCCLUDED:
        occ = fn(sah, sp, d_sh, dist)
        reference = occ if reference is None else reference
        checks.append((label, fn, (sp, d_sh, dist), dict(
            oracle_mismatches=int((occ[:m] != oracle_occ).sum()),
            disagree_with_v1=int((occ != reference).sum()))))

    arms = []
    for label, fn, args, found in checks:
        ms = cuda_ms(lambda: fn(sah, *args), reps) if on_card else None
        arm = dict(bench="bvh_kernels", arm=label, entry=fn.__name__,
                   rays=n_rays, triangles=int(ds.tri_idx.shape[0]),
                   oracle_rays=m, **found, ms=ms,
                   mrays_per_s=None if ms is None else n_rays / (ms * 1e3),
                   device=device_name)
        emit(json.dumps(arm))
        arms.append(arm)
    return dict(arms=arms, tree=sah,
                workloads=dict(**closest_sets, shadow=(sp, d_sh, dist)))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--rays", type=int, default=N_RAYS)
    ap.add_argument("--n", type=int, default=224)
    a = ap.parse_args()
    main(a.device, a.rays, a.n)
