"""Kernel A/B over a BF8 tree: pt's wide-walker closest hit against K1.

Port of `benches/widesub_ab.py`. `pt`'s `packet_closest_bf8w` merged its
1024-ray TPU walkers into `r_sub` times wider ones; a per-thread walk has no
walkers to merge, so every arm here runs K1's walk (`closest_bf8`) through
its own entry point: the production arm `closest_bf8` and
`packet_closest_bf8w` at r_sub 2, 4 and 8. The scene is the Heightfield at
n=224 or the Courtyard at `tex_scale` 1/16, under the SBVH at block 32
collapsed to BF8 (the renderer's static tree), with 65,536 seeded rays.

The checks come first (every arm against the brute oracle on the first
4,096 rays, `pt`'s |dt| > 1e-3 measure), then each arm is timed with CUDA
events twice, the second round a guard against contention, as in `pt`. One
JSON line per arm and round.

    python -m pt_torch.benches.widesub_ab [heightfield|courtyard]
        [--device cpu] [--rays N] [--n N]

With `--device cpu` the arms run their plain versions and nothing is timed.
"""

from __future__ import annotations

import argparse
import functools
import json

import torch

from pt_torch import default_device
from pt_torch.accel import archive, kernels
from pt_torch.accel.bvh8 import build_bf8, build_packet_bvh_sah
from pt_torch.accel.intersect import intersect_brute
from pt_torch.benches import cuda_ms, oracle_mismatches, random_rays
from pt_torch.scene.flatten import flatten_scene, world_vertices

N_RAYS = 65536
REPS = 10
ORACLE_RAYS = 4096
# ray origins: x, z range and y range, per scene (pt's)
BOXES = {"heightfield": (-9, 9, 0, 3), "courtyard": (-18, 18, 0.2, 8)}


def make_scene(name: str, n: int = 224):
    if name == "heightfield":
        from pt_torch.scene.examples import make_heightfield_scene
        return make_heightfield_scene(n)
    from pt_torch.scene.standin import make_courtyard_scene
    return make_courtyard_scene(tex_scale=1 / 16)


def main(device=None, n_rays: int = N_RAYS, scene: str = "heightfield",
         n: int = 224, reps: int = REPS, emit=print) -> dict:
    """Run the A/B on `device` (the card unless "cpu" is named) over
    `scene` ("heightfield" at grid size `n`, or "courtyard"). Returns
    {"arms": one dict per arm and round (the JSON lines), "tree": the
    BF8BVH, "workload": (origins, dirs, tmax)}."""
    dev = default_device(device)
    on_card = dev.type == "cuda"
    device_name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    ds = flatten_scene(make_scene(scene, n), device=dev)
    wpos = world_vertices(ds)[0]
    fine = build_packet_bvh_sah(wpos.cpu().numpy(), ds.tri_idx.cpu().numpy(),
                                block=32, max_leaves=8192,
                                tri_opaque_np=ds.tri_opaque.cpu().numpy(),
                                spatial=True, device=dev)
    bvh = build_bf8(fine) if fine is not None else None
    if bvh is None:
        raise RuntimeError(f"{scene}: no BF8 tree")
    o, d = random_rays(n_rays, BOXES[scene], dev)
    tmax = torch.full((n_rays,), 1e4, device=dev)
    m = min(ORACLE_RAYS, n_rays)
    oracle = intersect_brute(wpos, ds.tri_idx, o[:m], d[:m])

    arms = [("bf8 (production, 8x1024)", kernels.closest_bf8)]
    for r in (2, 4, 8):
        arms.append((f"bf8w r={r} ({8 // r}x{r * 1024})", functools.partial(
            archive.packet_closest_bf8w, r_sub=r)))
    found = [oracle_mismatches(fn(bvh, o, d, tmax).t[:m], oracle.t)
             for _, fn in arms]
    rows = []
    for rnd in ("", " (rep)"):
        for (label, fn), bad in zip(arms, found):
            ms = cuda_ms(lambda: fn(bvh, o, d, tmax), reps) if on_card else None
            row = dict(bench="widesub_ab", scene=scene, arm=label + rnd,
                       entry=getattr(fn, "func", fn).__name__, rays=n_rays,
                       triangles=int(ds.tri_idx.shape[0]),
                       pages=list(bvh.pages.shape), oracle_rays=m,
                       oracle_mismatches=bad, ms=ms,
                       mrays_per_s=None if ms is None
                       else n_rays / (ms * 1e3), device=device_name)
            emit(json.dumps(row))
            rows.append(row)
        if not on_card:
            break
    return dict(arms=rows, tree=bvh, workload=(o, d, tmax))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="heightfield",
                    choices=sorted(BOXES))
    ap.add_argument("--device", default=None)
    ap.add_argument("--rays", type=int, default=N_RAYS)
    ap.add_argument("--n", type=int, default=224)
    a = ap.parse_args()
    main(a.device, a.rays, a.scene, a.n)
