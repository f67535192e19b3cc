"""`pt`'s `benches/` that reach a Pallas kernel, ported. The kernel A/B
harnesses (`bvh_kernels`, `widesub_ab`) check every arm against the brute
oracle first, then time it with CUDA events, and print one JSON line per
arm. The frame budget (`budget`) and the drain model (`drain_sim`) run
`pt`'s bench frame through the integrator and read K1's pops launch
(`kernels.closest_bf8(..., pops=)`). Run
them as `python -m pt_torch.benches.<name>` (on the card; `--device cpu`
runs the plain versions and times nothing)."""

from __future__ import annotations

import types

import numpy as np
import torch


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of `fn()` over `reps` launches after one warm
    launch. A device sleep (about 50 ms) is queued first, so that the host
    has enqueued every launch before the first one starts: a short kernel
    is timed without the host's per-call wrapper time between launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def oracle_mismatches(hit_t: torch.Tensor, oracle_t: torch.Tensor) -> int:
    """`pt`'s measure: rays whose t differs from the brute oracle's by more
    than 1e-3 (a miss is t = tmax in both)."""
    return int(((hit_t - oracle_t).abs() > 1e-3).sum())


def random_rays(n_rays: int, box, device, seed: int = 0):
    """`pt`'s bench rays: origins uniform over x, z in [box[0], box[1]] and
    y in [box[2], box[3]], unit directions from normals, both f32, from
    numpy's default_rng(seed)."""
    import numpy as np
    lo, hi, ylo, yhi = box
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n_rays, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(ylo, yhi, (n_rays,))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.as_tensor(o, device=device),
            torch.as_tensor(d.astype(np.float32), device=device))


def bench_frame(scene, width: int, bounces: int, device, block: int,
                spatial: bool) -> types.SimpleNamespace:
    """`pt`'s bench frame (benches/budget.py, benches/drain_sim.py): `scene`
    flattened on `device` with the default texture pool; its binned-SAH
    tree (`spatial`: the SBVH) at `block` with at most 8192 leaves,
    collapsed to BF8; the per-triangle attribute rows with that tree; and
    sample 0's primary rays in the renderer's tile order at width².
    Returns a namespace: ds, tex, accel, fine (the binary tree), bvh8,
    settings (1 spp, `bounces`) and carry (the bounce-0 carry)."""
    from pt_torch import default_device
    from pt_torch.accel.bvh8 import build_bf8, build_packet_bvh_sah
    from pt_torch.render.integrator import (PathTracingSettings,
                                            init_rng_state, prepare_attribs,
                                            raygen, start_carry)
    from pt_torch.render.textures import default_texture_pool
    from pt_torch.run.renderer import _tile_order
    from pt_torch.scene.flatten import flatten_scene
    dev = default_device(device)
    ds = flatten_scene(scene, device=dev)
    tex = default_texture_pool(dev)
    base = prepare_attribs(ds)
    fine = build_packet_bvh_sah(base.wpos.cpu().numpy(),
                                ds.tri_idx.cpu().numpy(), block=block,
                                max_leaves=8192, spatial=spatial, device=dev)
    bvh8 = build_bf8(fine) if fine is not None else None
    if bvh8 is None:
        raise RuntimeError("the bench frame's tree does not collapse to BF8")
    settings = PathTracingSettings(sample_count=1, bounce_count=bounces)
    cam = scene.cameras[0]
    cam.on_resize(width, width)
    mats = [torch.as_tensor(np.asarray(m, np.float32), device=dev)
            for m in (cam.inv_view, cam.inv_proj)]
    order = _tile_order(width, width)
    ys, xs = np.meshgrid(np.arange(width, dtype=np.int64),
                         np.arange(width, dtype=np.int64), indexing="ij")
    px = torch.as_tensor(xs.reshape(-1)[order], device=dev)
    py = torch.as_tensor(ys.reshape(-1)[order], device=dev)
    state = init_rng_state(px, py, width, 0)
    state, o, d, diff = raygen(px, py, width, width, *mats, state, settings)
    return types.SimpleNamespace(ds=ds, tex=tex,
                                 accel=base._replace(bvh=bvh8), fine=fine,
                                 bvh8=bvh8, settings=settings,
                                 carry=start_carry(state, o, d, diff))
