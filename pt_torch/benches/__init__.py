"""The kernel A/B harnesses of `pt`'s `benches/`, ported: each checks every
arm against the brute oracle first, then times it with CUDA events, and
prints one JSON line per arm. Run them as `python -m pt_torch.benches.<name>`
(on the card; `--device cpu` checks the arms with the plain versions and
times nothing)."""

from __future__ import annotations

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
