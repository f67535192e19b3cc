"""K1's per-ray design (csrc/bf8_kernels.cu) timed on the static
Heightfield's real wavefronts, so that two checkouts' builds of it can be
compared inside one call on the card.

The Heightfield (n=224, 99,458 triangles, SBVH at block 32 collapsed to
BF8) is rendered at 512², 1 spp, 3 bounces, with every closest trace
recorded; the per-ray K1 (`kernels.closest_bf8_per_ray`; in a checkout
from before the warp K1, `kernels.closest_bf8`) and its pops variant are
timed on the bounce-0 and bounce-2 wavefronts (CUDA events, the least of 3
blocks of 5 launches behind a device sleep). Prints one JSON line: the
checkout whose `pt_torch` ran, the card's name and power limit, and ms per
launch.

    python -m pt_torch.benches.k1_per_ray
    PYTHONPATH=OTHER_CHECKOUT python pt_torch/benches/k1_per_ray.py

(the second form times OTHER_CHECKOUT's build with this script). Needs the
card.
"""

from __future__ import annotations

import json
import pathlib
import subprocess


def main(emit=print) -> dict:
    import torch
    import pt_torch
    from pt_torch.accel import kernels
    from pt_torch.benches import cuda_ms
    from pt_torch.render import integrator
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.renderer import Renderer
    from pt_torch.scene.examples import make_heightfield_scene
    if not torch.cuda.is_available():
        raise SystemExit("k1_per_ray: needs a CUDA device")
    per_ray = getattr(kernels, "closest_bf8_per_ray", kernels.closest_bf8)
    r = Renderer(PathTracingSettings(sample_count=1, bounce_count=3),
                 device="cuda")
    r.set_scene(make_heightfield_scene(224))
    r.on_resize(512, 512)
    r.render(1)                                       # builds the accel
    waves = []
    orig = integrator.trace_closest

    def record(bvh, o, d, t):
        waves.append((o.clone(), d.clone(), t.clone()))
        return orig(bvh, o, d, t)
    integrator.trace_closest = record
    try:
        r.render(1)
    finally:
        integrator.trace_closest = orig
    bvh = r.accel.bvh
    out = {"checkout": str(pathlib.Path(pt_torch.__file__).parents[1]),
           "device": torch.cuda.get_device_name(0),
           "power": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "wrapper": per_ray.__name__, "ms": {}}
    for b in (0, 2):
        o, d, t = waves[b]
        pops = torch.empty(o.shape[0], dtype=torch.int32, device=o.device)
        out["ms"][f"bounce{b}"] = min(
            cuda_ms(lambda: per_ray(bvh, o, d, t), 5) for _ in range(3))
        out["ms"][f"pops_bounce{b}"] = min(
            cuda_ms(lambda: per_ray(bvh, o, d, t, pops=pops), 5)
            for _ in range(3))
    emit(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
