"""pt_torch — the path tracer on PyTorch and hand-written CUDA kernels.

A port of the `pt` package (JAX/XLA/Pallas) to PyTorch with hand-written
Hopper (sm_90a) kernels for the BVH traversal. It mirrors `pt`'s layout
and names, so each module sits at the same path as its counterpart:

  pt_torch.core   — cameras, configuration
  pt_torch.scene  — scene data model, builder, graph, flattening (with
                    skinning), the texture pool of a scene, examples
  pt_torch.accel  — brute oracle, native SAH/SBVH build, BF8 collapse, the
                    per-frame Morton build and the CUDA traversal kernels
                    (accel/csrc)
  pt_torch.render — RNG, rays, BSDF, lights, materials, textures, integrator
                    (with the alpha re-trace loops)
  pt_torch.post   — bloom, tone mapping
  pt_torch.out    — image files (PNG without Pillow, Radiance HDR)
  pt_torch.run    — the progressive renderer and its per-frame scene update

Every entry point takes a `device` argument. It defaults to `cuda:0`; on a
machine without a CUDA device it raises unless the caller asks for the CPU
(`device="cpu"`), where each kernel is replaced by its plain PyTorch
version.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# keep the few 4x4 camera products (and any matmul) in full f32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device=None) -> torch.device:
    """Resolve an entry point's `device` argument.

    None means the card, `cuda:0`. Without a CUDA device that raises: the
    CPU is used only when the caller names it.
    """
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device "
                               "is available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda:0")
