"""Plain reference: a frozen copy of pt_torch/render/materials.py,
which the port may change without moving the yardstick.

Per-hit material resolution from the unified material table + textures.

Port of `pt.render.materials` (Shaders/material.glsl of the reference):
all three material models (MetallicRoughness / SpecularGlossiness / Phong)
are evaluated with vector selects, with the reference's spec-gloss →
metalness heuristic and XY normal reconstruction.
"""

from __future__ import annotations

from typing import Optional

import torch

from portbench.reference.bsdf import MaterialSample
from portbench.reference.texpool import DeviceTextures, sample_texture_grad
from portbench.reference.flatten import (DeviceScene, F_ATTEN_COLOR, F_ATTEN_DIST,
                                    F_COLOR, F_EMISSIVE, F_EMISSIVE_INT,
                                    F_GLOSS, F_IOR, F_METALNESS, F_ROUGHNESS,
                                    F_SPECULAR, F_TRANSMISSION, T_A, T_B,
                                    T_COLOR, T_EMISSIVE, T_NORMAL)
from portbench.reference.types import MaterialType


def reconstruct_normal_xy(n):
    """≙ ReconstructNormalFromXY (material.glsl:55-60)."""
    n = 2.0 * n - 1.0
    z = torch.sqrt(torch.clamp(1.0 - n[..., 0] ** 2 - n[..., 1] ** 2,
                               min=0.0))
    return torch.stack([n[..., 0], n[..., 1], z], dim=-1)


def sample_material(ds: DeviceScene, textures: DeviceTextures,
                    mat_row: torch.Tensor, uv: torch.Tensor,
                    is_inside: torch.Tensor,
                    dudx_dvdx: Optional[torch.Tensor] = None,
                    dudy_dvdy: Optional[torch.Tensor] = None,
                    nearest_mip: bool = False) -> MaterialSample:
    """Resolve a MaterialSample for each hit lane.

    mat_row: (N,) unified material rows (valid rows: callers clamp missed
    lanes); uv: (N, 2); is_inside: (N,) bool.
    """
    mat_row = mat_row.long()
    p = ds.mat_params[mat_row]          # (N, NUM_MAT_FIELDS)
    t = ds.mat_tex[mat_row]             # (N, NUM_MAT_TEX)
    mtype = ds.mat_type[mat_row]        # (N,)

    def tex(slot):
        return sample_texture_grad(textures, t[..., slot], uv,
                                   dudx_dvdx, dudy_dvdy,
                                   nearest_mip=nearest_mip)

    emissive = ((tex(T_EMISSIVE)[..., :3] + p[..., F_EMISSIVE:F_EMISSIVE + 3])
                * p[..., F_EMISSIVE_INT:F_EMISSIVE_INT + 1])
    color = tex(T_COLOR)[..., :3] * p[..., F_COLOR:F_COLOR + 3]
    normal = reconstruct_normal_xy(tex(T_NORMAL)[..., :3])
    if ds.flip_normal_y:  # DX-style normal maps
        normal = torch.stack([normal[..., 0], -normal[..., 1],
                              normal[..., 2]], dim=-1)

    tex_a = tex(T_A)
    tex_b = tex(T_B)

    # MetallicRoughness path: green=roughness, blue=metallic channels
    mr_rough = tex_a[..., 1] * p[..., F_ROUGHNESS]
    mr_metal = tex_b[..., 2] * p[..., F_METALNESS]

    # SpecularGlossiness / Phong path (identical math, different factor col)
    specular = tex_a[..., :3] * p[..., F_SPECULAR:F_SPECULAR + 3]
    gloss = tex_b[..., 3] * p[..., F_GLOSS]
    sg_rough = 1.0 - gloss
    # deliberately UNCLAMPED, matching the reference bug-for-bug
    # (material.glsl:109-110)
    diff = torch.clamp(specular - 0.04, min=0.0) / ((color - 0.04) + 1e-5)
    sg_metal = torch.mean(diff, dim=-1)

    is_mr = mtype == int(MaterialType.METALLIC_ROUGHNESS)
    roughness = torch.where(is_mr, mr_rough, sg_rough)
    metalness = torch.where(is_mr, mr_metal, sg_metal)

    ior = p[..., F_IOR]
    eta = torch.where(is_inside, ior, 1.0 / torch.clamp(ior, min=1e-6))

    return MaterialSample(
        color=color,
        emissive=emissive,
        normal=normal,
        roughness=roughness,
        metalness=metalness,
        transmission=p[..., F_TRANSMISSION],
        eta=eta,
        attenuation_color=p[..., F_ATTEN_COLOR:F_ATTEN_COLOR + 3],
        attenuation_distance=p[..., F_ATTEN_DIST],
    )
