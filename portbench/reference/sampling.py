"""Plain reference: a frozen copy of pt_torch/render/sampling.py,
which the port may change without moving the yardstick.

Sampling primitives + light sampling.

Port of `pt.render.sampling` (Shaders/common.glsl:169-197 and
Shaders/sampling.glsl:17-56 of the reference): concentric disk, cosine
hemisphere, tangent-space construction, and the uniform pick among point
lights + one directional light.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.shading import PI, _axis, _normalize, cross, matvec

DIRECTIONAL_LIGHT_DISTANCE = 100000.0


def sample_uniform_disk_concentric(u1, u2):
    """PBRT concentric disk mapping (≙ sampleUniformDiskConcentric,
    common.glsl:169-186). Returns (x, y)."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    x_major = torch.abs(ox) > torch.abs(oy)
    safe_ox = torch.where(ox == 0.0, 1.0, ox)
    safe_oy = torch.where(oy == 0.0, 1.0, oy)
    theta = torch.where(x_major, PI / 4 * (oy / safe_ox),
                        PI / 2 - PI / 4 * (ox / safe_oy))
    r = torch.where(x_major, ox, oy)
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    return x, y


def sample_cosine_hemisphere(u1, u2):
    """≙ sampleCosineHemisphere (common.glsl:188-193); z-up."""
    x, y = sample_uniform_disk_concentric(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def compute_tangent_space(normal):
    """Orthonormal TBN columns for a normal (≙ computeTangentSpace,
    common.glsl:195-202). Returns (..., 3, 3) with columns T, B, N."""
    t1 = cross(normal, _axis(0, normal))
    t2 = cross(normal, _axis(1, normal))
    n1 = torch.sqrt(torch.sum(t1 * t1, dim=-1))
    n2 = torch.sqrt(torch.sum(t2 * t2, dim=-1))
    use1 = (n1 > n2)[..., None]
    tangent = _normalize(torch.where(use1, t1, t2))
    bitangent = _normalize(cross(normal, tangent))
    return torch.stack([tangent, bitangent, normal], dim=-1)


class LightSample(NamedTuple):
    """≙ LightSample (sampling.glsl:17-23)."""
    direction: torch.Tensor     # (..., 3) direction *from* light *to* shading point
    distance: torch.Tensor      # (...,)
    color: torch.Tensor         # (..., 3)
    attenuation: torch.Tensor   # (...,)
    pdf: torch.Tensor           # (...,) uniform 1/(count+1)
    is_directional: torch.Tensor  # (...,) bool — picked the directional light


def sample_light(u1, u2, u3, position, point_color, point_pos, point_atten,
                 point_count, dir_color, dir_dir) -> LightSample:
    """Uniformly pick one light among point lights + the directional light
    (≙ sampleLight, sampling.glsl:25-56): index = u1*(count+1); index==count
    selects the directional light with a 0.001-radius disk softener, point
    lights use a 0.1-radius disk at the light and clamped 1/(c+l·d+q·d²)
    attenuation. Both variants are computed and the per-lane pick selects.

    `point_count` is a 0-d int tensor (kept on the device: no host sync).
    """
    count = point_count.to(torch.float32)
    idx = torch.floor(u1 * (count + 1.0)).to(torch.int64)
    pdf = 1.0 / (count + 1.0)
    is_dir = idx >= point_count

    dx, dy = sample_uniform_disk_concentric(u2, u3)

    # --- directional variant (disk-softened direction) ---
    ddir = _normalize(dir_dir.expand(position.shape))
    frame_d = compute_tangent_space(ddir)
    disk_d = torch.stack([dx, dy, torch.zeros_like(dx)], dim=-1) * 0.001
    dir_direction = _normalize(ddir + matvec(frame_d, disk_d))

    # --- point-light variant ---
    safe_idx = torch.minimum(idx, torch.clamp(point_count - 1, min=0))
    lcolor = point_color[safe_idx]
    lpos = point_pos[safe_idx]
    latten = point_atten[safe_idx]
    to_point = _normalize(position - lpos)
    frame_p = compute_tangent_space(to_point)
    disk_p = torch.stack([dx, dy, torch.zeros_like(dx)], dim=-1) * 0.1
    new_pos = lpos + matvec(frame_p, disk_p)
    diff = position - new_pos
    dist_p = torch.sqrt(torch.sum(diff * diff, dim=-1))
    dir_p = _normalize(diff)
    atten_p = 1.0 / (latten[..., 0] + dist_p * latten[..., 1]
                     + dist_p * dist_p * latten[..., 2])
    atten_p = torch.clamp(atten_p, 0.0, 1.0)

    sel = is_dir[..., None]
    return LightSample(
        direction=torch.where(sel, dir_direction, dir_p),
        distance=torch.where(is_dir, DIRECTIONAL_LIGHT_DISTANCE, dist_p),
        color=torch.where(sel, dir_color.expand(position.shape), lcolor),
        attenuation=torch.where(is_dir, 1.0, atten_p),
        pdf=pdf.expand(u1.shape),
        is_directional=is_dir,
    )
