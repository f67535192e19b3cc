"""Plain reference: a frozen copy of pt_torch/render/rays.py,
which the port may change without moving the yardstick.

Primary-ray construction (pinhole + thin-lens DoF) and ray-origin offsets.

Port of `pt.render.rays` (Shaders/ray.glsl of the reference): jittered
primary rays with +1-pixel differential rays, the integer-ulp
self-intersection offset (Ray Tracing Gems ch. 6) and the shadow-terminator
offset (Ray Tracing Gems II ch. 4). Rays are built from inverse-projection
then inverse-view (left-handed, zero-to-one depth).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from portbench.reference.sampling import sample_uniform_disk_concentric
from portbench.reference.shading import _normalize, matvec

TMIN = 1e-5
TMAX = 1e4

_ORIGIN_CONST = 1.0 / 32.0
_FLOAT_SCALE = 1.0 / 65536.0
_INT_SCALE = 256.0


class Rays(NamedTuple):
    origin: torch.Tensor      # (..., 3)
    direction: torch.Tensor   # (..., 3)


def _unproject(d, inv_proj):
    """Pixel NDC (..., 2) → view-space target through inverse proj."""
    ndc = torch.cat([d, torch.ones_like(d)], dim=-1)          # (x, y, 1, 1)
    return matvec(inv_proj, ndc)[..., :3]


def _to_world_dir(v, inv_view):
    v4 = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    return matvec(inv_view, v4)[..., :3]


def construct_primary_rays(px, py, width, height, inv_view, inv_proj,
                           u1, u2, lens_u1=None, lens_u2=None,
                           lens_radius=0.0, focal_distance=1.0
                           ) -> Tuple[Rays, Rays, Rays]:
    """Build jittered primary rays + x/y differential rays.

    px, py: integer pixel coordinates (N,). u1,u2: per-ray jitter in [0,1).
    inv_view/inv_proj: (4, 4) f32 tensors on the rays' device. With
    lens_radius > 0 the thin-lens model applies (≙ ray.glsl:16-58);
    otherwise pinhole (ray.glsl:60-88). Returns (ray, rx, ry).
    """
    cx = px.to(torch.float32) + u1
    cy = py.to(torch.float32) + u2

    def ndc(x, y):
        return torch.stack([x / float(width), y / float(height)],
                           dim=-1) * 2.0 - 1.0

    d = ndc(cx, cy)
    dx = ndc(cx + 1.0, cy)
    dy = ndc(cx, cy + 1.0)

    t0 = _unproject(d, inv_proj)
    tx = _unproject(dx, inv_proj)
    ty = _unproject(dy, inv_proj)

    cam_origin = inv_view[:3, 3]

    if lens_u1 is None:
        origin = cam_origin.expand(t0.shape)
        main = Rays(origin, _to_world_dir(_normalize(t0), inv_view))
        rx = Rays(origin, _to_world_dir(_normalize(tx), inv_view))
        ry = Rays(origin, _to_world_dir(_normalize(ty), inv_view))
        return main, rx, ry

    # thin lens: origin on the lens disk, directions through the focal plane
    lx, ly = sample_uniform_disk_concentric(lens_u1, lens_u2)
    p_lens = torch.stack([lx, ly, torch.zeros_like(lx)], dim=-1) * lens_radius
    o4 = torch.cat([p_lens, torch.ones_like(p_lens[..., :1])], dim=-1)
    origin = matvec(inv_view, o4)[..., :3]

    def lens_dir(target):
        ft = focal_distance / target[..., 2:3]
        p_focus = ft * target
        return _to_world_dir(_normalize(p_focus - p_lens), inv_view)

    return (Rays(origin, lens_dir(t0)),
            Rays(origin, lens_dir(tx)),
            Rays(origin, lens_dir(ty)))


def offset_ray_origin_self_intersection(origin, normal):
    """Integer-ulp origin offset along the normal
    (≙ offsetRayOriginSelfIntersection, ray.glsl:101-115)."""
    of_i = (_INT_SCALE * normal).to(torch.int32)
    o_bits = origin.contiguous().view(torch.int32)
    shifted = torch.where(origin < 0.0, o_bits - of_i, o_bits + of_i)
    p_i = shifted.contiguous().view(torch.float32)
    near_origin = torch.abs(origin) < _ORIGIN_CONST
    return torch.where(near_origin, origin + _FLOAT_SCALE * normal, p_i)


def offset_ray_origin_shadow_terminator(position, bary, p0, p1, p2,
                                        n0, n1, n2, is_refracted):
    """Hit-point offset onto the interpolated-normal bound planes
    (≙ offsetRayOriginShadowTerminator, ray.glsl:117-131). `bary` is
    (..., 3); per-vertex positions/normals are (..., 3)."""
    sign = torch.where(is_refracted[..., None], -1.0, 1.0)
    n0, n1, n2 = n0 * sign, n1 * sign, n2 * sign
    tmpu = position - p0
    tmpv = position - p1
    tmpw = position - p2
    tmpu = tmpu - torch.clamp(torch.sum(tmpu * n0, -1), max=0.0)[..., None] * n0
    tmpv = tmpv - torch.clamp(torch.sum(tmpv * n1, -1), max=0.0)[..., None] * n1
    tmpw = tmpw - torch.clamp(torch.sum(tmpw * n2, -1), max=0.0)[..., None] * n2
    return (position + bary[..., 0:1] * tmpu + bary[..., 1:2] * tmpv
            + bary[..., 2:3] * tmpw)
