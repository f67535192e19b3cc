"""Plain reference: a frozen copy of pt_torch/render/differentials.py,
which the port may change without moving the yardstick.

Ray differentials for texture filtering (textureGrad-equivalent LOD).

Port of `pt.render.differentials` (Shaders/tracing.glsl of the reference,
PBRT 4ed): geometric dP/du,dP/dv,dN/du,dN/dv from the triangle, offset-ray
plane intersections for dP/dx,dP/dy, the least-squares du/dx..dv/dy solve,
and the specular reflected/refracted differential propagation.

The differential ray state is four (N, 3) tensors (rx/ry origin +
direction) carried alongside the main ray.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.shading import _normalize


class DiffRays(NamedTuple):
    rx_origin: torch.Tensor     # (N, 3)
    rx_dir: torch.Tensor
    ry_origin: torch.Tensor
    ry_dir: torch.Tensor


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def compute_dpn_duv(p0, p1, p2, uv0, uv1, uv2, n0, n1, n2,
                    fallback_tan, fallback_bit):
    """(dpdu, dpdv, dndu, dndv) per hit (≙ computeDpnDuv)."""
    e1 = p1 - p0
    e2 = p2 - p0
    en1 = n1 - n0
    en2 = n2 - n0
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    degenerate = torch.abs(det) < 1e-8
    inv = 1.0 / torch.where(degenerate, 1.0, det)
    dpdu = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv[:, None]
    dpdv = (-duv2[:, 0:1] * e1 + duv1[:, 0:1] * e2) * inv[:, None]
    dndu = (duv2[:, 1:2] * en1 - duv1[:, 1:2] * en2) * inv[:, None]
    dndv = (-duv2[:, 0:1] * en1 + duv1[:, 0:1] * en2) * inv[:, None]
    sel = degenerate[:, None]
    return (torch.where(sel, fallback_tan, dpdu),
            torch.where(sel, fallback_bit, dpdv),
            torch.where(sel, 0.0, dndu),
            torch.where(sel, 0.0, dndv))


def _plane_hit(n, p, o, d):
    """Intersection of offset ray (o, d) with the tangent plane at p."""
    dist = -_dot(n, p)
    denom = _dot(n, d)
    denom = torch.where(torch.abs(denom) < 1e-12,
                   torch.where(denom < 0, -1e-12, 1e-12), denom)
    t = (-_dot(n, o) - dist) / denom
    return o + t[:, None] * d


def compute_dp_dxy(p, rays: DiffRays, n):
    """(dpdx, dpdy) via offset-ray plane hits (≙ computeDpDxy)."""
    px = _plane_hit(n, p, rays.rx_origin, rays.rx_dir)
    py = _plane_hit(n, p, rays.ry_origin, rays.ry_dir)
    return px - p, py - p


def _clamp_finite(v):
    return torch.clamp(torch.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0),
                       -1e8, 1e8)


def compute_uv_derivatives(dpdx, dpdy, dpdu, dpdv):
    """Least-squares (dudx, dvdx, dudy, dvdy) (≙ computeDerivatives);
    returns ((N,2) dudx_dvdx, (N,2) dudy_dvdy)."""
    ata00 = _dot(dpdu, dpdu)
    ata01 = _dot(dpdu, dpdv)
    ata11 = _dot(dpdv, dpdv)
    det = ata00 * ata11 - ata01 * ata01
    inv = torch.where(torch.abs(det) < 1e-20, 0.0,
                 1.0 / torch.where(det == 0.0, 1.0, det))
    atb0x = _dot(dpdu, dpdx)
    atb1x = _dot(dpdv, dpdx)
    atb0y = _dot(dpdu, dpdy)
    atb1y = _dot(dpdv, dpdy)
    dudx = _clamp_finite((ata11 * atb0x - ata01 * atb1x) * inv)
    dvdx = _clamp_finite((ata00 * atb1x - ata01 * atb0x) * inv)
    dudy = _clamp_finite((ata11 * atb0y - ata01 * atb1y) * inv)
    dvdy = _clamp_finite((ata00 * atb1y - ata01 * atb0y) * inv)
    return (torch.stack([dudx, dvdx], dim=-1),
            torch.stack([dudy, dvdy], dim=-1))


def reflect_differentials(rays: DiffRays, duv_x, duv_y, n, p, view_dir,
                          reflected_dir, dndu, dndv) -> DiffRays:
    """Specular-reflection propagation (≙ computeReflectedDifferentialRays)."""
    dndx = dndu * duv_x[:, 0:1] + dndv * duv_x[:, 1:2]
    dndy = dndu * duv_y[:, 0:1] + dndv * duv_y[:, 1:2]
    px = _plane_hit(n, p, rays.rx_origin, rays.rx_dir)
    py = _plane_hit(n, p, rays.ry_origin, rays.ry_dir)
    dwodx = -rays.rx_dir - view_dir
    dwody = -rays.ry_dir - view_dir
    vdn = _dot(view_dir, n)[:, None]
    ddx = (_dot(dwodx, n) + _dot(view_dir, dndx))[:, None]
    ddy = (_dot(dwody, n) + _dot(view_dir, dndy))[:, None]
    rx_dir = _normalize(reflected_dir - dwodx + 2.0 * (vdn * dndx + ddx * n))
    ry_dir = _normalize(reflected_dir - dwody + 2.0 * (vdn * dndy + ddy * n))
    return DiffRays(px, rx_dir, py, ry_dir)


def refract_differentials(rays: DiffRays, duv_x, duv_y, n, p, view_dir,
                          refracted_dir, dndu, dndv, eta) -> DiffRays:
    """Specular-transmission propagation (≙ computeRefractedDifferentialRays)."""
    dndx = dndu * duv_x[:, 0:1] + dndv * duv_x[:, 1:2]
    dndy = dndu * duv_y[:, 0:1] + dndv * duv_y[:, 1:2]
    px = _plane_hit(n, p, rays.rx_origin, rays.rx_dir)
    py = _plane_hit(n, p, rays.ry_origin, rays.ry_dir)
    dwodx = -rays.rx_dir - view_dir
    dwody = -rays.ry_dir - view_dir

    flip = (_dot(view_dir, n) < 0.0)[:, None]
    n = torch.where(flip, -n, n)
    dndx = torch.where(flip, -dndx, dndx)
    dndy = torch.where(flip, -dndy, dndy)

    ddx = (_dot(dwodx, n) + _dot(view_dir, dndx))[:, None]
    ddy = (_dot(dwody, n) + _dot(view_dir, dndy))[:, None]
    vdn = _dot(view_dir, n)
    rdn = _dot(refracted_dir, n)
    rdn_safe = torch.where(torch.abs(rdn) < 1e-12, 1e-12, rdn)
    eta_c = eta[:, None] if eta.ndim == 1 else eta
    # mu/dmu use 1/eta where the -eta*dwodx term uses eta: the reference's
    # mix of PBRT's reciprocal-eta formulas and a direct-eta term
    # (tracing.glsl:142-147), kept for parity
    mu = (vdn / eta - torch.abs(rdn))[:, None]
    dmu_scale = (1.0 / eta + (1.0 / (eta * eta)) * vdn / rdn_safe)[:, None]
    rx_dir = _normalize(refracted_dir - eta_c * dwodx
                        + mu * dndx + (ddx * dmu_scale) * n)
    ry_dir = _normalize(refracted_dir - eta_c * dwody
                        + mu * dndy + (ddy * dmu_scale) * n)
    return DiffRays(px, rx_dir, py, ry_dir)


