"""Plain reference: a frozen copy of pt_torch/render/shading.py,
which the port may change without moving the yardstick.

Microfacet shading math: GGX NDF, Smith masking, Fresnel, VNDF sampling.

Port of `pt.render.shading` (Shaders/shading.glsl of the reference). The
same clamped GGX denominator and the same where-guarded divisions: both
sides of every select are computed, so masked-off lanes must not produce
NaN/Inf.

All directions live in the local shading frame (z = normal). Shapes are
(..., 3) for vectors, (...,) for scalars; everything broadcasts.
"""

from __future__ import annotations

from typing import Tuple

import torch

PI = 3.14159265359
_EPS = 1e-20


def _axis(i: int, like: torch.Tensor) -> torch.Tensor:
    """Unit vector i of R^3 on `like`'s device, made there (a constant
    copied from the host would wait for the stream)."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[i]


def _safe_div(a, b):
    """a / b with |b| floored away from zero, preserving sign."""
    return a / torch.where(torch.abs(b) < _EPS, torch.where(b < 0, -_EPS, _EPS), b)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _normalize(v):
    return v * torch.clamp(_norm(v), min=_EPS) ** -1


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    """3-vector cross product over the last axis (broadcasting)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def matvec(m, v):
    """Batched (..., 3, 3) @ (..., 3) as an elementwise product and sum."""
    return torch.sum(m * v[..., None, :], dim=-1)


def ggx_distribution(h, alpha):
    """GGX NDF with the reference's clamped denominator
    (≙ GGXDistribution, shading.glsl:3-15)."""
    hx2, hy2, hz2 = h[..., 0] ** 2, h[..., 1] ** 2, h[..., 2] ** 2
    a2 = alpha * alpha
    inner = _safe_div(hx2, a2) + _safe_div(hy2, a2) + hz2
    denom = PI * a2 * inner * inner
    return 1.0 / torch.clamp(denom, min=1.0)


def smith_lambda(v, alpha):
    """Smith Λ (≙ Lambda, shading.glsl:17-29)."""
    vx2, vy2 = v[..., 0] ** 2, v[..., 1] ** 2
    vz2 = v[..., 2] ** 2
    a2 = alpha * alpha
    nom = torch.sqrt(1.0 + _safe_div(a2 * vx2 + a2 * vy2, vz2)) - 1.0
    return nom / 2.0


def ggx_smith(v, alpha):
    """Smith G1 (≙ GGXSmith, shading.glsl:31-34)."""
    return 1.0 / (1.0 + smith_lambda(v, alpha))


def dielectric_fresnel(v_dot_h, eta):
    """Exact dielectric Fresnel; returns 1 past TIR
    (≙ DielectricFresnel, shading.glsl:36-52)."""
    cos_i = v_dot_h
    sin_t2 = eta * eta * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    rs = _safe_div(eta * cos_t - cos_i, eta * cos_t + cos_i)
    rp = _safe_div(eta * cos_i - cos_t, eta * cos_i + cos_t)
    f = (rs * rs + rp * rp) / 2.0
    return torch.where(sin_t2 > 1.0, 1.0, f)


def schlick_fresnel(v_dot_h):
    """≙ SchlickFresnel (shading.glsl:54-57)."""
    return torch.clamp(1.0 - v_dot_h, 0.0, 1.0) ** 5


def evaluate_reflection(v, l, f, alpha) -> Tuple[torch.Tensor, torch.Tensor]:
    """GGX reflection lobe value and VNDF pdf
    (≙ EvaluateReflection, shading.glsl:59-83). f is (..., 3) Fresnel term.
    Returns (bsdf (...,3), pdf (...,)); zero where L is below the surface."""
    valid = l[..., 2] >= 1e-5
    h = _normalize(v + l)
    v_dot_h = _dot(v, h)
    d = ggx_distribution(h, alpha)
    gv = ggx_smith(v, alpha)
    gl = ggx_smith(l, alpha)
    dv = _safe_div(gv * torch.clamp(v_dot_h, min=0.0) * d, v[..., 2])
    pdf = _safe_div(dv, 4.0 * v_dot_h)
    bsdf = _safe_div(d * gv * gl, 4.0 * v[..., 2])[..., None] * f
    return (torch.where(valid[..., None], bsdf, 0.0),
            torch.where(valid, pdf, 0.0))


def evaluate_refraction(v, l, f, alpha, eta) -> Tuple[torch.Tensor, torch.Tensor]:
    """GGX refraction (BTDF) value and pdf
    (≙ EvaluateRefraction, shading.glsl:85-113). Zero unless L is below."""
    valid = l[..., 2] <= -1e-5
    h = _normalize(eta[..., None] * v + l)
    h = torch.where(h[..., 2:3] < 0.0, -h, h)
    v_dot_h = _dot(v, h)
    l_dot_h = _dot(l, h)
    d = ggx_distribution(h, alpha)
    gv = ggx_smith(v, alpha)
    gl = ggx_smith(l, alpha)
    dv = _safe_div(gv * torch.abs(v_dot_h) * d, v[..., 2])
    denom = l_dot_h + eta * v_dot_h
    jacobian = _safe_div(eta * eta * torch.abs(l_dot_h), denom * denom)
    pdf = dv * jacobian
    bsdf = (_safe_div(torch.abs(v_dot_h), torch.abs(v[..., 2]))
            * d * gv * gl * jacobian)[..., None] * f
    return (torch.where(valid[..., None], bsdf, 0.0),
            torch.where(valid, pdf, 0.0))


def sample_ggx(u1, u2, v, alpha):
    """Heitz 2018 visible-normal (VNDF) sampling of the GGX distribution
    (≙ SampleGGX, shading.glsl:115-133). u1,u2 ∈ [0,1); returns half-vector H."""
    vh = _normalize(torch.stack([alpha * v[..., 0], alpha * v[..., 1],
                                 torch.abs(v[..., 2])], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = torch.where(lensq > 0.0, torch.clamp(lensq, min=_EPS) ** -0.5, 0.0)
    t1 = torch.where((lensq > 0.0)[..., None],
                     torch.stack([-vh[..., 1], vh[..., 0],
                                  torch.zeros_like(lensq)], dim=-1)
                     * inv_len[..., None],
                     _axis(0, vh).expand(vh.shape))
    t2 = cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))[..., None]
          * vh)
    h = torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                     torch.clamp(nh[..., 2], min=0.0)], dim=-1)
    return _normalize(h)


def reflect(incident, n):
    """GLSL reflect(): I - 2*dot(N,I)*N."""
    return incident - 2.0 * _dot(n, incident)[..., None] * n


def refract(incident, n, eta):
    """GLSL refract(); returns 0 vector on total internal reflection."""
    n_dot_i = _dot(n, incident)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    t = (eta[..., None] * incident
         - (eta * n_dot_i + torch.sqrt(torch.clamp(k, min=0.0)))[..., None] * n)
    return torch.where((k < 0.0)[..., None], 0.0, t)
