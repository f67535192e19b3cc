"""Plain reference: a frozen copy of pt_torch/render/bsdf.py,
which the port may change without moving the yardstick.

Four-lobe BSDF: diffuse, glossy GGX, metallic GGX, GGX refraction.

Port of `pt.render.bsdf` (Shaders/bsdf.glsl of the reference): lobe
probabilities from metalness / dielectric Fresnel / transmission, combined
evaluation with pdf mixing, and hierarchical lobe-pick sampling.

All directions are in the local shading frame (z = shading normal), V points
away from the surface. Sampling consumes the per-lane RNG stream with the
same draw counts per branch as the reference's divergent GLSL (state
advances are masked per lane), so sequences match lane-for-lane.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from portbench.reference import rng as prng
from portbench.reference.sampling import sample_cosine_hemisphere
from portbench.reference.shading import (PI, _normalize, dielectric_fresnel,
                                     evaluate_reflection, evaluate_refraction,
                                     reflect, refract, sample_ggx,
                                     schlick_fresnel)


@dataclasses.dataclass
class MaterialSample:
    """Per-hit resolved material (≙ MaterialSample in material.glsl).
    All fields broadcast over the ray batch."""
    color: torch.Tensor            # (..., 3)
    emissive: torch.Tensor         # (..., 3)
    normal: torch.Tensor           # (..., 3) tangent-space normal-map vector
    roughness: torch.Tensor        # (...,)
    metalness: torch.Tensor        # (...,)
    transmission: torch.Tensor     # (...,)
    eta: torch.Tensor              # (...,) relative IOR for this hit side
    attenuation_color: torch.Tensor     # (..., 3)
    attenuation_distance: torch.Tensor  # (...,)


class LobePdfs(NamedTuple):
    diffuse: torch.Tensor
    glossy: torch.Tensor
    metallic: torch.Tensor
    transmissive: torch.Tensor


def sample_lobe_pdfs(metalness, transmission, fresnel) -> LobePdfs:
    """≙ sampleLobePdfs (bsdf.glsl:62-70); the four sum to exactly 1."""
    return LobePdfs(
        diffuse=(1.0 - metalness) * (1.0 - fresnel) * (1.0 - transmission),
        glossy=(1.0 - metalness) * fresnel,
        metallic=metalness,
        transmissive=(1.0 - metalness) * (1.0 - fresnel) * transmission,
    )


def evaluate_bsdf(mat: MaterialSample, v, l) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combined BSDF value and pdf (≙ evaluateBSDF, bsdf.glsl:72-103).
    Returns (bsdf (...,3), pdf (...,))."""
    alpha = mat.roughness * mat.roughness
    is_reflection = l[..., 2] > 0.0

    h_refl = _normalize(v + l)
    h_refr = _normalize(mat.eta[..., None] * v + l)
    h = torch.where(is_reflection[..., None], h_refl, h_refr)
    fd = dielectric_fresnel(torch.abs(torch.sum(v * h, dim=-1)), mat.eta)
    lobes = sample_lobe_pdfs(mat.metalness, mat.transmission, fd)

    # diffuse lobe (≙ evaluateDiffuseBRDF)
    diff_pdf = l[..., 2] / PI
    diff_val = (l[..., 2] / PI)[..., None] * mat.color

    # glossy lobe: white Fresnel (≙ evaluateGlossyBSDF)
    ones = torch.ones_like(mat.color)
    glos_val, glos_pdf = evaluate_reflection(v, l, ones, alpha)

    # metallic lobe: Schlick F0 from base color (≙ evaluateMetallicBRDF)
    vdh = torch.sum(v * h_refl, dim=-1)
    f0 = mat.color + (1.0 - mat.color) * schlick_fresnel(vdh)[..., None]
    met_val, met_pdf = evaluate_reflection(v, l, f0, alpha)

    # transmissive lobe (≙ evaluateBTDF)
    btdf_val, btdf_pdf = evaluate_refraction(v, l, mat.color, alpha, mat.eta)

    refl_bsdf = (diff_val * lobes.diffuse[..., None]
                 + glos_val * lobes.glossy[..., None]
                 + met_val * lobes.metallic[..., None])
    refl_pdf = (diff_pdf * lobes.diffuse + glos_pdf * lobes.glossy
                + met_pdf * lobes.metallic)
    refr_bsdf = btdf_val * lobes.transmissive[..., None]
    refr_pdf = btdf_pdf * lobes.transmissive

    bsdf = torch.where(is_reflection[..., None], refl_bsdf, refr_bsdf)
    pdf = torch.where(is_reflection, refl_pdf, refr_pdf)
    return bsdf, pdf


class BSDFSample(NamedTuple):
    """≙ BSDFSample (bsdf.glsl:4-9)."""
    direction: torch.Tensor   # (..., 3) sampled L, local frame
    pdf: torch.Tensor         # (...,)
    color: torch.Tensor       # (..., 3) BSDF value at L


def sample_bsdf(mat: MaterialSample, v, state) -> Tuple[torch.Tensor, BSDFSample]:
    """Hierarchical lobe sampling (≙ sampleBSDF, bsdf.glsl:105-132).

    Per-lane RNG consumption mirrors the reference's branch-dependent draws:
    u1,u2 (VNDF) and r_metal always; r_fresnel unless metallic; r_trans in
    the non-glossy dielectric path; u3,u4 only for the diffuse pick.
    """
    alpha = mat.roughness * mat.roughness
    state, u1, u2 = prng.rand2(state)
    h = sample_ggx(u1, u2, v, alpha)
    fd = dielectric_fresnel(torch.abs(torch.sum(v * h, dim=-1)), mat.eta)

    state, r_metal = prng.rand(state)
    pick_metal = r_metal < mat.metalness

    # r_fresnel is drawn only on lanes that did not pick metal
    state, r_fresnel = _masked_rand(state, ~pick_metal)
    pick_glossy = (~pick_metal) & (r_fresnel < fd)

    # r_trans drawn only on non-metal, non-glossy lanes
    need_trans = (~pick_metal) & (~pick_glossy)
    state, r_trans = _masked_rand(state, need_trans)
    pick_trans = need_trans & (r_trans < mat.transmission)
    pick_diffuse = need_trans & (~pick_trans)

    # u3,u4 drawn only on diffuse lanes
    state, u3 = _masked_rand(state, pick_diffuse)
    state, u4 = _masked_rand(state, pick_diffuse)

    l_spec = _normalize(reflect(-v, h))                     # glossy & metallic
    l_refr = _normalize(refract(-v, h, mat.eta))            # transmissive
    l_diff = sample_cosine_hemisphere(u3, u4)

    l = torch.where(pick_trans[..., None], l_refr,
                    torch.where(pick_diffuse[..., None], l_diff, l_spec))

    bsdf, pdf = evaluate_bsdf(mat, v, l)
    return state, BSDFSample(direction=l, pdf=pdf, color=bsdf)


def _masked_rand(state, mask):
    """Advance the per-lane xorshift state only where mask is set; lanes with
    mask unset keep their state and the drawn value is unused there."""
    new_state = prng.xorshift(state)
    value = prng.uint_to_float(new_state)
    return torch.where(mask, new_state, state), value
