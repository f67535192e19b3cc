"""Debug renderer: single-trace visualization modes and flags.

Port of `pt.render.debug` (≙ the reference's debug RT pipeline,
Shaders/Debug/*: 8 render modes — color by simple direct lighting with
shadows, world position, normals, texcoords, a mip heatmap through
computeLod, geometry/primitive/instance id colors —
DebugShaderTypes.incl:13-43, debugClosestHit.rchit:239-263 — and the UI
Debug tab's pipeline flags: force-opaque and cull-backfaces on the ray,
disable-color and disable-shadows at the hit, UserInterface.cpp:1700-1764).
Each mode is a cheap shade function over one closest-hit trace.

As in `pt`, `render_debug_image` builds its own accel with
`prepare_accel(ds, settings)` and defaults to the brute backend; with
`backend="pallas"` it walks the Morton tree, so a frame launches K3
(`closest_v4`) once, or ALPHA_ROUNDS times in the single-tree alpha loop,
and COLOR mode with shadows launches K4 (`occluded_v4`) once.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from pt_torch.render import rng as prng
from pt_torch.render.differentials import (DiffRays, compute_dp_dxy,
                                           compute_dpn_duv,
                                           compute_uv_derivatives)
from pt_torch.render.integrator import (Accel, PathTracingSettings,
                                        prepare_accel, scene_device,
                                        trace_closest, trace_closest_alpha,
                                        trace_occluded)
from pt_torch.render.materials import sample_material
from pt_torch.render.rays import TMAX, construct_primary_rays
from pt_torch.render.sampling import sample_light
from pt_torch.render.shading import _normalize, cross
from pt_torch.render.textures import DeviceTextures
from pt_torch.scene.flatten import T_COLOR, DeviceScene


class DebugRenderMode(enum.IntEnum):
    """≙ DebugRenderMode (DebugShaderTypes.incl:13-22)."""
    COLOR = 0
    WORLD_POSITION = 1
    NORMAL = 2
    TEX_COORDS = 3
    MIPS = 4
    GEOMETRY = 5
    PRIMITIVE = 6
    INSTANCE = 7


@dataclasses.dataclass(frozen=True)
class DebugFlags:
    """≙ the Debug tab's raygen/hit flag checkboxes
    (DebugShaderTypes.incl:24-43)."""
    force_opaque: bool = False        # skip the any-hit alpha handling
    cull_backfaces: bool = False      # drop hits seen from behind
    disable_color_texture: bool = False
    disable_shadows: bool = False


def _id_color(ids):
    """A stable pseudo-random color per integer id (≙ the id-hash coloring
    in debugClosestHit.rchit), bit-equal to `pt`'s: the uint32 hashes ride
    in int64 and wrap where `pt`'s do."""
    h = prng.jenkins_hash(ids)
    r = prng.uint_to_float(h)
    g = prng.uint_to_float(prng.jenkins_hash(h))
    b = prng.uint_to_float(prng.jenkins_hash(h + 1))
    return torch.stack([r, g, b], dim=-1)


def debug_shade(ds: DeviceScene, tex: DeviceTextures, accel: Accel, hit,
                origin, direction, mode: DebugRenderMode,
                flags: DebugFlags = DebugFlags(), diff: DiffRays = None):
    """Mode-dependent hit coloring; the background is dark gray."""
    tri = torch.clamp(hit.tri, min=0).long()
    bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)
    rp = accel.tri_pos[tri]
    rn = accel.tri_nrm[tri]
    ru = accel.tri_uv[tri]

    def lerp3(r, k):
        return (r[:, 0 * k:1 * k] * bary[:, 0:1]
                + r[:, 1 * k:2 * k] * bary[:, 1:2]
                + r[:, 2 * k:3 * k] * bary[:, 2:3])

    position = lerp3(rp, 3)
    normal = _normalize(lerp3(rn, 3))
    uv = lerp3(ru, 2)
    p0, p1, p2 = rp[:, 0:3], rp[:, 3:6], rp[:, 6:9]
    gn = _normalize(cross(p1 - p0, p2 - p0))

    visible = hit.is_hit
    if flags.cull_backfaces:
        # ≙ gl_RayFlagsCullBackFacingTrianglesEXT: backface hits vanish
        visible = visible & (torch.sum(gn * direction, dim=-1) <= 0.0)

    def uv_derivs():
        uv0, uv1, uv2 = ru[:, 0:2], ru[:, 2:4], ru[:, 4:6]
        n0, n1, n2 = rn[:, 0:3], rn[:, 3:6], rn[:, 6:9]
        dpdu, dpdv, _, _ = compute_dpn_duv(
            p0, p1, p2, uv0, uv1, uv2, n0, n1, n2,
            accel.tri_tan[tri][:, 0:3], accel.tri_bit[tri][:, 0:3])
        dpdx, dpdy = compute_dp_dxy(position, diff, normal)
        return compute_uv_derivatives(dpdx, dpdy, dpdu, dpdv)

    if mode == DebugRenderMode.COLOR:
        is_inside = torch.sum(normal * direction, dim=-1) > 0.0
        duv_x = duv_y = None
        if diff is not None:
            duv_x, duv_y = uv_derivs()
        mat = sample_material(ds, tex, ds.tri_mat[tri], uv, is_inside,
                              duv_x, duv_y)
        base = (torch.ones_like(mat.color) if flags.disable_color_texture
                else mat.color)
        n = torch.where(is_inside[:, None], -normal, normal)
        # one direct light and a shadow ray (≙ the debug pipeline's simple
        # direct lighting, debugClosestHit.rchit; shadows gated by flag)
        half = torch.full((tri.shape[0],), 0.5, dtype=torch.float32,
                          device=tri.device)
        light = sample_light(half, half, half, position,
                             ds.point_light_color, ds.point_light_pos,
                             ds.point_light_atten, ds.point_light_count,
                             ds.dir_light_color, ds.dir_light_dir)
        ldir = -_normalize(light.direction)
        ndl = torch.clamp(torch.sum(n * ldir, dim=-1), min=0.0)
        if flags.disable_shadows:
            lit = torch.ones_like(ndl)
        else:
            occ = trace_occluded(accel.bvh, position + n * 1e-3, ldir,
                                 light.distance)
            lit = torch.where(occ, 0.0, 1.0)
        direct = (light.color * light.attenuation[:, None]
                  * (ndl * lit)[:, None])
        headlight = torch.abs(torch.sum(n * -_normalize(direction), dim=-1))
        color = (base * (0.1 + 0.25 * headlight[:, None] + 0.65 * direct)
                 + mat.emissive)
    elif mode == DebugRenderMode.WORLD_POSITION:
        color = torch.abs(position) * 0.1
    elif mode == DebugRenderMode.NORMAL:
        color = normal * 0.5 + 0.5
    elif mode == DebugRenderMode.TEX_COORDS:
        color = torch.cat([torch.remainder(uv, 1.0),
                           torch.zeros_like(uv[:, :1])], dim=-1)
    elif mode == DebugRenderMode.MIPS:
        if diff is not None and not tex.all_constant:
            # the LOD heatmap (≙ computeLod in the debug hit shader): the
            # level the color texture would be sampled at
            duv_x, duv_y = uv_derivs()
            tex_idx = ds.mat_tex[ds.tri_mat[tri].long(), T_COLOR].long()
            size0 = tex.sizes[tex_idx, 0].to(torch.float32)
            px = duv_x * size0
            py = duv_y * size0
            rho = torch.sqrt(torch.maximum(torch.sum(px * px, -1),
                                           torch.sum(py * py, -1)))
            level = torch.log2(torch.clamp(rho, min=1e-12))
            level = torch.clamp(level, 0.0, 12.0) / 12.0
        else:
            # constant pools have no meaningful LOD: a distance stand-in
            level = torch.clamp(torch.log2(torch.clamp(hit.t, min=1e-3)),
                                0.0, 12.0) / 12.0
        color = torch.stack([level, 1.0 - level, torch.zeros_like(level)],
                            dim=-1)
    elif mode == DebugRenderMode.GEOMETRY:
        color = _id_color(ds.vert_seg[ds.tri_idx[tri, 0].long()])
    elif mode == DebugRenderMode.PRIMITIVE:
        color = _id_color(tri)
    elif mode == DebugRenderMode.INSTANCE:
        seg = ds.vert_seg[ds.tri_idx[tri, 0].long()].long()
        color = _id_color(ds.seg_instance[seg])
    else:
        color = torch.zeros((tri.shape[0], 3), dtype=torch.float32,
                            device=tri.device)

    background = torch.tensor([0.1, 0.1, 0.12], dtype=torch.float32,
                              device=tri.device)
    return torch.where(visible[:, None], color[:, :3], background)


def render_debug_image(ds: DeviceScene, tex: DeviceTextures, inv_view,
                       inv_proj, width: int, height: int,
                       mode: DebugRenderMode,
                       settings: PathTracingSettings = PathTracingSettings(
                           backend="brute"),
                       flags: DebugFlags = DebugFlags(), device=None):
    """One debug frame (H, W, 3): one primary trace through each pixel's
    centre. `settings.backend` picks the accel (`pt`'s default: brute).

    `device`: None means the card (`default_device`); the scene and the
    texture pool must already be on it, or this raises."""
    device = scene_device(ds, tex, device)
    accel = prepare_accel(ds, settings)
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    n = px.shape[0]
    # centred rays (≙ the centred constructPrimaryRay overload,
    # ray.glsl:91-99): a fixed 0.5 jitter; the offset rays feed the LOD
    half = torch.full((n,), 0.5, dtype=torch.float32, device=device)
    mat = lambda m: torch.as_tensor(m, dtype=torch.float32,  # noqa: E731
                                    device=device)
    ray, rx, ry = construct_primary_rays(px, py, width, height,
                                         mat(inv_view), mat(inv_proj),
                                         half, half)
    diff = DiffRays(rx.origin, rx.direction, ry.origin, ry.direction)
    if ds.has_alpha and not flags.force_opaque:
        alive = torch.ones((n,), dtype=torch.bool, device=device)
        hit, _, _, _ = trace_closest_alpha(ds, tex, accel, ray.origin,
                                           ray.direction, alive)
    else:
        hit = trace_closest(accel.bvh, ray.origin, ray.direction,
                            torch.full((n,), TMAX, dtype=torch.float32,
                                       device=device))
    color = debug_shade(ds, tex, accel, hit, ray.origin, ray.direction,
                        mode, flags, diff)
    return color.reshape(height, width, 3)
