"""The plain reference's integrator: a frozen copy of the port's wavefront
integrator (`pt_torch/render/integrator.py`) with every trace done by brute
force (`intersect.intersect_brute`, Moller-Trumbore in f32) and no tree.

What the copy keeps, per lane and in the same order: raygen, the alpha
re-trace loops (with the opaque/alpha split a static alpha scene gets),
shading with textures and ray differentials, next-event estimation (point
shadows traced reversed, as the port's default), Russian roulette and the
RNG draws. What it drops changes no lane's result: the coherence sort and
material-sorted shading (pure permutations, off by default), dead lanes
pointed out of the scene, and the shadow distance clamped to a root box
(no triangle lies outside it).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from portbench.reference import rng as prng
from portbench.reference.bsdf import evaluate_bsdf, sample_bsdf
from portbench.reference.differentials import (DiffRays, compute_dp_dxy,
                                               compute_dpn_duv,
                                               compute_uv_derivatives,
                                               reflect_differentials,
                                               refract_differentials)
from portbench.reference.flatten import (DeviceScene, F_COLOR, T_COLOR,
                                         world_vertices)
from portbench.reference.intersect import Hit, intersect_brute
from portbench.reference.materials import sample_material
from portbench.reference.rays import (TMAX, TMIN, construct_primary_rays,
                                      offset_ray_origin_self_intersection,
                                      offset_ray_origin_shadow_terminator)
from portbench.reference.sampling import compute_tangent_space, sample_light
from portbench.reference.shading import _axis, _normalize, cross, matvec
from portbench.reference.texpool import DeviceTextures, sample_texture_grad
from portbench.reference.types import SkyboxKind

ALPHA_ROUNDS = 4   # max transparent surfaces skipped per ray segment


@dataclasses.dataclass(frozen=True)
class PathTracingSettings:
    """The integrator settings a lane's result depends on, with the port's
    defaults (`pt_torch.render.integrator.PathTracingSettings`)."""
    bounce_count: int = 5
    lens_radius: float = 0.0
    focal_distance: float = 1.0
    reverse_point_shadows: bool = True
    rr_scale: float = 1.0
    rr_start_bounce: int = 0
    tex_nearest_tail: bool = True


class BruteTriangles:
    """The brute backend's structure, `pt`'s `bvh=None`: every ray against
    every listed triangle (`intersect_brute`, Möller–Trumbore in f32). It
    carries the world positions and the triangle rows (the whole scene's, or
    an alpha split's subset), and reaches `trace_closest`/`trace_occluded`
    through their duck dispatch. As in `pt`, no lane is pointed out of the
    scene (`_degenerate_masked`) and no shadow distance is clamped to a root
    box: there is none."""

    has_root_box = False

    def __init__(self, wpos: torch.Tensor, tri_idx: torch.Tensor):
        self.wpos = wpos
        self.tri_idx = tri_idx

    def closest(self, origins, dirs, tmax, tmin) -> Hit:
        return intersect_brute(self.wpos, self.tri_idx, origins, dirs, tmin,
                               tmax)

    def occluded(self, origins, dirs, dist, tmin) -> torch.Tensor:
        return self.closest(origins, dirs, dist, tmin).is_hit


class AlphaSplit(NamedTuple):
    """Opaque/alpha scene partition for any-hit emulation (≙ the RT
    hardware's opaque-flag fast path). Alpha-tested triangles are usually a
    small part of a scene, so the re-trace rounds that emulate any-hit
    shaders walk a much smaller tree than the scene's, and shadow queries
    use the early-out occlusion kernel on the opaque tree."""
    bvh_opaque: object           # accel over the opaque subset (a tree, or
                                 # BruteTriangles on the brute backend)
    sel_opaque: torch.Tensor     # (K0,) i32 global triangle ids
    bvh_alpha: object            # accel over the non-opaque subset
    sel_alpha: torch.Tensor      # (K1,) i32


class Accel(NamedTuple):
    """World-space geometry + acceleration structure for one frame.
    Vertex attributes are pre-gathered into per-triangle rows (tri_*), one
    row gather per attribute class per hit."""
    wpos: torch.Tensor           # (V, 3) world positions
    tri_pos: torch.Tensor        # (T, 9) p0|p1|p2 world
    tri_nrm: torch.Tensor        # (T, 9) n0|n1|n2 world
    tri_tan: torch.Tensor        # (T, 9)
    tri_bit: torch.Tensor        # (T, 9)
    tri_uv: torch.Tensor         # (T, 6) uv0|uv1|uv2
    bvh: Optional[object]        # BF8BVH | PacketBVH | BF8Instanced | BF8V6 |
                                 # ThreadedTriangles | BruteTriangles
                                 # (None: not built yet)
    alpha_split: Optional[AlphaSplit] = None


class BounceCarry(NamedTuple):
    """Per-lane path state threaded across bounces (≙ Payload + raygen
    locals); the RNG state is int64 holding uint32 values."""
    state: torch.Tensor          # (N,) int64 RNG
    origin: torch.Tensor         # (N, 3)
    direction: torch.Tensor      # (N, 3)
    throughput: torch.Tensor     # (N, 3)
    radiance: torch.Tensor       # (N, 3)
    alive: torch.Tensor          # (N,) bool
    max_roughness: torch.Tensor  # (N,)
    rays: torch.Tensor           # () int64 useful-ray counter (on device)
    diff: DiffRays               # texture-LOD differential rays


def prepare_attribs(ds: DeviceScene) -> Accel:
    """World-space flatten + per-triangle attribute packing (no BVH yet)."""
    wpos, wnrm, wtan, wbit = world_vertices(ds)
    idx = ds.tri_idx.long()
    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]

    def pack3(a):
        return torch.cat([a[i0], a[i1], a[i2]], dim=1)
    return Accel(wpos=wpos, tri_pos=pack3(wpos), tri_nrm=pack3(wnrm),
                 tri_tan=pack3(wtan), tri_bit=pack3(wbit),
                 tri_uv=pack3(ds.tex_coords), bvh=None)


def make_alpha_split_brute(ds: DeviceScene,
                           wpos: torch.Tensor) -> Optional[AlphaSplit]:
    """`pt`'s AlphaSplit over the brute backend: the opaque and the
    non-opaque triangles, each traced by brute force, with the split loops'
    semantics. None when the scene is wholly opaque or wholly alpha.
    `wpos`: the world positions the subsets index (the accel's)."""
    opq = ds.tri_opaque
    if not (bool(opq.any()) and bool((~opq).any())):
        return None
    sel_o = torch.nonzero(opq).flatten().to(torch.int32)
    sel_a = torch.nonzero(~opq).flatten().to(torch.int32)
    return AlphaSplit(BruteTriangles(wpos, ds.tri_idx[sel_o.long()]), sel_o,
                      BruteTriangles(wpos, ds.tri_idx[sel_a.long()]), sel_a)


def _finite_or_zero(radiance):
    finite = torch.all(torch.isfinite(radiance), dim=-1, keepdim=True)
    return torch.where(finite, radiance, 0.0)


def _skybox_emissive(ds: DeviceScene, directions):
    """Miss 'shader' (≙ miss.rmiss:16-39); equirect applies the reference's
    hdrToLdr soft clamp."""
    if ds.skybox_kind == int(SkyboxKind.EQUIRECT):
        img = ds.skybox_image                      # (H, W, 3)
        longitude = torch.atan2(directions[:, 2], directions[:, 0])
        latitude = torch.asin(torch.clamp(-directions[:, 1], -1.0, 1.0))
        u = longitude / (2.0 * torch.pi) + 0.5
        v = latitude / torch.pi + 0.5
        rgb = _bilinear_wrap(img, u, v)
        return rgb / (1.0 + torch.max(rgb, dim=-1, keepdim=True).values)
    if ds.skybox_kind == int(SkyboxKind.CUBE):
        return _sample_cubemap(ds.skybox_image, directions)
    return ds.skybox_color.expand(directions.shape)


def _bilinear_wrap(img, u, v):
    """Bilinear sample of an (H, W, 3) image; u wraps, v clamps."""
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def fetch(xi, yi):
        xi = torch.remainder(xi.to(torch.int64), w)
        yi = torch.clamp(yi.to(torch.int64), 0, h - 1)
        return img[yi, xi]

    top = fetch(x0, y0) * (1 - fx) + fetch(x0 + 1, y0) * fx
    bot = fetch(x0, y0 + 1) * (1 - fx) + fetch(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def _sample_cubemap(faces, directions):
    """Cubemap lookup (faces (6, H, W, 3) in +X,-X,+Y,-Y,+Z,-Z order)."""
    d = directions
    ax, ay, az = torch.abs(d[:, 0]), torch.abs(d[:, 1]), torch.abs(d[:, 2])
    major_x = (ax >= ay) & (ax >= az)
    major_y = (ay > ax) & (ay >= az)

    def pick(c, a, b):
        return torch.where(c, a, b)
    face = pick(major_x, pick(d[:, 0] > 0, 0, 1),
                pick(major_y, pick(d[:, 1] > 0, 2, 3),
                     pick(d[:, 2] > 0, 4, 5)))
    ma = pick(major_x, ax, pick(major_y, ay, az))
    ma = torch.clamp(ma, min=1e-12)
    sc = pick(major_x, pick(d[:, 0] > 0, -d[:, 2], d[:, 2]),
              pick(major_y, d[:, 0], pick(d[:, 2] > 0, d[:, 0], -d[:, 0])))
    tc = pick(major_y, pick(d[:, 1] > 0, d[:, 2], -d[:, 2]), -d[:, 1])
    u = (sc / ma + 1.0) * 0.5
    v = (tc / ma + 1.0) * 0.5
    h, w = faces.shape[1], faces.shape[2]
    xi = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    yi = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return faces[face.to(torch.int64), yi, xi]


def _surface_color_alpha_tri(ds: DeviceScene, tex: DeviceTextures, accel,
                             tri, u, v):
    """Color-texture RGBA at a (global-tri, u, v) surface point (≙ the
    any-hit shaders' color fetch: texture(colorTex, uv) * colorFactor,
    anyhit.rahit:44-50)."""
    tri = torch.clamp(tri, min=0).long()
    bary0 = (1.0 - u - v)[:, None]
    ru = accel.tri_uv[tri]
    uv = (ru[:, 0:2] * bary0 + ru[:, 2:4] * u[:, None]
          + ru[:, 4:6] * v[:, None])
    row = ds.tri_mat[tri].long()
    texel = sample_texture_grad(tex, ds.mat_tex[row, T_COLOR], uv)
    return texel * ds.mat_params[row, F_COLOR:F_COLOR + 4]


def _remap_subset_tri(sel, tri):
    """Subset-local hit triangle ids → global ids (misses stay -1)."""
    return torch.where(tri >= 0, sel[torch.clamp(tri, min=0).long()], -1)


def _trace_closest_alpha_split(ds: DeviceScene, tex: DeviceTextures, accel,
                               sp: AlphaSplit, origins, dirs, alive):
    """Split-tree any-hit emulation:

    1. one closest-hit trace of the opaque tree gives a definitive per-ray
       bound t_opq: no opaque surface ever needs re-tracing;
    2. ALPHA_ROUNDS closest-hit traces of the (small) alpha tree resolve
       the α<0.5 skip chain strictly in front of that bound; the first
       α≥0.5 candidate nearer than t_opq wins, else the opaque hit does.

    Rays still pending after ALPHA_ROUNDS transparent layers resolve to the
    opaque bound hit."""
    n = origins.shape[0]
    dev = origins.device
    o_t, d_t, t_t = _degenerate_masked(sp.bvh_opaque, origins, dirs,
                                       TMAX, alive)
    hit_o = trace_closest(sp.bvh_opaque, o_t, d_t, t_t)
    bound = hit_o.t
    final_t = hit_o.t
    final_tri = _remap_subset_tri(sp.sel_opaque, hit_o.tri)
    final_u, final_v = hit_o.u, hit_o.v

    pending = alive
    cur_origin = origins
    t_accum = torch.zeros((n,), dtype=torch.float32, device=dev)
    decal_color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    decal_alpha = torch.zeros((n,), dtype=torch.float32, device=dev)
    has_decal = torch.zeros((n,), dtype=torch.bool, device=dev)

    for _ in range(ALPHA_ROUNDS):
        rem = torch.clamp(bound - t_accum, min=0.0)
        o_t, d_t, t_t = _degenerate_masked(sp.bvh_alpha, cur_origin, dirs,
                                           rem, pending)
        hit_a = trace_closest(sp.bvh_alpha, o_t, d_t, t_t)
        tri_g = _remap_subset_tri(sp.sel_alpha, hit_a.tri)
        valid = pending & hit_a.is_hit & (t_accum + hit_a.t < bound)
        rgba = _surface_color_alpha_tri(ds, tex, accel, tri_g,
                                        hit_a.u, hit_a.v)
        alpha = rgba[:, 3]
        accepts = valid & (alpha >= 0.5)
        skips = valid & (alpha < 0.5)

        record = skips & ~has_decal
        decal_color = torch.where(record[:, None], rgba[:, :3], decal_color)
        decal_alpha = torch.where(record, alpha, decal_alpha)
        has_decal = has_decal | record

        final_t = torch.where(accepts, t_accum + hit_a.t, final_t)
        final_tri = torch.where(accepts, tri_g, final_tri)
        final_u = torch.where(accepts, hit_a.u, final_u)
        final_v = torch.where(accepts, hit_a.v, final_v)

        step = hit_a.t + 1e-4
        cur_origin = torch.where(skips[:, None],
                                 cur_origin + dirs * step[:, None],
                                 cur_origin)
        t_accum = torch.where(skips, t_accum + step, t_accum)
        pending = skips
    return (Hit(final_t, final_tri, final_u, final_v), decal_color,
            decal_alpha, has_decal)


def trace_closest_alpha(ds: DeviceScene, tex: DeviceTextures, accel,
                        origins, dirs, alive):
    """Closest hit honoring alpha-tested geometry: non-opaque hits with
    α < 0.5 are recorded as decals and skipped (≙ anyhit.rahit:52-64);
    α ≥ 0.5 accepts. Returns (hit with cumulative t, decal_color (N,3),
    decal_alpha (N,), has_decal (N,)).

    A re-trace loop of fixed length: up to ALPHA_ROUNDS segments, each a
    closest-hit trace of the whole tree; lanes that are done are
    degenerated. When the accel carries an opaque/alpha partition, the
    split-tree scheme above runs instead."""
    if accel.alpha_split is not None:
        return _trace_closest_alpha_split(ds, tex, accel, accel.alpha_split,
                                          origins, dirs, alive)
    n = origins.shape[0]
    dev = origins.device
    pending = alive
    cur_origin = origins
    t_accum = torch.zeros((n,), dtype=torch.float32, device=dev)
    final = None
    decal_color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    decal_alpha = torch.zeros((n,), dtype=torch.float32, device=dev)
    has_decal = torch.zeros((n,), dtype=torch.bool, device=dev)

    for _ in range(ALPHA_ROUNDS):
        o_t, d_t, t_t = _degenerate_masked(accel.bvh, cur_origin, dirs,
                                           TMAX, pending)
        hit = trace_closest(accel.bvh, o_t, d_t, t_t)
        opaque = ds.tri_opaque[torch.clamp(hit.tri, min=0).long()]
        rgba = _surface_color_alpha_tri(ds, tex, accel, hit.tri, hit.u,
                                        hit.v)
        alpha = rgba[:, 3]
        is_alpha_skip = pending & hit.is_hit & ~opaque & (alpha < 0.5)

        # record the first (closest) decal per ray (anyhit keeps min dist)
        record = is_alpha_skip & ~has_decal
        decal_color = torch.where(record[:, None], rgba[:, :3], decal_color)
        decal_alpha = torch.where(record, alpha, decal_alpha)
        has_decal = has_decal | record

        adjusted = Hit(t_accum + hit.t, hit.tri, hit.u, hit.v)
        if final is None:
            final = adjusted
        else:
            final = Hit(*(torch.where(pending, a, f)
                          for a, f in zip(adjusted, final)))

        step = hit.t + 1e-4
        cur_origin = torch.where(is_alpha_skip[:, None],
                                 cur_origin + dirs * step[:, None],
                                 cur_origin)
        t_accum = torch.where(is_alpha_skip, t_accum + step, t_accum)
        pending = is_alpha_skip
    return final, decal_color, decal_alpha, has_decal


def _trace_occluded_alpha_split(ds: DeviceScene, tex: DeviceTextures, accel,
                                sp: AlphaSplit, origins, dirs, dist, alive,
                                reverse=None):
    """Split-tree shadow query: blocked = any opaque triangle within dist
    (one early-out occlusion trace of the opaque tree) or any alpha surface
    with α ≥ 1 within dist (closest-hit rounds over the alpha tree).
    `reverse` marks lanes whose opaque-tree query runs light→surface
    (segment-symmetric). The alpha rounds need closest-hit ordering from
    the surface, so they always run unreversed."""
    o_o, d_o, t_o = origins, dirs, dist
    if reverse is not None:
        rev = alive & reverse
        o_o = torch.where(rev[:, None], origins + dirs * dist[:, None],
                          origins)
        d_o = torch.where(rev[:, None], -dirs, dirs)
        t_o = torch.where(rev, dist - TMIN, dist)
    o_t, d_t, t_t = _degenerate_masked(sp.bvh_opaque, o_o, d_o, t_o, alive)
    occluded = alive & trace_occluded(sp.bvh_opaque, o_t, d_t, t_t)

    pending = alive & ~occluded
    cur_origin = origins
    remaining = dist
    for _ in range(ALPHA_ROUNDS):
        o_t, d_t, t_t = _degenerate_masked(sp.bvh_alpha, cur_origin, dirs,
                                           remaining, pending)
        hit = trace_closest(sp.bvh_alpha, o_t, d_t, t_t)
        tri_g = _remap_subset_tri(sp.sel_alpha, hit.tri)
        rgba = _surface_color_alpha_tri(ds, tex, accel, tri_g, hit.u, hit.v)
        translucent = hit.is_hit & (rgba[:, 3] < 1.0)
        occluded = occluded | (pending & hit.is_hit & ~translucent)
        cont = pending & translucent
        step = hit.t + 1e-4
        cur_origin = torch.where(cont[:, None],
                                 cur_origin + dirs * step[:, None],
                                 cur_origin)
        remaining = torch.where(cont, remaining - step, remaining)
        pending = cont
    return occluded


def trace_occluded_alpha(ds: DeviceScene, tex: DeviceTextures, accel,
                         origins, dirs, dist, alive, reverse=None):
    """Shadow query honoring alpha: any surface with α < 1 passes light
    (≙ occlusionAnyhit.rahit:51-53). `alive` masks lanes that need no
    shadow query at all; `dist` is (N,). Without a partition each round is
    a closest-hit trace of the whole tree (its round 0 also finds the
    opaque blockers); with one, the split scheme above runs."""
    if accel.alpha_split is not None:
        return _trace_occluded_alpha_split(ds, tex, accel,
                                           accel.alpha_split, origins,
                                           dirs, dist, alive, reverse)
    pending = alive
    occluded = torch.zeros_like(alive)
    cur_origin = origins
    remaining = dist

    for _ in range(ALPHA_ROUNDS):
        o_t, d_t, t_t = _degenerate_masked(accel.bvh, cur_origin, dirs,
                                           remaining, pending)
        hit = trace_closest(accel.bvh, o_t, d_t, t_t)
        opaque = ds.tri_opaque[torch.clamp(hit.tri, min=0).long()]
        rgba = _surface_color_alpha_tri(ds, tex, accel, hit.tri, hit.u,
                                        hit.v)
        translucent = hit.is_hit & ~opaque & (rgba[:, 3] < 1.0)
        occluded = occluded | (pending & hit.is_hit & ~translucent)
        cont = pending & translucent
        step = hit.t + 1e-4
        cur_origin = torch.where(cont[:, None],
                                 cur_origin + dirs * step[:, None],
                                 cur_origin)
        remaining = torch.where(cont, remaining - step, remaining)
        pending = cont
    return occluded


def init_rng_state(px, py, width: int, frame) -> torch.Tensor:
    return prng.init_rng(px, py, width, frame)


def raygen(px, py, width: int, height: int, inv_view, inv_proj, state,
           settings: PathTracingSettings):
    """Sample-start stage: jitter + (optional) lens draws, primary rays +
    one-pixel-offset differential rays. Returns (state, origin, direction,
    DiffRays)."""
    state, u1, u2 = prng.rand2(state)
    if settings.lens_radius > 0:
        state, lu1, lu2 = prng.rand2(state)
        ray, rx, ry = construct_primary_rays(
            px, py, width, height, inv_view, inv_proj, u1, u2,
            lu1, lu2, settings.lens_radius, settings.focal_distance)
    else:
        ray, rx, ry = construct_primary_rays(
            px, py, width, height, inv_view, inv_proj, u1, u2)
    diff = DiffRays(rx.origin, rx.direction, ry.origin, ry.direction)
    return state, ray.origin, ray.direction, diff


def start_carry(state, origin, direction, diff: DiffRays) -> BounceCarry:
    n = origin.shape[0]
    dev = origin.device
    return BounceCarry(
        state=state, origin=origin, direction=direction,
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        max_roughness=torch.zeros((n,), dtype=torch.float32, device=dev),
        rays=torch.zeros((), dtype=torch.int64, device=dev),
        diff=diff)


def _shade_hit(ds: DeviceScene, tex: DeviceTextures, accel: Accel, hit,
               ray_o, ray_d, state, alive, max_roughness, decal=None,
               diff: Optional[DiffRays] = None, nearest_mip: bool = False):
    """Vectorized closest-hit 'shader' (≙ closestHit.rchit:52-161).

    Returns a dict payload with next-ray data, NEE data, emissive, bsdf/pdf,
    plus the updated RNG state and MaxRoughness carry. All RNG draws are
    masked by `alive & hit` so dead/missed lanes keep their streams intact.
    Missed lanes gather triangle 0 (their results are never used).
    `decal` is (color (N,3), alpha (N,), has (N,)) from the alpha loops, or
    None on a scene without alpha-tested triangles.
    """
    active = alive & hit.is_hit
    tri = torch.clamp(hit.tri, min=0).long()
    bary = torch.stack([1.0 - hit.u - hit.v, hit.u, hit.v], dim=-1)

    rp = accel.tri_pos[tri]
    rn = accel.tri_nrm[tri]
    rt = accel.tri_tan[tri]
    rb = accel.tri_bit[tri]
    ru = accel.tri_uv[tri]
    p0, p1, p2 = rp[:, 0:3], rp[:, 3:6], rp[:, 6:9]
    n0, n1, n2 = rn[:, 0:3], rn[:, 3:6], rn[:, 6:9]

    def lerp3(a0, a1, a2):
        return (a0 * bary[..., 0:1] + a1 * bary[..., 1:2]
                + a2 * bary[..., 2:3])

    position = lerp3(p0, p1, p2)
    normal = lerp3(n0, n1, n2)
    tangent = lerp3(rt[:, 0:3], rt[:, 3:6], rt[:, 6:9])
    bitangent = lerp3(rb[:, 0:3], rb[:, 3:6], rb[:, 6:9])
    uv = lerp3(ru[:, 0:2], ru[:, 2:4], ru[:, 4:6])

    # geometric normal; flip the frame on inside hits (closestHit.rchit:71-85)
    gn = _normalize(cross(p1 - p0, p2 - p0))
    is_inside = torch.sum(gn * ray_d, dim=-1) > 0.0
    flip = torch.where(is_inside, -1.0, 1.0)[..., None]
    gn = gn * flip
    normal = normal * flip
    tangent = tangent * flip
    bitangent = bitangent * flip

    # ray differentials → UV footprints for textureGrad-style LOD
    if diff is not None:
        uv0, uv1, uv2 = ru[:, 0:2], ru[:, 2:4], ru[:, 4:6]
        dpdu, dpdv, dndu, dndv = compute_dpn_duv(
            p0, p1, p2, uv0, uv1, uv2, n0, n1, n2, tangent, bitangent)
        dpdx, dpdy = compute_dp_dxy(position, diff, normal)
        duv_x, duv_y = compute_uv_derivatives(dpdx, dpdy, dpdu, dpdv)
    else:
        duv_x = duv_y = None
        dndu = dndv = None

    mat = sample_material(ds, tex, ds.tri_mat[tri], uv, is_inside,
                          duv_x, duv_y, nearest_mip=nearest_mip)

    if decal is not None:
        # decal tint from skipped alpha surfaces (≙ closestHit.rchit:104-106:
        # material.Color = mix(Color, decalColor, decalAlpha))
        d_color, d_alpha, d_has = decal
        blended = (mat.color * (1.0 - d_alpha[:, None])
                   + d_color * d_alpha[:, None])
        mat = dataclasses.replace(
            mat, color=torch.where(d_has[:, None], blended, mat.color))

    # progressive roughness clamp (firefly suppression, closestHit.rchit:108-112)
    max_roughness = torch.where(active,
                                torch.maximum(mat.roughness, max_roughness),
                                max_roughness)
    mat = dataclasses.replace(
        mat, roughness=torch.clamp(max_roughness, min=0.01))

    # shading frame: perturb the vertex normal by the mapped normal through
    # the geometry TBN, then build an orthonormal frame
    mapped = (mat.normal[..., 0:1] * tangent + mat.normal[..., 1:2] * bitangent
              + mat.normal[..., 2:3] * normal)
    n = _normalize(normal + mapped)
    tbn = compute_tangent_space(n)                  # (..., 3, 3) columns T,B,N

    def to_local(v):
        return matvec(tbn.transpose(-1, -2), v)

    def to_world(v):
        return matvec(tbn, v)
    v_local = _normalize(to_local(-_normalize(ray_d)))

    state0 = state
    state, bs = sample_bsdf(mat, v_local, state)

    # Beer–Lambert attenuation through the interior (closestHit.rchit:123-128)
    atten = torch.where(
        is_inside[..., None],
        torch.pow(torch.clamp(mat.attenuation_color, min=1e-30),
                  (hit.t / torch.clamp(mat.attenuation_distance,
                                       min=1e-30))[..., None]),
        1.0)
    bsdf_color = bs.color * atten

    is_refracted = bs.direction[..., 2] < 0.0

    # ray-origin offsets (closestHit.rchit:130-140)
    ray_origin = offset_ray_origin_shadow_terminator(
        position, bary, p0, p1, p2, n0, n1, n2, is_refracted)
    refr_origin = offset_ray_origin_self_intersection(position, -gn)
    next_origin = torch.where(is_refracted[..., None], refr_origin,
                              ray_origin)

    next_dir_world = _normalize(to_world(bs.direction))
    if diff is not None:
        view = -_normalize(ray_d)
        refl = reflect_differentials(diff, duv_x, duv_y, normal, ray_origin,
                                     view, next_dir_world, dndu, dndv)
        refr = refract_differentials(diff, duv_x, duv_y, normal, ray_origin,
                                     view, next_dir_world, dndu, dndv,
                                     mat.eta)
        sel = is_refracted[:, None]
        keep = active[:, None]
        # reflected/refracted per lane; previous differentials on
        # missed/dead lanes
        new_diff = DiffRays(*(torch.where(keep, torch.where(sel, a, b), c)
                              for a, b, c in zip(refr, refl, diff)))
    else:
        new_diff = None

    # NEE light sample (closestHit.rchit:142-147): three rands
    state, u1, u2, u3 = prng.rand3(state)
    light = sample_light(u1, u2, u3, ray_origin,
                         ds.point_light_color, ds.point_light_pos,
                         ds.point_light_atten, ds.point_light_count,
                         ds.dir_light_color, ds.dir_light_dir)
    l_local = _normalize(to_local(-light.direction))
    light_bsdf, _ = evaluate_bsdf(mat, v_local, l_local)

    # lanes that missed (or are dead) must not consume RNG draws
    state = torch.where(active, state, state0)

    return dict(
        state=state,
        max_roughness=max_roughness,
        emissive=mat.emissive,
        bsdf=bsdf_color,
        pdf=bs.pdf,
        next_origin=next_origin,
        next_dir=next_dir_world,
        diff=new_diff,
        light_dir=light.direction,
        light_dist=light.distance,
        light_pdf=light.pdf,
        light_is_dir=light.is_directional,
        direct_light=light.color * light.attenuation[..., None] * light_bsdf,
    )


def bounce_once(ds: DeviceScene, tex: DeviceTextures, accel: Accel,
                carry: BounceCarry, settings: PathTracingSettings,
                bounce: int = 0) -> BounceCarry:
    """Wavefront bounce number `bounce`: closest trace -> shade -> NEE -> RR,
    as the port's `bounce_once` with its defaults (no coherence sort, no
    material sort), every trace by brute force."""
    (state, origin, direction, throughput, radiance, alive,
     max_roughness, rays, diff) = carry
    rays = rays + torch.sum(alive)

    decal = None
    if ds.has_alpha:
        hit, d_color, d_alpha, d_has = trace_closest_alpha(
            ds, tex, accel, origin, direction, alive)
        decal = (d_color, d_alpha, d_has)
    else:
        o_c, d_c, t_c = _degenerate_masked(accel.bvh, origin, direction,
                                           TMAX, alive)
        hit = trace_closest(accel.bvh, o_c, d_c, t_c)
    missed = alive & ~hit.is_hit

    sky = _skybox_emissive(ds, direction)
    radiance = radiance + torch.where(missed[..., None], throughput * sky, 0.0)

    nearest_mip = bounce > 0 and settings.tex_nearest_tail
    payload = _shade_hit(ds, tex, accel, hit, origin, direction, state, alive,
                         max_roughness, decal, diff, nearest_mip=nearest_mip)
    state = payload["state"]
    max_roughness = payload["max_roughness"]
    active = alive & hit.is_hit

    radiance = radiance + torch.where(active[..., None],
                                 throughput * payload["emissive"], 0.0)

    shadow_dir = -_normalize(payload["light_dir"])
    shadow_live = (active & (payload["light_pdf"] > 0.0)
                   & torch.any(payload["direct_light"] != 0.0, dim=-1))
    light_dist = payload["light_dist"]
    reverse = (~payload["light_is_dir"] if settings.reverse_point_shadows
               else None)
    if ds.has_alpha:
        occluded = trace_occluded_alpha(ds, tex, accel,
                                        payload["next_origin"], shadow_dir,
                                        light_dist, shadow_live,
                                        reverse=reverse)
    else:
        so_f, sd_f, st_f = payload["next_origin"], shadow_dir, light_dist
        if reverse is not None:
            rev = shadow_live & reverse
            so_f = torch.where(rev[:, None],
                               so_f + shadow_dir * light_dist[:, None], so_f)
            sd_f = torch.where(rev[:, None], -shadow_dir, sd_f)
            st_f = torch.where(rev, light_dist - TMIN, st_f)
        so, sd, sdist = _degenerate_masked(accel.bvh, so_f, sd_f, st_f,
                                           shadow_live)
        occluded = trace_occluded(accel.bvh, so, sd, sdist)
    rays = rays + torch.sum(shadow_live)
    nee_ok = shadow_live & ~occluded
    radiance = radiance + torch.where(
        nee_ok[..., None],
        throughput * payload["direct_light"]
        / torch.clamp(payload["light_pdf"], min=1e-12)[..., None],
        0.0)

    tp_update = active & (payload["pdf"] > 0.001)
    throughput = torch.where(
        tp_update[..., None],
        throughput * payload["bsdf"]
        / torch.clamp(payload["pdf"], min=1e-12)[..., None],
        throughput)

    rr_div = settings.rr_scale if bounce >= settings.rr_start_bounce else 1.0
    prob = torch.clamp(torch.max(throughput, dim=-1).values * (1.0 / rr_div),
                       max=1.0)
    dead_small = prob < 0.001
    need_rr = active & ~dead_small
    rr_state = prng.xorshift(state)
    rr = prng.uint_to_float(rr_state)
    state = torch.where(need_rr, rr_state, state)
    killed = need_rr & (prob < rr)
    survived = need_rr & ~killed
    throughput = torch.where(survived[..., None],
                             throughput / torch.clamp(prob, min=1e-12)[..., None],
                             throughput)

    return BounceCarry(state, payload["next_origin"], payload["next_dir"],
                       throughput, radiance, survived, max_roughness, rays,
                       payload["diff"])


def _degenerate_masked(bvh, origins, dirs, tmax, live):
    """Brute force has no root box: the rays go unchanged, `tmax` as a
    tensor (the port's rule for brute force)."""
    if not isinstance(tmax, torch.Tensor):
        tmax = torch.full_like(origins[:, 0], tmax)
    return origins, dirs, tmax


def trace_closest(bvh, origins, dirs, tmax):
    return bvh.closest(origins.contiguous(), dirs.contiguous(),
                       tmax.contiguous(), TMIN)


def trace_occluded(bvh, origins, dirs, dist):
    return bvh.occluded(origins.contiguous(), dirs.contiguous(),
                        dist.contiguous(), TMIN)
