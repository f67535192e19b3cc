"""Wavefront path-tracing integrator.

Port of `pt.render.integrator`: raygen, then per bounce a closest trace,
`_shade_hit`, an NEE shadow trace and Russian roulette, then
`finish_sample`. The traces dispatch on the structure's type: a `BF8BVH`
(static scenes) goes to kernels K1/K2, a binary `PacketBVH` (the per-frame
Morton tree of an animated scene, or a static tree whose BF8 collapse did
not fit) to K3/K4, and a structure that carries its own `closest` /
`occluded` methods through them: a `BF8Instanced` (static scenes with
shared-BLAS instancing) to K5/K6, the archive's `BF8V6` (A/B work) to its
kernels, the brute backend's `BruteTriangles` (`settings.backend =
"brute"`: every ray against every triangle, no tree) to `intersect_brute`,
and the LBVH backend's `ThreadedTriangles` (`settings.backend = "bvh"`:
`pt`'s threaded LBVH) to the tensor-code walk of `pt_torch.accel.traverse`.
The host drives the sample and bounce loops
(`pt_torch.run.renderer`, and `render_flat` / `render_image_stats` here,
the single-call render over the Morton tree); every stage is plain tensor
code plus the kernel launches, with no host sync inside a bounce (the
threaded walk alone syncs, to test its loop conditions).

Two knobs of `pt`, off by default, reorder lanes without changing any
lane's result: `sort_rays` traces each tail bounce's closest and shadow
rays sorted by direction octant and origin Morton code (opaque scenes over a
`PacketBVH` only), and `shade_sorted` shades the lanes in material order.

Alpha-tested geometry runs the any-hit emulation loops
(`trace_closest_alpha`, `trace_occluded_alpha`): up to ALPHA_ROUNDS
closest-hit traces per query, over the whole tree, or over the opaque and
alpha subset trees when the accel carries an `AlphaSplit` (static scenes).
In the split loops, what a round does besides its trace is on the card one
launch of a hand-written kernel that updates the loop's state in place
(`kernels.alpha_closest_round` / `alpha_shadow_round`), on the CPU its
plain twin (`_closest_round_plain` / `_shadow_round_plain`); the
whole-tree loops keep their tensor code.

Features mirrored from `pt`: next-event estimation with uniform light pick
+ disk softening, 4-lobe BSDF importance sampling, Russian roulette on max
throughput, the progressive roughness clamp, Beer–Lambert interior
attenuation, shadow-terminator + self-intersection origin offsets, reversed
point-light shadow rays, and NaN/Inf sample rejection (zeroed samples).

While the recorder of `pt_torch.core.stats` is on, `bounce_once` records
the spans "trace" (the closest query), "shade", "nee" (the shadow query and
its light) and "roulette", and the counters "closest_lanes" (the closest
trace's width), "closest_live" and "shadow_live" (the live lanes of the
closest and the shadow trace: the sums the ray counter adds already). The
alpha loops record an "alpha" span around their rounds, and per round the
counters "alpha_lanes" (the round's width) and "alpha_pending" (its pending
lanes: one reduction a round, made only while the recorder is on), and
"alpha_kernel_rounds" (one for each round the round kernel ran).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from pt_torch import default_device
from pt_torch.accel.bvh8 import BF8BVH, PacketBVH, build_packet_bvh
from pt_torch.accel.intersect import Hit, intersect_brute
from pt_torch.accel.kernels import (RoundArgs, alpha_closest_round,
                                    alpha_round_tables, alpha_shadow_round,
                                    closest_bf8, closest_round_args,
                                    closest_v4, occluded_bf8, occluded_v4,
                                    shadow_round_args)
from pt_torch.accel.lbvh import ThreadedBVH, _expand_bits_10, build_bvh
from pt_torch.accel.traverse import bvh_closest, bvh_occluded
from pt_torch.core.stats import count, span, tracing
from pt_torch.render import rng as prng
from pt_torch.render.bsdf import evaluate_bsdf, sample_bsdf
from pt_torch.render.differentials import (DiffRays, compute_dp_dxy,
                                           compute_dpn_duv,
                                           compute_uv_derivatives,
                                           reflect_differentials,
                                           refract_differentials)
from pt_torch.render.materials import sample_material
from pt_torch.render.rays import (TMAX, TMIN, construct_primary_rays,
                                  offset_ray_origin_self_intersection,
                                  offset_ray_origin_shadow_terminator)
from pt_torch.render.sampling import compute_tangent_space, sample_light
from pt_torch.render.shading import _axis, _normalize, cross, matvec
from pt_torch.render.textures import DeviceTextures, sample_texture_grad
from pt_torch.scene.flatten import (DeviceScene, F_COLOR, T_COLOR,
                                    world_vertices)
from pt_torch.scene.types import SkyboxKind

ALPHA_ROUNDS = 4   # max transparent surfaces skipped per ray segment


@dataclasses.dataclass(frozen=True)
class PathTracingSettings:
    """Integrator knobs (≙ PathTracingSettings, Renderer.h:37-52), with
    `pt`'s defaults."""
    sample_count: int = 1
    bounce_count: int = 5
    lens_radius: float = 0.0
    focal_distance: float = 1.0
    # traversal backend: "pallas" (the port's kernels: on the card the CUDA
    # kernels, on the CPU their plain versions), "bvh" (`pt`'s threaded
    # LBVH, walked in tensor code) or "brute" (every ray against every
    # triangle, no tree; cheapest for tiny scenes)
    backend: str = "pallas"
    # triangles per leaf of the threaded LBVH ("bvh" only)
    bvh_leaf_size: int = 4
    # per-bounce coherence sort of the tail bounces' rays (octant + origin
    # Morton code), shared by the closest and the shadow trace. Off, as in
    # `pt`, where the sort measured a net loss on the TPU. It reaches only
    # opaque scenes over a binary PacketBVH (K3/K4), as in `pt`; the wide
    # structures ignore it
    sort_rays: bool = False
    # NEE shadow rays toward point lights are traced reversed (origin at
    # the sampled light point): occlusion is segment-symmetric; film-equal
    # up to a TMIN sliver at the segment ends
    reverse_point_shadows: bool = True
    # Russian roulette: survival = min(maxcomp(tp)/rr_scale, 1) at bounces
    # >= rr_start_bounce; the reference rule (rr_scale 1) before
    rr_scale: float = 1.0
    rr_start_bounce: int = 0
    # nearest-mip material sampling on tail bounces (bounce >= 1)
    tex_nearest_tail: bool = True
    # material-sorted shading: lanes permuted to material order around
    # `_shade_hit` and back; a pure permutation, so the film is unchanged.
    # Off, as in `pt`
    shade_sorted: bool = False

    @classmethod
    def reference_exact(cls, **overrides) -> "PathTracingSettings":
        """Settings with every default-on divergence from the reference's
        math disabled: reference-rule point-light shadow segments and full
        trilinear textureGrad filtering at every bounce."""
        overrides.setdefault("reverse_point_shadows", False)
        overrides.setdefault("tex_nearest_tail", False)
        return cls(**overrides)


BACKENDS = ("pallas", "bvh", "brute")


def resolve_backend(settings: PathTracingSettings) -> str:
    """The backend `settings` names: "pallas", "bvh" or "brute", on any
    device. Unlike `pt`, which swaps "pallas" for brute force or its LBVH
    off the TPU, nothing is swapped: "pallas" runs the kernels' plain
    versions on the CPU. An unknown name raises."""
    backend = settings.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (pallas, bvh or "
                         "brute)")
    return backend


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


class ThreadedTriangles:
    """The LBVH backend's structure: `pt`'s `ThreadedBVH` with the world
    positions and triangle rows its leaves index, reaching
    `trace_closest`/`trace_occluded` through their duck dispatch. As for
    brute force, and as `pt`'s `_root_bounds` gives None for a
    `ThreadedBVH`, no lane is pointed out of the scene and no shadow
    distance is clamped to a root box. No hand-written kernel runs: the
    walk is `pt_torch.accel.traverse`'s tensor code."""

    has_root_box = False

    def __init__(self, bvh: ThreadedBVH, wpos: torch.Tensor,
                 tri_idx: torch.Tensor):
        self.bvh = bvh
        self.wpos = wpos
        self.tri_idx = tri_idx

    def closest(self, origins, dirs, tmax, tmin) -> Hit:
        return bvh_closest(self.bvh, self.wpos, self.tri_idx, origins, dirs,
                           tmin, tmax)

    def occluded(self, origins, dirs, dist, tmin) -> torch.Tensor:
        return bvh_occluded(self.bvh, self.wpos, self.tri_idx, origins, dirs,
                            dist, tmin)


def _root_bounds(bvh):
    """The structure's root box (lo, hi), or None for brute force and the
    threaded LBVH, which have none (`pt`'s `_root_bounds`). Read from the
    structure's `has_root_box`, not its class, so that an accel built
    before `reload_shaders` re-imported this module still answers."""
    if not getattr(bvh, "has_root_box", True):
        return None
    return bvh.root_lo, bvh.root_hi


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


def prepare_accel(ds: DeviceScene,
                  settings: Optional[PathTracingSettings] = None) -> Accel:
    """World-space flatten, per-triangle attribute packing and, for the
    "pallas" backend (the default), the Morton `PacketBVH` build, all on the
    scene's device (≙ the BLAS/TLAS update of an animated frame: rebuilt
    every frame, since all of it is dense tensor code). The "bvh" backend
    builds `pt`'s threaded LBVH of `settings.bvh_leaf_size`, the "brute"
    backend no tree."""
    settings = settings or PathTracingSettings()
    base = prepare_attribs(ds)
    backend = resolve_backend(settings)
    if backend == "brute":
        return base._replace(bvh=BruteTriangles(base.wpos, ds.tri_idx))
    if backend == "bvh":
        return base._replace(bvh=ThreadedTriangles(
            build_bvh(base.wpos, ds.tri_idx, settings.bvh_leaf_size),
            base.wpos, ds.tri_idx))
    return base._replace(bvh=build_packet_bvh(base.wpos, ds.tri_idx,
                                              tri_opaque=ds.tri_opaque))


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


def _aabb_exit_t(lo, hi, origin, direction):
    """Distance at which each ray exits the [lo, hi] box (0 if it never
    enters in front of the origin)."""
    inv = 1.0 / torch.where(torch.abs(direction) < 1e-12,
                       torch.where(direction < 0, -1e-12, 1e-12), direction)
    t0 = (lo - origin) * inv
    t1 = (hi - origin) * inv
    t_far = torch.min(torch.maximum(t0, t1), dim=-1).values
    return torch.clamp(t_far, min=0.0)


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


def _degenerate_masked(bvh, origins, dirs, tmax, live):
    """Point dead lanes at a ray that exits the scene at once: origin
    outside the root AABB, +x direction, tmax = TMIN. They leave the
    traversal at the root node; their hits are never read. `tmax` is (N,)
    or a Python scalar. Brute force and the threaded LBVH have no root box
    and get the rays unchanged, as in `pt`."""
    if not isinstance(tmax, torch.Tensor):
        tmax = torch.full_like(origins[:, 0], tmax)
    bounds = _root_bounds(bvh)
    if bounds is None:
        return origins, dirs, tmax
    outside = bounds[1] + 1.0e6
    live_c = live[:, None]
    o = torch.where(live_c, origins, outside)
    d = torch.where(live_c, dirs, _axis(0, dirs))
    t = torch.where(live, tmax, TMIN)
    return o, d, t


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


def _count_round(pending):
    """Book one alpha round's width and pending lanes to the recorder; the
    sum is made only while it is on."""
    if tracing():
        count("alpha_lanes", pending.shape[0])
        count("alpha_pending", torch.sum(pending))


class ClosestRounds(NamedTuple):
    """The closest split loop's state between its rounds. `ray` is the next
    round's masked ray (origins, directions, limits), None after the last
    round; `kernel` the round kernel's arguments besides the hit
    (`kernels.RoundArgs`), None where the plain twin runs. On the card the
    kernel updates every tensor in place, and they share memory: the
    pending lanes' current origins are the ray's origins (`cur_origin` is
    that buffer) and the final hit's t starts as `bound`'s buffer
    (`_closest_rounds_start` sets them up)."""
    pending: torch.Tensor        # (N,) bool
    t_accum: torch.Tensor        # (N,) t of the current origin on the ray
    cur_origin: torch.Tensor     # (N, 3)
    bound: torch.Tensor          # (N,) the opaque hit's t
    final: Hit                   # global triangle ids
    decal_color: torch.Tensor    # (N, 3)
    decal_alpha: torch.Tensor    # (N,)
    has_decal: torch.Tensor      # (N,) bool
    ray: Optional[tuple]
    kernel: Optional[RoundArgs] = None


class ShadowRounds(NamedTuple):
    """The shadow split loop's state between its rounds, as ClosestRounds:
    on the card the pending lanes' current origins and remaining distances
    are the next ray's origins and limits."""
    pending: torch.Tensor        # (N,) bool
    occluded: torch.Tensor       # (N,) bool
    cur_origin: torch.Tensor     # (N, 3)
    remaining: torch.Tensor      # (N,)
    ray: Optional[tuple]
    kernel: Optional[RoundArgs] = None


def _round_kernel_args(ds: DeviceScene, tex: DeviceTextures, accel,
                       sp: AlphaSplit, origins):
    """The round kernel's table and pool arguments on the card
    (`kernels.alpha_round_tables`), None on the CPU."""
    if origins.device.type == "cpu":
        return None
    return alpha_round_tables(sp.sel_alpha, accel.tri_uv, ds.tri_mat,
                              ds.mat_tex, T_COLOR, ds.mat_params, F_COLOR,
                              tex)


def _own_ray(ray, origins, limits):
    """The first masked ray, in buffers of the loop's own for the round
    kernel to write: without a root box `_degenerate_masked` hands back the
    caller's origins (and, in the shadow loop, its distances), and its
    directions, which the kernel then leaves alone."""
    o, d, t = ray
    return (o.clone() if o is origins else o, d,
            t.clone() if t is limits else t)


def _root_hi(bvh):
    """The structure's root box's upper corner, None where it has none."""
    bounds = _root_bounds(bvh)
    return None if bounds is None else bounds[1]


def _closest_rounds_start(sp: AlphaSplit, hit_o: Hit, final_tri, origins,
                          dirs, alive, tables) -> ClosestRounds:
    """The closest loop's state before its first round: every live lane
    pending at the origin, the opaque hit as the final one, no decal, and
    the first round's masked ray. `tables`: the round kernel's
    (`_round_kernel_args`), or None for the plain twin."""
    if tables is not None:         # the kernel reads rows in lane order
        origins, dirs = origins.contiguous(), dirs.contiguous()
    n = origins.shape[0]
    dev = origins.device
    t_accum = torch.zeros((n,), dtype=torch.float32, device=dev)
    decal_color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    decal_alpha = torch.zeros((n,), dtype=torch.float32, device=dev)
    has_decal = torch.zeros((n,), dtype=torch.bool, device=dev)
    bound = hit_o.t
    rem = torch.clamp(bound - t_accum, min=0.0)
    ray = _degenerate_masked(sp.bvh_alpha, origins, dirs, rem, alive)
    final = Hit(bound, final_tri, hit_o.u, hit_o.v)
    if tables is None:
        return ClosestRounds(alive, t_accum, origins, bound, final,
                             decal_color, decal_alpha, has_decal, ray)
    ray = _own_ray(ray, origins, None)
    pending = alive.clone(memory_format=torch.contiguous_format)
    return ClosestRounds(pending, t_accum, ray[0], bound, final, decal_color,
                         decal_alpha, has_decal, ray, closest_round_args(
                             pending, t_accum, bound, final, decal_color,
                             decal_alpha, has_decal, dirs, ray,
                             _root_hi(sp.bvh_alpha), tables))


def _closest_round_plain(ds: DeviceScene, tex: DeviceTextures, accel,
                         sp: AlphaSplit, st: ClosestRounds, dirs, hit_a: Hit,
                         last: bool) -> ClosestRounds:
    """One round of the closest loop after its trace, in tensor code: the
    plain twin of `alpha_closest_round`, which the CPU runs."""
    (pending, t_accum, cur_origin, bound, final, decal_color, decal_alpha,
     has_decal, _, kernel) = st
    final_t, final_tri, final_u, final_v = final
    tri_g = _remap_subset_tri(sp.sel_alpha, hit_a.tri)
    valid = pending & hit_a.is_hit & (t_accum + hit_a.t < bound)
    rgba = _surface_color_alpha_tri(ds, tex, accel, tri_g, hit_a.u, hit_a.v)
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
    cur_origin = torch.where(skips[:, None], cur_origin + dirs * step[:, None],
                             cur_origin)
    t_accum = torch.where(skips, t_accum + step, t_accum)
    pending = skips
    ray = None
    if not last:
        rem = torch.clamp(bound - t_accum, min=0.0)
        ray = _degenerate_masked(sp.bvh_alpha, cur_origin, dirs, rem, pending)
    return ClosestRounds(pending, t_accum, cur_origin, bound,
                         Hit(final_t, final_tri, final_u, final_v),
                         decal_color, decal_alpha, has_decal, ray, kernel)


def _closest_round(ds: DeviceScene, tex: DeviceTextures, accel,
                   sp: AlphaSplit, st: ClosestRounds, dirs, hit_a: Hit,
                   last: bool) -> ClosestRounds:
    """One round of the closest loop after its trace: on the card one
    launch of the round kernel, which updates `st` in place; on the CPU its
    plain twin."""
    if st.kernel is None:
        return _closest_round_plain(ds, tex, accel, sp, st, dirs, hit_a, last)
    count("alpha_kernel_rounds", 1)
    alpha_closest_round(hit_a, st.kernel)
    return st


def _trace_closest_alpha_split(ds: DeviceScene, tex: DeviceTextures, accel,
                               sp: AlphaSplit, origins, dirs, alive):
    """Split-tree any-hit emulation:

    1. one closest-hit trace of the opaque tree gives a definitive per-ray
       bound t_opq: no opaque surface ever needs re-tracing;
    2. ALPHA_ROUNDS closest-hit traces of the (small) alpha tree resolve
       the α<0.5 skip chain strictly in front of that bound; the first
       α≥0.5 candidate nearer than t_opq wins, else the opaque hit does.

    Rays still pending after ALPHA_ROUNDS transparent layers resolve to the
    opaque bound hit. What a round does besides its trace is
    `_closest_round`: on the card one kernel launch."""
    o_t, d_t, t_t = _degenerate_masked(sp.bvh_opaque, origins, dirs,
                                       TMAX, alive)
    hit_o = trace_closest(sp.bvh_opaque, o_t, d_t, t_t)
    final_tri = _remap_subset_tri(sp.sel_opaque, hit_o.tri)

    with span("alpha"):
        st = _closest_rounds_start(sp, hit_o, final_tri, origins, dirs,
                                   alive, _round_kernel_args(ds, tex, accel,
                                                             sp, origins))
        for r in range(ALPHA_ROUNDS):
            _count_round(st.pending)
            hit_a = trace_closest(sp.bvh_alpha, *st.ray)
            st = _closest_round(ds, tex, accel, sp, st, dirs, hit_a,
                                r == ALPHA_ROUNDS - 1)
    return st.final, st.decal_color, st.decal_alpha, st.has_decal


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

    with span("alpha"):
        for _ in range(ALPHA_ROUNDS):
            _count_round(pending)
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
            decal_color = torch.where(record[:, None], rgba[:, :3],
                                      decal_color)
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


def _shadow_rounds_start(sp: AlphaSplit, occluded, origins, dirs, dist,
                         alive, tables) -> ShadowRounds:
    """The shadow loop's state before its first round: the live lanes that
    the opaque tree leaves unoccluded pending at the surface, with the
    whole distance left, and the first round's masked ray; `tables` as for
    `_closest_rounds_start`."""
    if tables is not None:         # the kernel reads rows in lane order
        origins, dirs = origins.contiguous(), dirs.contiguous()
        dist = dist.contiguous()
    pending = alive & ~occluded
    ray = _degenerate_masked(sp.bvh_alpha, origins, dirs, dist, pending)
    if tables is None:
        return ShadowRounds(pending, occluded, origins, dist, ray)
    ray = _own_ray(ray, origins, dist)
    return ShadowRounds(pending, occluded, ray[0], ray[2], ray,
                        shadow_round_args(pending, occluded, dirs, ray,
                                          _root_hi(sp.bvh_alpha), tables))


def _shadow_round_plain(ds: DeviceScene, tex: DeviceTextures, accel,
                        sp: AlphaSplit, st: ShadowRounds, dirs, hit: Hit,
                        last: bool) -> ShadowRounds:
    """One round of the shadow loop after its trace, in tensor code: the
    plain twin of `alpha_shadow_round`, which the CPU runs."""
    pending, occluded, cur_origin, remaining, _, kernel = st
    tri_g = _remap_subset_tri(sp.sel_alpha, hit.tri)
    rgba = _surface_color_alpha_tri(ds, tex, accel, tri_g, hit.u, hit.v)
    translucent = hit.is_hit & (rgba[:, 3] < 1.0)
    occluded = occluded | (pending & hit.is_hit & ~translucent)
    cont = pending & translucent
    step = hit.t + 1e-4
    cur_origin = torch.where(cont[:, None], cur_origin + dirs * step[:, None],
                             cur_origin)
    remaining = torch.where(cont, remaining - step, remaining)
    pending = cont
    ray = None
    if not last:
        ray = _degenerate_masked(sp.bvh_alpha, cur_origin, dirs, remaining,
                                 pending)
    return ShadowRounds(pending, occluded, cur_origin, remaining, ray, kernel)


def _shadow_round(ds: DeviceScene, tex: DeviceTextures, accel,
                  sp: AlphaSplit, st: ShadowRounds, dirs, hit: Hit,
                  last: bool) -> ShadowRounds:
    """One round of the shadow loop after its trace: on the card one launch
    of the round kernel, in place; on the CPU its plain twin."""
    if st.kernel is None:
        return _shadow_round_plain(ds, tex, accel, sp, st, dirs, hit, last)
    count("alpha_kernel_rounds", 1)
    alpha_shadow_round(hit, st.kernel)
    return st


def _trace_occluded_alpha_split(ds: DeviceScene, tex: DeviceTextures, accel,
                                sp: AlphaSplit, origins, dirs, dist, alive,
                                reverse=None):
    """Split-tree shadow query: blocked = any opaque triangle within dist
    (one early-out occlusion trace of the opaque tree) or any alpha surface
    with α ≥ 1 within dist (closest-hit rounds over the alpha tree).
    `reverse` marks lanes whose opaque-tree query runs light→surface
    (segment-symmetric). The alpha rounds need closest-hit ordering from
    the surface, so they always run unreversed. What a round does besides
    its trace is `_shadow_round`: on the card one kernel launch."""
    o_o, d_o, t_o = origins, dirs, dist
    if reverse is not None:
        rev = alive & reverse
        o_o = torch.where(rev[:, None], origins + dirs * dist[:, None],
                          origins)
        d_o = torch.where(rev[:, None], -dirs, dirs)
        t_o = torch.where(rev, dist - TMIN, dist)
    o_t, d_t, t_t = _degenerate_masked(sp.bvh_opaque, o_o, d_o, t_o, alive)
    occluded = alive & trace_occluded(sp.bvh_opaque, o_t, d_t, t_t)

    with span("alpha"):
        st = _shadow_rounds_start(sp, occluded, origins, dirs, dist, alive,
                                  _round_kernel_args(ds, tex, accel, sp,
                                                     origins))
        for r in range(ALPHA_ROUNDS):
            _count_round(st.pending)
            hit = trace_closest(sp.bvh_alpha, *st.ray)
            st = _shadow_round(ds, tex, accel, sp, st, dirs, hit,
                               r == ALPHA_ROUNDS - 1)
    return st.occluded


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

    with span("alpha"):
        for _ in range(ALPHA_ROUNDS):
            _count_round(pending)
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


def trace_closest(bvh, origins, dirs, tmax):
    """Closest-hit query; the structure's type selects the kernel: K1 over
    a BF8BVH, K3 over a PacketBVH (their plain versions on the CPU), and any
    structure that carries its own `closest` method through it, as `pt`'s
    duck dispatch does: K5 over a BF8Instanced, `closest_v6` over the
    archive's BF8V6, `intersect_brute` over BruteTriangles, the threaded
    walk over ThreadedTriangles. tmax is (N,)
    f32. A BF8Instanced strips ALPHA_TRI_BIT and, when it carries
    `seg_tri_base`, remaps (segment, mesh-local) ids to global flattened
    ids."""
    args = (origins.contiguous(), dirs.contiguous(), tmax.contiguous(), TMIN)
    if isinstance(bvh, BF8BVH):
        return closest_bf8(bvh, *args)
    if isinstance(bvh, PacketBVH):
        return closest_v4(bvh, *args)
    if hasattr(bvh, "closest"):
        return bvh.closest(*args)
    raise NotImplementedError(
        f"no traversal kernel for {type(bvh).__name__}")


def trace_occluded(bvh, origins, dirs, dist):
    """Shadow query (≙ checkOccluded, raygen.rgen:22-33): K2 over a BF8BVH,
    K4 over a PacketBVH, a structure's own `occluded` method otherwise (K6
    over a BF8Instanced, `occluded_v6` over a BF8V6, brute force over
    BruteTriangles, the threaded walk over ThreadedTriangles)."""
    args = (origins.contiguous(), dirs.contiguous(), dist.contiguous(), TMIN)
    if isinstance(bvh, BF8BVH):
        return occluded_bf8(bvh, *args)
    if isinstance(bvh, PacketBVH):
        return occluded_v4(bvh, *args)
    if hasattr(bvh, "occluded"):
        return bvh.occluded(*args)
    raise NotImplementedError(
        f"no occlusion kernel for {type(bvh).__name__}")


def _coherence_keys(bvh, origin, direction, alive):
    """Ray-sorting keys for packet coherence, bit-equal to `pt`'s uint32
    keys (carried in int64): direction octant (3 bits) above the 27-bit
    Morton code of the origin within the tree's root box. Dead lanes key to
    0xFFFFFFFF, so that a sort puts them last."""
    lo, hi = bvh.root_lo, bvh.root_hi
    ext = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((origin - lo) / ext * 512.0, 0.0, 511.0).to(torch.int64)
    morton = (_expand_bits_10(q[:, 0]) << 2 | _expand_bits_10(q[:, 1]) << 1
              | _expand_bits_10(q[:, 2])) & ((1 << 27) - 1)
    octant = ((direction[:, 0] < 0).to(torch.int64) << 2
              | (direction[:, 1] < 0).to(torch.int64) << 1
              | (direction[:, 2] < 0).to(torch.int64))
    key = (octant << 27) | morton
    return torch.where(alive, key, 0xFFFFFFFF)


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


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """The inverse of a permutation of 0..n-1."""
    return torch.empty_like(perm).scatter_(
        0, perm, torch.arange(perm.shape[0], device=perm.device))


def _permute(x, perm):
    """A lane-indexed value (a tensor; a tuple of them: a Hit, DiffRays or
    the decal triple; or None) with its lanes taken in `perm`'s order."""
    if x is None:
        return None
    if isinstance(x, tuple):
        parts = [a[perm] for a in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x[perm]


def _shade_sorted(ds, tex, accel, hit, origin, direction, state, alive,
                  max_roughness, decal, diff, nearest_mip):
    """`_shade_hit` over the lanes in material order (`pt`'s
    `shade_sorted`): a stable sort by the hit's material row (missed and
    dead lanes last), shade, and the payload permuted back. A pure
    permutation: each lane's RNG state and inputs travel with it."""
    mat_key = torch.where(alive & hit.is_hit,
                          ds.tri_mat[torch.clamp(hit.tri, min=0).long()],
                          0x7FFFFFF)
    perm = torch.argsort(mat_key, stable=True)
    inv = _inverse(perm)
    payload = _shade_hit(ds, tex, accel, _permute(hit, perm),
                         origin[perm], direction[perm], state[perm],
                         alive[perm], max_roughness[perm],
                         _permute(decal, perm), _permute(diff, perm),
                         nearest_mip=nearest_mip)
    return {k: _permute(v, inv) for k, v in payload.items()}


def bounce_once(ds: DeviceScene, tex: DeviceTextures, accel: Accel,
                carry: BounceCarry, settings: PathTracingSettings,
                bounce: int = 0,
                sort_rays: Optional[bool] = None) -> BounceCarry:
    """Wavefront bounce number `bounce`: closest trace → shade → NEE → RR
    (≙ one iteration of raygen.rgen:62-97). RR divides by
    settings.rr_scale from settings.rr_start_bounce on; bounces >= 1
    sample materials at the nearest mip when settings.tex_nearest_tail.

    With settings.sort_rays, an opaque scene over a PacketBVH traces the
    closest and the shadow rays in coherence order (`_coherence_keys`,
    stable), dead lanes pointed out of the scene, and scatters the results
    back. `sort_rays` says whether this bounce may sort: None means on the
    tail bounces (bounce >= 1), as `pt`'s host-driven loop has it;
    `render_flat` passes True, as `pt`'s single-program render sorts every
    bounce. As in `pt`, the sorted shadow trace is not reversed toward
    point lights."""
    (state, origin, direction, throughput, radiance, alive,
     max_roughness, rays, diff) = carry
    live = torch.sum(alive)
    count("closest_lanes", alive.shape[0])
    count("closest_live", live)
    rays = rays + live
    if sort_rays is None:
        sort_rays = bounce > 0
    # the coherence sort: opaque scenes over a binary tree only (`pt`)
    sort = (sort_rays and settings.sort_rays and not ds.has_alpha
            and isinstance(accel.bvh, PacketBVH))

    decal = None
    with span("trace"):
        if ds.has_alpha:
            # alpha-tested geometry: the re-trace loops give any-hit semantics
            hit, d_color, d_alpha, d_has = trace_closest_alpha(
                ds, tex, accel, origin, direction, alive)
            decal = (d_color, d_alpha, d_has)
        elif sort:
            # one permutation for the closest and the shadow trace
            perm = torch.argsort(_coherence_keys(accel.bvh, origin, direction,
                                                 alive), stable=True)
            inv = _inverse(perm)
            o_s, d_s, t_s = _degenerate_masked(accel.bvh, origin[perm],
                                               direction[perm], TMAX,
                                               alive[perm])
            hit = _permute(trace_closest(accel.bvh, o_s, d_s, t_s), inv)
        else:
            # dead lanes are degenerated so they leave the traversal at the
            # root; their hits are never read (all below is gated on `alive`)
            o_c, d_c, t_c = _degenerate_masked(accel.bvh, origin, direction,
                                               TMAX, alive)
            hit = trace_closest(accel.bvh, o_c, d_c, t_c)

    with span("shade"):
        missed = alive & ~hit.is_hit

        # miss: add skybox emissive, terminate (raygen.rgen:73-77)
        sky = _skybox_emissive(ds, direction)
        radiance = radiance + torch.where(missed[..., None], throughput * sky,
                                          0.0)

        nearest_mip = bounce > 0 and settings.tex_nearest_tail
        shade = _shade_sorted if settings.shade_sorted else _shade_hit
        payload = shade(ds, tex, accel, hit, origin, direction, state, alive,
                        max_roughness, decal, diff, nearest_mip=nearest_mip)
        state = payload["state"]
        max_roughness = payload["max_roughness"]
        active = alive & hit.is_hit

        # emissive (raygen.rgen:79)
        radiance = radiance + torch.where(active[..., None],
                                          throughput * payload["emissive"],
                                          0.0)

    with span("nee"):
        # NEE (raygen.rgen:81-83). Shadow distances are clamped to the scene
        # AABB exit (a tree's root box; brute force and the threaded LBVH have
        # none, as in `pt`): no occluder exists outside the scene. Shadow rays
        # whose contribution is identically zero are not traced (film-exact).
        shadow_dir = -_normalize(payload["light_dir"])
        shadow_live = (active & (payload["light_pdf"] > 0.0)
                       & torch.any(payload["direct_light"] != 0.0, dim=-1))
        light_dist = payload["light_dist"]
        bounds = _root_bounds(accel.bvh)
        if bounds is not None:
            light_dist = torch.minimum(
                light_dist,
                _aabb_exit_t(bounds[0], bounds[1], payload["next_origin"],
                             shadow_dir) + 1e-3)
        reverse = (~payload["light_is_dir"] if settings.reverse_point_shadows
                   else None)
        if ds.has_alpha:
            occluded = trace_occluded_alpha(ds, tex, accel,
                                            payload["next_origin"], shadow_dir,
                                            light_dist, shadow_live,
                                            reverse=reverse)
        elif sort:
            so, sd, sdist = _degenerate_masked(
                accel.bvh, payload["next_origin"][perm], shadow_dir[perm],
                light_dist[perm], shadow_live[perm])
            occluded = trace_occluded(accel.bvh, so, sd, sdist)[inv]
        else:
            so_f, sd_f, st_f = payload["next_origin"], shadow_dir, light_dist
            if reverse is not None:
                # point-light lanes trace light → surface; the -TMIN limit
                # excludes the shading surface the forward trace excluded via
                # tmin
                rev = shadow_live & reverse
                so_f = torch.where(rev[:, None],
                                   so_f + shadow_dir * light_dist[:, None],
                                   so_f)
                sd_f = torch.where(rev[:, None], -shadow_dir, sd_f)
                st_f = torch.where(rev, light_dist - TMIN, st_f)
            so, sd, sdist = _degenerate_masked(accel.bvh, so_f, sd_f, st_f,
                                               shadow_live)
            occluded = trace_occluded(accel.bvh, so, sd, sdist)
        shadow_rays = torch.sum(shadow_live)
        count("shadow_live", shadow_rays)
        rays = rays + shadow_rays
        nee_ok = shadow_live & ~occluded
        radiance = radiance + torch.where(
            nee_ok[..., None],
            throughput * payload["direct_light"]
            / torch.clamp(payload["light_pdf"], min=1e-12)[..., None],
            0.0)

    with span("roulette"):
        # throughput update (raygen.rgen:85-86): only when pdf > 1e-3
        tp_update = active & (payload["pdf"] > 0.001)
        throughput = torch.where(
            tp_update[..., None],
            throughput * payload["bsdf"]
            / torch.clamp(payload["pdf"], min=1e-12)[..., None],
            throughput)

        # Russian roulette (raygen.rgen:88-97); the continuation rand is drawn
        # only on lanes that reach it (masked state advance)
        rr_div = (settings.rr_scale if bounce >= settings.rr_start_bounce
                  else 1.0)
        prob = torch.clamp(
            torch.max(throughput, dim=-1).values * (1.0 / rr_div), max=1.0)
        dead_small = prob < 0.001
        need_rr = active & ~dead_small
        rr_state = prng.xorshift(state)
        rr = prng.uint_to_float(rr_state)
        state = torch.where(need_rr, rr_state, state)
        killed = need_rr & (prob < rr)
        survived = need_rr & ~killed
        throughput = torch.where(
            survived[..., None],
            throughput / torch.clamp(prob, min=1e-12)[..., None], throughput)

    return BounceCarry(state, payload["next_origin"], payload["next_dir"],
                       throughput, radiance, survived, max_roughness, rays,
                       payload["diff"])


def finish_sample(carry: BounceCarry, radiance_sum):
    """NaN/Inf rejection + accumulate (≙ raygen.rgen:99-117, rejected
    samples zeroed instead of resampled)."""
    return radiance_sum + _finite_or_zero(carry.radiance)


def render_flat(ds: DeviceScene, tex: DeviceTextures, inv_view, inv_proj,
                px, py, width: int, height: int, frame,
                settings: PathTracingSettings):
    """`settings.sample_count` full paths for each listed pixel, in one
    call (≙ `pt`'s single-program render; here a host loop).

    As in `pt`: the accel is `prepare_accel`'s for `settings.backend`
    (the Morton `PacketBVH`, so K3/K4 on the card, or brute force); the
    RNG is seeded once from `frame` and carried
    from sample to sample; one ray counter runs across the samples; every
    bounce samples textures with full trilinear filtering (no nearest-mip
    tail), while Russian roulette still reads the bounce index; with
    settings.sort_rays every bounce, the primary one too, sorts.

    Returns (radiance (N, 3) summed over the samples, rays () int64).
    """
    accel = prepare_accel(ds, settings)
    trilinear = dataclasses.replace(settings, tex_nearest_tail=False)
    state = init_rng_state(px, py, width, frame)
    radiance_sum = torch.zeros((px.shape[0], 3), dtype=torch.float32,
                               device=px.device)
    ray_count = torch.zeros((), dtype=torch.int64, device=px.device)
    for _ in range(settings.sample_count):
        state, origin, direction, diff = raygen(px, py, width, height,
                                                inv_view, inv_proj, state,
                                                settings)
        carry = start_carry(state, origin, direction, diff)
        carry = carry._replace(rays=ray_count)
        for bounce in range(settings.bounce_count):
            carry = bounce_once(ds, tex, accel, carry, trilinear, bounce,
                                sort_rays=True)
        radiance_sum = finish_sample(carry, radiance_sum)
        state, ray_count = carry.state, carry.rays
    return radiance_sum, ray_count


def scene_device(ds: DeviceScene, tex: DeviceTextures,
                 device=None) -> torch.device:
    """The device a single-call render runs on (`default_device(device)`),
    after checking that the scene and the texture pool lie on it."""
    device = default_device(device)
    for what, t in (("scene", ds.tri_idx), ("texture pool", tex.data)):
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(f"the {what} is on {t.device}, the render on "
                             f"{device}")
    return device


def render_image_stats(ds: DeviceScene, tex: DeviceTextures, inv_view,
                       inv_proj, width: int, height: int, frame,
                       settings: PathTracingSettings, device=None):
    """Full-frame render through `render_flat`, pixels in row-major order,
    over `settings.backend`'s accel. Returns ((H, W, 3) radiance summed over
    the samples, rays traced: a 0-d int64 tensor).

    `device`: None means the card (`default_device`); the scene and the
    texture pool must already be on it, or this raises."""
    device = scene_device(ds, tex, device)
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    mat = lambda m: torch.as_tensor(m, dtype=torch.float32,  # noqa: E731
                                    device=device)
    radiance, rays = render_flat(ds, tex, mat(inv_view), mat(inv_proj),
                                 xs.reshape(-1), ys.reshape(-1), width,
                                 height, frame, settings)
    return radiance.reshape(height, width, 3), rays


def render_image(ds: DeviceScene, tex: DeviceTextures, inv_view, inv_proj,
                 width: int, height: int, frame,
                 settings: PathTracingSettings, device=None):
    """Full-frame render: (H, W, 3) radiance sum over sample_count samples."""
    return render_image_stats(ds, tex, inv_view, inv_proj, width, height,
                              frame, settings, device)[0]
