#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pt_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--sass-against OTHER_CHECKOUT]

Phases, each fatal on failure (nothing is caught and passed over):

1. device: name, count, versions, `nvidia-smi` name and power limit;
2. build: every traversal kernel (one nvcc per source for sm_90a, with
   -Xptxas -v) and the native SBVH library (g++), all started together;
   the warp K1/closest_v6's, K2/occluded_v6's, K3/K4's, K5/K6's,
   closest_ordered's and closest_v6k2/closest_v7's resident blocks per SM
   and shared memory per block;
   with --sass-against, every library's SASS against that checkout's,
   kernel by kernel (logged);
3. kernel parity at full size, each kernel against its plain PyTorch version
   on the card: K1 (closest_bf8) and K2 (occluded_bf8, and opaque_only on a
   structure with every other triangle non-opaque) over the Heightfield
   (n=224) SBVH→BF8; K3 (closest_v4) and K4 (occluded_v4), the warp
   kernels, over the Morton tree of the Animated Heightfield; 16,384 rays
   each from real wavefronts (bounce 0, a later bounce, and a later bounce
   with the lanes the integrator has killed) and 16,384 seeded random rays;
   on the same sets the warp kernels bit-equal to the per-ray arm
   (closest_v4_per_ray, occluded_v4_per_ray) on every lane, over that tree,
   the Morton tree of the same triangles at block 128 and two static SAH
   trees (the v4 fallback, and one at block >= 512), each also against
   the plain versions, and on the same sets and trees the warp
   closest_ordered bit-equal to its per-ray arm (closest_ordered_per_ray)
   and its plain warp schedule; the warp K1 (closest_bf8) and closest_v6 bit-equal
   to their per-ray arm (closest_bf8_per_ray, closest_v6_per_ray) and to
   their plain warp schedule on every lane of every BF8 and BF8V6 set (on
   the BF8V6 sets also the warp closest_v6k2 and closest_v7, at windows 1
   and 8, against closest_v6k2_per_ray and closest_v7_per_ray), and
   likewise the warp K2 (occluded_bf8, opaque_only off and on) and
   occluded_v6 (occluded_bf8_per_ray, occluded_v6_per_ray) on the same
   rays up to seeded distances and on the recorded shadow wavefronts of
   the first and last bounce as the integrator sends them (killed lanes
   included): the Heightfield's tree (and its half-alpha variant and its
   BF8V6), the Courtyard at detail 1.0 (the flat tree and its opaque and
   alpha subset trees; the BF8V6 of its SBVH is over pt's 640 KiB table
   cap, which the run logs), the 64 instances flattened, opaque and with
   alpha cards (and the cards' subset trees), and the static alpha
   variant's three trees;
4. main path, static: `Renderer(device="cuda")` on the Heightfield at 512²,
   5 bounces, 4 spp: one warm render, then 3 timed renders with the launch
   counters set to 0 just before and read just after; film checks, a PNG
   through `postprocess` + `write_image`, ms per render step, Mrays/s, peak
   memory, one more block of 3 steps for the spread within the call, a
   torch.profiler breakdown of one sample, and K1/K2's CUDA-event time on
   the real bounce-0 and bounce-2 wavefronts against plain version and bound;
   the A/B of K1's and K2's two designs on the same wavefronts (per-ray,
   warp, warp, per-ray), the plain warp schedule's groups, lanes per group
   and chunks staged there, and ptxas's -v line and resident blocks of the
   warp K1 and K2;
5. main path, animated: the Animated Heightfield (99,458 triangles on a
   keyframed node) at 512², 5 bounces, 4 spp, 5 frames of `scene.update(1/24)`
   → `update_scene_data` → rebuild → `render()`, the last 4 counted (launch
   counters as above): per frame the rebuild's CUDA-event ms (from the second
   counted frame on with host syncs forbidden), the render step's ms, Mrays/s
   and peak memory; the tree must change and the film be reset every frame;
   a PNG; torch.profiler breakdowns of one sample and of one rebuild; K3/K4's
   time on the real bounce-0 and bounce-2 wavefronts against plain version
   and bound; the A/B of K3/K4's two designs on the same wavefronts (per-ray,
   warp, warp, per-ray), each against that bound, and the plain warp
   schedule's groups and lanes per group there (its hits equal the
   kernels');
6. alpha variants at 256², 3 bounces: the animated one (the ground plus
   5,200 alpha-tested card triangles: single-tree re-trace loops over K3)
   and the static one (split trees, K1/K2), with checks that decals and
   accepted alpha hits occur;
7. main path, instanced: 64 instances of one 6,050-triangle grid over a
   ground slab (387,202 flattened triangles) with `instancing="auto"`, opaque
   and with an alpha-tested foliage card per instance, at 512², 5 bounces, 4
   spp: the policy must select the shared-BLAS structure (`BF8Instanced`, and
   on the alpha variant for both subset trees too), every trace then runs
   K5/K6 (launch counters as above); build seconds, ms per step, Mrays/s,
   peak memory, shared against flattened page bytes, K5/K6's time on the real
   bounce-0 and bounce-2 wavefronts against plain version and bound; the A/B
   of K5/K6's two designs on the same wavefronts (per-ray, warp, warp,
   per-ray), each against that bound, and the plain warp schedule's groups
   (pages staged), the distinct leaves in them and lanes per group there
   (its hits equal the kernels'), and on the alpha variant the same A/B of
   K5 on the alpha-card tree's first alpha round of bounces 0 and 2; the
   same scene with
   `instancing="flatten"` for the gates: primary-hit flips <= 0.5% of the
   pixels, mean film shift <= 2%; its launches (K1/K2 only: 60/60 in 3
   steps, 540/60 with the cards) and, opaque, the A/B of K1's two designs
   on its bounce-0 and bounce-2 wavefronts;
8. archive: `pt`'s archive kernels through the entry points that select
   them (`pt_torch.accel.archive`), with the launch and call counters set to
   0 before each run and read after. Path (a): `pt_torch.benches.bvh_kernels`
   and `.widesub_ab` (Heightfield and Courtyard) at 65,536 rays, every arm
   with 0 oracle mismatches and the occlusion arms agreeing with v1, one
   JSON line per arm with its CUDA-event time. Path (b): the Heightfield at
   512², 5 bounces, 4 spp with its tree swapped for a BF8V6 (exactly 60
   closest_v6 and 60 occluded_v6 launches in 3 steps, no K1/K2), against the
   BF8 frame of the same RNG (film MSE < 1e-3, primary-hit flips <= 0.5%);
   direct calls of v6k2 and v7 on one recorded sample; closest_ordered,
   closest_v6, closest_v6k2, closest_v7 and occluded_v6 against their plain
   versions on 16,384-ray sets of real wavefronts and random rays (only
   exact-tie lanes may differ), closest_ordered over the harness's SAH tree,
   the fine SBVH and the Animated Heightfield's Morton tree; their times on
   the bounce-0 and bounce-2 wavefronts, closest_ordered beside K3 on the
   Morton tree's, each bound from the least work of the walks that computed
   the same function on the same rays; the A/B of closest_v6's,
   closest_v6k2's, closest_v7's and occluded_v6's two designs on the same
   wavefronts, and of
   closest_ordered's over the fine SBVH and the Morton tree (beside the
   warp K3), their plain warp schedules' groups and ptxas's lines; the warp
   closest_ordered bit-equal to its per-ray arm and plain schedule over the
   harness's SAH tree and the fine SBVH; the Heightfield (n=64) with a BF8V6
   at 64², card against CPU;
9. the Courtyard at 512², 5 bounces: detail 0.85 with `instancing="shared"`
   (985 segments; three instanced trees) and detail 1.0 with "auto" (1135
   segments, above the cap: the flat BF8 path with split trees); the Default
   scene (embedded PNG textures) at 512², written to a PNG;
10. cross-device film, card (kernels) against CPU (plain versions), MSE <
    1e-3 each: the Heightfield (n=64) at 64², 1 spp, 3 bounces; two animated
    alpha frames, the static alpha variant and a small instanced alpha scene
    at 32²;
11. budget and drain: `pt`'s last two Pallas entry points through K1's
    pops launch (`closest_bf8(..., pops=)`, the warp kernel's pops
    instance: each lane's walk iterations; a warp's rounds are its lanes'
    most, as a one-thread-per-ray schedule would step).
    `pt_torch.benches.budget.main` at its defaults (the Heightfield n=224
    under its SAH tree, 512², 5 bounces: per-bounce stage times,
    `rounds_of` and the warp lockstep share, leaf-visit waste, the union
    table, the shade parts, a bounce against lane count) and
    `.drain_sim.main` (`done_rounds_of`) for the Heightfield and the
    Courtyard at COURT_TEX_SCALE (whose triangles are checked equal to
    those at COURT_TEX_SCALE_PARITY), launch counters as above. On every
    bounce's wavefront: the pops launch's and its per-ray arm's
    (`closest_bf8_per_ray(..., pops=)`) hits equal the warp K1's on every
    lane, their pops each other's and the plain walk's on 16,384 lanes,
    their sum a counted launch's node visits plus leaf retests, the bench's
    rounds, done and lockstep those of the per-ray arm's pops, rounds the
    most of done per block, no stack above its bound. The A/B of the pops
    launch against its per-ray arm (per-ray, warp, warp, per-ray) beside
    the warp and the per-ray K1 on the bounce-0 and bounce-2 wavefronts,
    with its plain walk and its bound (K1's plus 4 bytes a lane). The phase
    logs its own seconds.

Phase 3 also holds K5 (closest_bf8i, with raw_ids) and K6 (occluded_bf8i,
with opaque_only), the warp kernels, against their plain versions over the
64-instance tree and over the three trees of the Courtyard at detail 0.85
(lanes that differ at |dt| = 0, exact ties between leaves, are counted
apart), and bit-equal to their per-ray arm (closest_bf8i_per_ray,
occluded_bf8i_per_ray) on every lane of the same sets.

Prints the kernels' JSON line (K1-K6, each with its per-ray arm's time
from the A/B, then one row per archive entry point, with the kernel it
runs and the workload it was timed on (A2, A8/A9: also the per-ray arm's
time on the same rays; A3-A6 their A/B at both bounces; A1, A7 and
A10 their per-ray arm's time and the A/B over the fine SBVH and the
Morton tree), then the
rows `rounds_of` and `done_rounds_of`, kernel "closest_bf8 (pops)", with
their per-ray arm's time), then the
`nvidia-smi` line, then as the last
line {"ok": true, "device": {...}}. Exits non-zero, with no result line,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chip_smoke_out"          # git-ignored

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# (non-tensor-core) rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f32 operations per unit of traversal work, counted from
# pt_torch/accel/csrc/rt_common.cuh: a slab test is 6 sub + 6 mul +
# 10 min/max + 3 compares; a Woop test is 18 (o') + 15 (d') + 2 (t) +
# 4 (u, v) + 1 (u+v) + 5 compares
OPS_PER_SLAB = 25
OPS_PER_WOOP = 45
# bytes of structure the function needs: per BF8 wide node its 8 child slots
# (lo, hi: 3 f32 each; entry: i32), per binary node its bounds, skip link and
# leaf id, per triangle W (9 f32), b (3 f32) and its id (i32). The page's
# second copy of W (rows 4-6), its padding and the BF8 leaf boxes (copies of
# the parent's child boxes) are not counted.
BYTES_PER_NODE = 8 * (12 + 12 + 4)
BYTES_PER_NODE_V4 = 12 + 12 + 4 + 4
BYTES_PER_TRI = (9 + 3 + 1) * 4
# a BF8V6 closest visit also reads its node's packed push order for the ray's
# octant (one i32); its leaf rows, like K1's leaf boxes, copy the parent's
# child boxes and are not counted. The ordered binary walk counts one box
# test per node tested (the root, and both children of each internal node
# whose box passed; not the pop retest), each reading a binary node as
# BYTES_PER_NODE_V4 (box, skip link, leaf id).
BYTES_PER_NODE_V6 = BYTES_PER_NODE + 4
# an instanced leaf visit reads two indices (page, segment) and maps the ray
# with the segment's 12 transform floats: 18 operations for o', 15 for d'
BYTES_PER_LEAF_INDEX = 2 * 4
BYTES_PER_SEG_XFORM = 12 * 4
OPS_PER_XFORM = 33

# phase 2's ptxas -v lines and the warp libraries' occupancy, re-printed
# beside the A/Bs
PTXAS = []
OCCUPANCY = {}

N_PARITY = 16384
BLOCKS = 2          # blocks of 3 timed render steps (the first is counted)
ANIM_FRAMES = 4     # counted animated frames, after one warm frame
N_CARDS = 2600      # alpha-tested quads of the alpha variants (5,200 tris)
N_INST = 64         # instances of the instanced scene
N_COURT = 4096      # parity rays per set over the Courtyard's trees
# Courtyard texture sizes: 1.0 is the authored 4k/2k/1k mix. 0.5 (2k/1k/512)
# keeps the scene's build and its pool's upload to seconds and the pool under
# the memory budget's size cap (times and cap are printed). The parity phase,
# where the textures do not matter, takes a twentieth.
COURT_TEX_SCALE = 0.5
COURT_TEX_SCALE_PARITY = 0.05

REPLACES = {
    "closest_bf8": "pt/accel/pallas_bvh.py:1427 packet_closest_bf8",
    "occluded_bf8": "pt/accel/pallas_bvh.py:1471 packet_occluded_bf8",
    "closest_v4": "pt/accel/pallas_bvh.py:1388 packet_closest_v4",
    "occluded_v4": "pt/accel/pallas_bvh.py:1512 packet_occluded_v4",
    "closest_bf8i": "pt/accel/instanced.py:811 packet_closest_bf8i",
    "occluded_bf8i": "pt/accel/instanced.py:858 packet_occluded_bf8i",
}
SOURCES = {
    "closest_bf8": "pt_torch/accel/csrc/bf8_warp_kernels.cu",
    "occluded_bf8": "pt_torch/accel/csrc/bf8_occluded_warp_kernels.cu",
    "closest_v4": "pt_torch/accel/csrc/v4_warp_kernels.cu",
    "occluded_v4": "pt_torch/accel/csrc/v4_warp_kernels.cu",
    "closest_bf8i": "pt_torch/accel/csrc/bf8i_warp_kernels.cu",
    "occluded_bf8i": "pt_torch/accel/csrc/bf8i_warp_kernels.cu",
}
KERNELS = tuple(REPLACES)
# K1's, K2's, the v6 walks' (A3-A6), K3-K6's and the ordered walk's first
# design,
# the per-ray arm of the A/B; it also carries their counted variant (the
# walk is the same)
PER_RAY = {"closest_bf8": "closest_bf8_per_ray",
           "occluded_bf8": "occluded_bf8_per_ray",
           "closest_v6": "closest_v6_per_ray",
           "occluded_v6": "occluded_v6_per_ray",
           "closest_v4": "closest_v4_per_ray",
           "occluded_v4": "occluded_v4_per_ray",
           "closest_bf8i": "closest_bf8i_per_ray",
           "occluded_bf8i": "occluded_bf8i_per_ray",
           "closest_ordered": "closest_ordered_per_ray",
           "closest_v6k2": "closest_v6k2_per_ray",
           "closest_v7": "closest_v7_per_ray"}
# the archive's entry points (pt/accel/pallas_bvh_archive.py), in pt's order
# A1-A10, each with the port's kernel that it runs
ARCHIVE = {
    "packet_closest_v3": (1763, "closest_ordered"),
    "packet_closest_bf8w": (1802, "closest_bf8"),
    "packet_closest_v6": (1854, "closest_v6"),
    "packet_closest_v6k2": (1893, "closest_v6k2"),
    "packet_closest_v7": (1933, "closest_v7"),
    "packet_occluded_v6": (1975, "occluded_v6"),
    "packet_closest": (2009, "closest_ordered"),
    "packet_occluded": (2039, "occluded_v4"),
    "packet_occluded_sub": (2063, "occluded_v4"),
    "packet_closest_sub": (2089, "closest_ordered"),
}
SOURCES.update(closest_ordered="pt_torch/accel/csrc/ordered_warp_kernels.cu",
               closest_v6="pt_torch/accel/csrc/bf8_warp_kernels.cu",
               closest_v6k2="pt_torch/accel/csrc/v6_warp_kernels.cu",
               closest_v7="pt_torch/accel/csrc/v6_warp_kernels.cu",
               occluded_v6="pt_torch/accel/csrc/"
                           "bf8_occluded_warp_kernels.cu")


def counted(kernels, name: str):
    """The wrapper that runs kernel `name`'s counted variant."""
    return getattr(kernels, PER_RAY.get(name, name))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ scenes


def port_namespace():
    """The scene-building names of `pt_torch` that `build_animated_scene`
    and `build_instanced_scene` use, as one namespace."""
    import types
    from pt_torch.core import camera
    from pt_torch.scene import builder, examples, graph
    from pt_torch.scene import types as stypes
    return types.SimpleNamespace(
        SceneBuilder=builder.SceneBuilder, InputCamera=camera.InputCamera,
        PointLight=stypes.PointLight,
        DirectionalLight=stypes.DirectionalLight,
        create_heightfield_scene=examples.create_heightfield_scene,
        Animation=graph.Animation, AnimationNode=graph.AnimationNode,
        KeySequence=graph.KeySequence, Geometry=stypes.Geometry,
        MeshInfo=stypes.MeshInfo,
        MetallicRoughnessMaterial=stypes.MetallicRoughnessMaterial,
        TextureInfo=stypes.TextureInfo, TextureType=stypes.TextureType)


def alpha_mask_texture(seed: int, size: int = 64) -> np.ndarray:
    """(size, size, 4) uint8 RGBA mask made from a seed: blocks of 8x8
    texels with α = 0.2 (skipped: decals), α = 0.7 (accepted, translucent to
    shadow rays) and α = 1 (opaque), a third each, over random colours."""
    rng = np.random.default_rng(seed)
    cells = size // 8
    levels = np.asarray([51, 178, 255], np.uint8)
    alpha = levels[rng.permutation(cells * cells) % 3].reshape(cells, cells)
    rgb = rng.integers(40, 256, (cells, cells, 3), dtype=np.uint8)
    mask = np.concatenate([rgb, alpha[..., None]], axis=-1)
    return np.repeat(np.repeat(mask, 8, axis=0), 8, axis=1)


def build_animated_scene(ns, n: int = 224, n_cards: int = 0,
                         animate: bool = True, seed: int = 7):
    """The Heightfield (n x n grid) built through `ns.SceneBuilder`, user
    code as an importer would write it. With `animate`, its instance node
    carries a keyframed rotation about y and a translation (24 ticks per
    second), so every `scene.update(1 / 24)` moves all of it. With
    `n_cards` > 0, that many alpha-tested quads (two triangles each) stand
    on the same node, textured with `alpha_mask_texture(seed)`. `ns` names
    the package's scene classes (see `port_namespace`)."""
    b = ns.SceneBuilder("Animated Heightfield" if animate
                        else "Static Heightfield")
    ns.create_heightfield_scene(b, n)
    node = len(b.node_parents) - 1
    if n_cards:
        rng = np.random.default_rng(seed)
        base = np.stack([rng.uniform(-8, 8, n_cards),
                         rng.uniform(0.3, 1.6, n_cards),
                         rng.uniform(-8, 8, n_cards)], axis=-1)
        yaw = rng.uniform(0, np.pi, n_cards)
        right = np.stack([np.cos(yaw), np.zeros(n_cards), np.sin(yaw)],
                         axis=-1) * rng.uniform(0.3, 0.6, (n_cards, 1))
        up = np.asarray([0.0, 1.0, 0.0]) * rng.uniform(0.5, 1.0, (n_cards, 1))
        corners = np.stack([base - right, base + right, base + right + up,
                            base - right + up], axis=1)        # (C, 4, 3)
        nrm = np.cross(right, up)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        uv = np.tile(np.asarray([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32),
                     (n_cards, 1, 1))
        quad = np.asarray([0, 1, 2, 2, 3, 0])
        idx = (np.arange(n_cards)[:, None] * 4 + quad[None]).ravel()
        vbase = b.add_vertices(corners.reshape(-1, 3), uv.reshape(-1, 2),
                               np.repeat(nrm, 4, axis=0))
        ibase = b.add_indices(idx)
        geo = b.add_geometry(ns.Geometry(vbase, 4 * n_cards, ibase, len(idx),
                                         is_opaque=False))
        tex = b.add_texture(ns.TextureInfo(
            "card mask", ns.TextureType.COLOR,
            pixels=alpha_mask_texture(seed), is_srgb=True))
        mat = b.add_material("cards", ns.MetallicRoughnessMaterial(
            color=(1.0, 1.0, 1.0, 1.0), roughness=0.8, color_idx=tex))
        b.models[-1].meshes.append(ns.MeshInfo(geo, mat))
    if animate:
        half = 0.25                       # half of a 0.5 rad turn about y
        b.add_animation(ns.Animation(nodes=[ns.AnimationNode(
            scene_node_index=node,
            positions=ns.KeySequence(
                ticks=np.asarray([0.0, 24.0, 48.0]),
                values=np.asarray([[0.0, 0.0, 0.0], [0.5, 0.2, 0.0],
                                   [0.0, 0.0, 0.0]])),
            rotations=ns.KeySequence(
                ticks=np.asarray([0.0, 24.0, 48.0]),
                values=np.asarray([[1.0, 0.0, 0.0, 0.0],
                                   [np.cos(half), 0.0, np.sin(half), 0.0],
                                   [1.0, 0.0, 0.0, 0.0]]),
                is_rotation=True),
            scales=ns.KeySequence(ticks=np.asarray([0.0]),
                                  values=np.asarray([[1.0, 1.0, 1.0]])))],
            ticks_per_second=24.0, duration=48.0))
    return b.create_scene()


def _wavy_grid(n: int):
    """An n x n wavy grid over [-1, 1]²: positions, normals, uvs and
    2 (n-1)² triangles."""
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gy = 0.25 * np.sin(gx * 5) * np.cos(gz * 4)
    pos = np.stack([gx, gy + 0.3, gz], -1).reshape(-1, 3)
    nrm = np.tile(np.asarray([0, 1, 0], np.float32), (len(pos), 1))
    uv = (pos[:, [0, 2]] + 1) * 0.5
    idx = np.arange(n * n).reshape(n, n)
    a, c = idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()
    b, d = idx[1:, :-1].ravel(), idx[:-1, 1:].ravel()
    tris = np.concatenate([np.stack([a, c, b], -1),
                           np.stack([c, a, d], -1)]).astype(np.int64)
    return pos.astype(np.float32), nrm, uv.astype(np.float32), tris


def build_instanced_scene(ns, n_inst: int = 64, grid_n: int = 56,
                          alpha: bool = False, seed: int = 3):
    """One wavy grid (2 (grid_n - 1)² triangles; 6,050 at the default)
    instanced `n_inst` times, each with its own scale (0.7 to 1.4), turn
    about y and height, over a ground slab; a point light, a sun and a
    camera that sees all of it. With `alpha`, every instance also carries a
    cross of two alpha-tested quads (a foliage card) with a leafy mask. The
    geometry is shared between the instances, so the flattened scene holds
    `n_inst` copies of it: 387,202 triangles at the defaults, the scene on
    which the "auto" policy selects the shared-BLAS structure. `ns` names
    the package's scene classes (see `port_namespace`)."""
    b = ns.SceneBuilder("Instanced Grids")
    rng = np.random.default_rng(seed)
    pos, nrm, uv, tris = _wavy_grid(grid_n)
    vb = b.add_vertices(pos, uv, nrm)
    ib = b.add_indices(tris.ravel().tolist())
    geo = b.add_geometry(ns.Geometry(vb, len(pos), ib, tris.size))
    mat = b.add_material("grid", ns.MetallicRoughnessMaterial(
        color=(0.75, 0.55, 0.35, 1.0), roughness=0.4, metalness=0.2))
    meshes = [ns.MeshInfo(geo, mat)]
    if alpha:
        yy, xx = np.mgrid[0:64, 0:64] / 63.0
        mask = ((np.sin(xx * 21) * np.cos(yy * 17) > -0.1)
                & (((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.23))
        leaf = np.ones((64, 64, 4), np.float32)
        leaf[..., 0] = 0.15
        leaf[..., 1] = 0.45
        leaf[..., 2] = 0.12
        leaf[..., 3] = mask.astype(np.float32)
        tex = b.add_texture(ns.TextureInfo(name="leafcard",
                                           type=ns.TextureType.COLOR,
                                           pixels=leaf, is_srgb=False))
        amat = b.add_material("leaf", ns.MetallicRoughnessMaterial(
            color=(1.0, 1.0, 1.0, 1.0), roughness=0.8, color_idx=tex))
        qp = np.asarray([[-0.6, 0.6, 0], [0.6, 0.6, 0],
                         [0.6, 1.8, 0], [-0.6, 1.8, 0],
                         [0, 0.6, -0.6], [0, 0.6, 0.6],
                         [0, 1.8, 0.6], [0, 1.8, -0.6]], np.float32)
        qn = np.tile(np.asarray([0, 0, 1], np.float32), (8, 1))
        quv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]] * 2, np.float32)
        avb = b.add_vertices(qp, quv, qn)
        aib = b.add_indices([0, 1, 2, 0, 2, 3, 4, 5, 6, 4, 6, 7])
        ageo = b.add_geometry(ns.Geometry(avb, 8, aib, 12, is_opaque=False))
        meshes.append(ns.MeshInfo(ageo, amat))
    grid_model = b.add_model(meshes)

    side = int(np.ceil(np.sqrt(n_inst)))
    ext = side * 3.0
    gpos = np.asarray([[-ext, 0, -ext], [ext, 0, -ext],
                       [ext, 0, ext], [-ext, 0, ext]], np.float32)
    gnrm = np.tile(np.asarray([0, 1, 0], np.float32), (4, 1))
    guv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    gvb = b.add_vertices(gpos, guv, gnrm)
    gib = b.add_indices([0, 2, 1, 2, 0, 3])
    ggeo = b.add_geometry(ns.Geometry(gvb, 4, gib, 6))
    gmat = b.add_material("ground", ns.MetallicRoughnessMaterial(
        color=(0.55, 0.58, 0.6, 1.0), roughness=0.85, metalness=0.0))
    ground_model = b.add_model([ns.MeshInfo(ggeo, gmat)])

    root = b.add_scene_node(0, np.eye(4))
    b.add_model_instance(ground_model, b.add_scene_node(root, np.eye(4)))
    for i in range(n_inst):
        gx = (i % side - (side - 1) / 2) * 2.6
        gz = (i // side - (side - 1) / 2) * 2.6
        s = rng.uniform(0.7, 1.4)
        ang = rng.uniform(0, 2 * np.pi)
        c, sn = np.cos(ang), np.sin(ang)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = s * np.asarray([[c, 0, sn], [0, 1, 0], [-sn, 0, c]],
                                   np.float32)
        m[:3, 3] = (gx, rng.uniform(0, 0.4), gz)
        b.add_model_instance(grid_model, b.add_scene_node(root, m))

    b.add_point_light(ns.PointLight(color=(600.0, 580.0, 540.0),
                                    position=(0.0, ext * 0.6, 0.0)))
    b.set_directional_light(ns.DirectionalLight(color=(2.5, 2.5, 2.3),
                                                direction=(0.3, 0.9, 0.2)))
    b.add_camera(ns.InputCamera(50.0, ext * 6, 0.05,
                                (0.0, ext * 0.5, -ext * 0.9),
                                (0.0, -0.45, 1.0)))
    return b.create_scene()


# ------------------------------------------------------------------ timing


def cuda_ms(fn, reps: int = 3, warm: bool = True) -> float:
    """Mean CUDA-event time of `fn()` over `reps` runs after one warm run
    (none with `warm=False`, for a plain version that takes many seconds).
    A ~20 ms device sleep is queued first, so the host has enqueued the
    launches before the first one starts: a short kernel is then timed
    without the host's per-call wrapper time between launches (a plain
    version that launches thousands of ops stays host-bound, as it is)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ phases


def phase_device():
    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {name} x{count}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"[device] nvidia-smi: {smi}")
    return name, count, smi.splitlines()[0]


def phase_build():
    from pt_torch.accel import kernels, native
    t0 = time.perf_counter()
    errors = []

    def build_native():
        try:
            native._load()
        except Exception as e:  # re-raised below on the main thread
            errors.append(e)
    th = threading.Thread(target=build_native)
    th.start()
    ptxas = kernels.build_kernels(ptxas_verbose=True)
    th.join()
    if errors:
        raise errors[0]
    log(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS)} + g++ SBVH library: "
        f"{time.perf_counter() - t0:.1f} s")
    PTXAS.extend(line.strip() for line in ptxas.splitlines() if line.strip())
    for line in PTXAS:
        log(f"[build] {line}")
    for lib, which in (("v4w", "K3/K4"), ("bf8iw", "K5/K6"),
                       ("bf8w", "K1/closest_v6"),
                       ("bf8wo", "K2/occluded_v6"),
                       ("ordw", "closest_ordered"),
                       ("v6w", "closest_v6k2/closest_v7")):
        occ = kernels.warp_occupancy(lib, "cuda")
        check(min(occ.values()) > 0,
              f"warp {which} occupancy query failed: {occ}")
        OCCUPANCY[lib] = occ
        log(f"[build] warp {which} (128 threads a block): {occ}")


def phase_sass(other):
    """With `other` (the root of another checkout of the repository, such
    as the parent commit unpacked beside this one), every kernel library's
    SASS against the other's build, kernel by kernel
    (`pt_torch.benches.sass_diff`); logged, not checked."""
    if other is None:
        log("[sass] no other checkout named (--sass-against): not compared")
        return
    from pt_torch.benches import sass_diff
    t0 = time.perf_counter()
    sass_diff.main(other, emit=lambda line: log(f"[sass] {line}"))
    log(f"[sass] against {other}: {time.perf_counter() - t0:.1f} s")


def _log_build_of(tag, lib, walk):
    """Re-print, beside an A/B, what ptxas said of the warp kernel whose
    mangled name holds `walk` (Bf8Walk: K1, V6Walk: closest_v6, Bf8AnyHit:
    K2, V6AnyHit: occluded_v6, TwoPops: closest_v6k2, LeafQueue:
    closest_v7), and the library's resident blocks per SM."""
    lines, on = [], False
    for line in PTXAS:
        if "Compiling entry function" in line:
            on = walk in line
        if on and ("Used" in line or "stack frame" in line):
            lines.append(line.replace("ptxas info    : ", ""))
    log(f"[{tag}] ptxas -v of the warp kernel ({walk}): "
        f"{'; '.join(lines)}; {OCCUPANCY[lib]}")


def _renderer(scene, width: int, spp: int, bounces: int, device: str,
              instancing: str = "auto"):
    """A Renderer on `device` for `scene` (an int n: the static Heightfield
    of that grid size)."""
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.renderer import Renderer
    from pt_torch.scene.examples import make_heightfield_scene
    r = Renderer(PathTracingSettings(sample_count=spp, bounce_count=bounces),
                 device=device, instancing=instancing)
    r.set_scene(make_heightfield_scene(scene) if isinstance(scene, int)
                else scene)
    r.on_resize(width, width)
    return r


def _step_frame(r) -> bool:
    """One animated frame up to the rebuild: advance the scene by 1/24 s and
    hand the change to the renderer. Returns whether anything moved."""
    changed = r.scene.update(1.0 / 24.0)
    r.update_scene_data(scene_changed=changed)
    return changed


class _Recorder:
    """Records the rays of every trace call of the integrator (for parity
    and timing on the real wavefronts). Calls go through unchanged."""

    def __init__(self):
        from pt_torch.render import integrator
        self.mod = integrator
        self.closest = []
        self.occluded = []

    def __enter__(self):
        m = self.mod
        self._orig = (m.trace_closest, m.trace_occluded)

        def closest(bvh, o, d, t):
            self.closest.append((o.clone(), d.clone(), t.clone()))
            return self._orig[0](bvh, o, d, t)

        def occluded(bvh, o, d, t):
            self.occluded.append((o.clone(), d.clone(), t.clone()))
            return self._orig[1](bvh, o, d, t)
        m.trace_closest, m.trace_occluded = closest, occluded
        return self

    def __exit__(self, *exc):
        self.mod.trace_closest, self.mod.trace_occluded = self._orig


def _sample_rows(arrays, k, rng, live=None):
    n = arrays[0].shape[0]
    pool = np.arange(n) if live is None else np.flatnonzero(live)
    idx = np.sort(rng.choice(pool, size=min(k, len(pool)), replace=False))
    import torch
    sel = torch.as_tensor(idx, device=arrays[0].device)
    return [a[sel].contiguous() for a in arrays]


def _compare_closest(bvh, o, d, t, what, name="closest_bf8"):
    from pt_torch.accel import kernels
    hk = getattr(kernels, name)(bvh, o, d, t)
    hp = getattr(kernels, name + "_plain")(bvh, o, d, t)
    same = hk.tri == hp.tri
    frac = float(same.float().mean())
    dt = (hk.t - hp.t).abs()[same]
    tol_t = 1e-5 * hp.t.abs().clamp(min=1.0)[same]
    du = (hk.u - hp.u).abs()[same]
    dv = (hk.v - hp.v).abs()[same]
    err = float(torch_max(dt))
    log(f"[parity] {name} {what}: {o.shape[0]} rays, ids agree {frac:.6f}, "
        f"hits {int((hp.tri >= 0).sum())}, max|dt| {err:.3e}, "
        f"max|du| {float(torch_max(du)):.3e}, "
        f"max|dv| {float(torch_max(dv)):.3e}")
    check(frac >= 0.999, f"{name} {what}: ids agree on {frac:.6f} < 0.999")
    check(bool((dt <= tol_t).all()),
          f"{name} {what}: |dt| above 1e-5*max(1,t)")
    check(bool((du <= 1e-4).all()) and bool((dv <= 1e-4).all()),
          f"{name} {what}: |du| or |dv| above 1e-4")
    return err


def _compare_occluded(bvh, o, d, dist, what, name="occluded_bf8", **kw):
    from pt_torch.accel import kernels
    ok_ = getattr(kernels, name)(bvh, o, d, dist, **kw)
    op = getattr(kernels, name + "_plain")(bvh, o, d, dist, **kw)
    diff = ok_ != op
    frac = 1.0 - float(diff.float().mean())
    flag = " opaque_only" if kw.get("opaque_only") else ""
    log(f"[parity] {name} {what}{flag}: "
        f"{o.shape[0]} rays, agree {frac:.6f}, occluded {int(op.sum())}")
    check(frac >= 0.999, f"{name} {what}: agree on {frac:.6f} < 0.999")
    return float(diff.any())


def torch_max(x):
    return x.max() if x.numel() else x.new_zeros(())


def phase_parity():
    import torch
    from pt_torch.accel import archive
    from pt_torch.accel.bvh8 import build_bf8, build_packet_bvh_sah
    t0 = time.perf_counter()
    r = _renderer(224, 512, 1, 2, "cuda")
    r._ensure_accel()
    bvh = r.accel.bvh
    log(f"[parity] Heightfield n=224: {r.ds.num_triangles} triangles, "
        f"{bvh.n_leaves} leaves of block {bvh.block}, {bvh.n8} BF8 nodes, "
        f"depth {bvh.depth}; accel build {time.perf_counter() - t0:.1f} s")
    with _Recorder() as rec:
        r.render(1)
    rng = np.random.default_rng(2024)
    b0 = _sample_rows(rec.closest[0], N_PARITY, rng)
    live1 = (rec.closest[1][2] > 1e-4).cpu().numpy()   # degenerate lanes: TMIN
    b1 = _sample_rows(rec.closest[1], N_PARITY, rng, live1)
    lo = r.accel.bvh.root_lo.cpu().numpy()
    hi = r.accel.bvh.root_hi.cpu().numpy()
    ro = rng.uniform(lo - 2.0, hi + 2.0, (N_PARITY, 3)).astype(np.float32)
    rd = rng.normal(size=(N_PARITY, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    rnd = [torch.as_tensor(ro, device="cuda"),
           torch.as_tensor(rd, device="cuda"),
           torch.full((N_PARITY,), 1e4, device="cuda")]
    errs = {"closest_bf8": 0.0, "occluded_bf8": 0.0}
    sets = (("bounce0", b0), ("bounce1", b1), ("random", rnd))
    for what, (o, d, t) in sets:
        errs["closest_bf8"] = max(errs["closest_bf8"],
                                  _compare_closest(bvh, o, d, t, what))
        _bf8_arms(bvh, (o, d, t), f"Heightfield, {what}", rng)
        dist = torch.as_tensor(rng.uniform(0.05, 20.0, o.shape[0])
                               .astype(np.float32), device="cuda")
        errs["occluded_bf8"] = max(errs["occluded_bf8"],
                                   _compare_occluded(bvh, o, d, dist, what))
    # opaque_only: every other triangle marked non-opaque
    wpos = r.accel.wpos.cpu().numpy()
    tri = r.ds.tri_idx.cpu().numpy()
    opq = (np.arange(tri.shape[0]) % 2) == 0
    half = build_bf8(build_packet_bvh_sah(wpos, tri, block=32,
                                          max_leaves=8192, tri_opaque_np=opq,
                                          spatial=True, device="cuda"))
    o, d, _ = rnd
    dist = torch.full((N_PARITY,), 1e4, device="cuda")
    for flag in (False, True):
        errs["occluded_bf8"] = max(errs["occluded_bf8"], _compare_occluded(
            half, o, d, dist, "random/half-alpha", opaque_only=flag))
    _bf8_arms(half, rnd, "Heightfield half-alpha tree, random", rng)
    # the BF8V6 of the same SBVH, on the same rays
    v6, _ = archive.swap_in_bf8_v6(r)
    for what, rays in sets:
        _bf8_arms(v6, rays, f"Heightfield BF8V6, {what}", rng)
    # the shadow wavefronts, over the three trees
    for what, rays in _shadow_sets(rec, N_PARITY, rng):
        for tree, name in ((bvh, "Heightfield"),
                           (half, "Heightfield half-alpha tree"),
                           (v6, "Heightfield BF8V6")):
            _bf8_occ_arms(tree, rays, f"{name}, {what}")
    torch.cuda.synchronize()
    log(f"[parity] K1/K2 and the v6 walks done in "
        f"{time.perf_counter() - t0:.1f} s")
    _parity_bf8_trees(rng)
    errs.update(_parity_v4(rng))
    errs.update(_parity_bf8i(rng))
    return errs


def _bits(h):
    """A Hit's fields with the floats as their int32 bits."""
    import torch
    return [a.view(torch.int32) if a.dtype == torch.float32 else a
            for a in h]


def _arms_equal(bvh, o, d, t, dist, what, pair=("closest_v4",
                                              "occluded_v4")):
    """The warp-cooperative kernels of `pair` (K3/K4, or K5/K6 each with
    raw_ids and opaque_only off and on) against the per-ray arm on one ray
    set: t, u and v bits and ids of every lane, and its occlusion bool,
    must be equal."""
    from pt_torch.accel import kernels
    closest, occluded = pair
    label = "K3/K4" if closest == "closest_v4" else "K5/K6"
    flags = ([({}, {})] if label == "K3/K4" else
             [({"raw_ids": f}, {"opaque_only": f}) for f in (False, True)])
    n_c = n_o = 0
    for kc, ko in flags:
        hw = getattr(kernels, closest)(bvh, o, d, t, **kc)
        hr = getattr(kernels, PER_RAY[closest])(bvh, o, d, t, **kc)
        differ = sum((a != b) for a, b in zip(_bits(hw), _bits(hr))) > 0
        ow = getattr(kernels, occluded)(bvh, o, d, dist, **ko)
        orr = getattr(kernels, PER_RAY[occluded])(bvh, o, d, dist, **ko)
        n_c += int(differ.sum())
        n_o += int((ow != orr).sum())
    log(f"[parity] warp {label} against the per-ray arm, {what}: "
        f"{o.shape[0]} rays{'' if len(flags) == 1 else ' x 2 flags'}, "
        f"{n_c} lanes differ in (t, tri, u, v) bits "
        f"({int((hr.tri >= 0).sum())} hits), {n_o} in occlusion "
        f"({int(orr.sum())} occluded)")
    check(n_c == 0 and n_o == 0, f"warp {label} {what}: {n_c} closest and "
          f"{n_o} occlusion lanes differ from the per-ray arm")


def _closest_arms(name, tree, rays, what, **kw):
    """The warp closest kernel `name` (closest_bf8 over a BF8BVH,
    closest_v6, closest_v6k2 or closest_v7 over a BF8V6, closest_ordered
    over a PacketBVH) against its per-ray arm and its plain warp schedule
    on one ray set, each with the keywords `kw` (closest_v7's window): the
    t, u and v bits and the id of every lane must be equal."""
    from pt_torch.accel import kernels
    hw = getattr(kernels, name)(tree, *rays, **kw)
    hr = getattr(kernels, PER_RAY[name])(tree, *rays, **kw)
    hp, sched = getattr(kernels, name + "_warp_plain")(tree, *rays, **kw)
    if kw:
        name += "".join(f" {k} {v}" for k, v in kw.items())
    n_r = int((sum((a != b) for a, b in zip(_bits(hw), _bits(hr))) > 0)
              .sum())
    n_p = int((sum((a != b) for a, b in zip(_bits(hw), _bits(hp))) > 0)
              .sum())
    log(f"[parity] warp {name} against the per-ray arm, {what}: "
        f"{rays[0].shape[0]} rays, {n_r} lanes differ in (t, tri, u, v) "
        f"bits ({int((hr.tri >= 0).sum())} hits), {n_p} from the plain "
        f"schedule (block {tree.block}, "
        f"{sched.leaf_visits / max(sched.groups, 1):.2f} lanes per group, "
        f"warp steps {sched.warp_tests} for {sched.ray_chunk_tests} "
        f"ray-chunk tests)")
    check(n_r == 0 and n_p == 0, f"warp {name} {what}: {n_r} lanes differ "
          f"from the per-ray arm, {n_p} from the plain schedule")


def _bf8_arms(tree, rays, what, rng):
    """`_closest_arms` of the warp K1 (over a BF8BVH) or closest_v6,
    closest_v6k2 and closest_v7 at windows 1 and 8 (over a BF8V6); then
    the occlusion twins (`_bf8_occ_arms`) on the same rays up to seeded
    distances."""
    import torch
    if hasattr(tree, "c_order"):
        _closest_arms("closest_v6", tree, rays, what)
        _closest_arms("closest_v6k2", tree, rays, what)
        for window in (1, 8):
            _closest_arms("closest_v7", tree, rays, what, window=window)
    else:
        _closest_arms("closest_bf8", tree, rays, what)
    o = rays[0]
    dist = torch.as_tensor(rng.uniform(0.05, 20.0, o.shape[0])
                           .astype(np.float32), device=o.device)
    _bf8_occ_arms(tree, (o, rays[1], dist), what)


def _bf8_occ_arms(tree, rays, what):
    """The warp K2 (over a BF8BVH, opaque_only off and on) or occluded_v6
    (over a BF8V6) against its per-ray arm and its plain warp schedule on
    one ray set (origins, directions, distances): the bool of every lane
    must be equal."""
    from pt_torch.accel import kernels
    v6 = hasattr(tree, "c_order")
    name = "occluded_v6" if v6 else "occluded_bf8"
    for kw in ({},) if v6 else ({}, {"opaque_only": True}):
        ow = getattr(kernels, name)(tree, *rays, **kw)
        orr = getattr(kernels, PER_RAY[name])(tree, *rays, **kw)
        op, sched = getattr(kernels, name + "_warp_plain")(tree, *rays, **kw)
        n_r, n_p = int((ow != orr).sum()), int((ow != op).sum())
        log(f"[parity] warp {name} against the per-ray arm, {what}"
            f"{' opaque_only' if kw else ''}: {rays[0].shape[0]} rays, "
            f"{n_r} lanes differ ({int(orr.sum())} occluded), {n_p} from "
            f"the plain schedule (block {tree.block}, "
            f"{sched.leaf_visits / max(sched.groups, 1):.2f} lanes per "
            f"group, {sched.chunk_loads} chunks staged for "
            f"{sched.groups * (tree.block // 32)} in the groups' leaves)")
        check(n_r == 0 and n_p == 0, f"warp {name} {what} {kw}: {n_r} lanes "
              f"differ from the per-ray arm, {n_p} from the plain schedule")


def _shadow_sets(rec, k, rng):
    """k-ray samples of the first and last recorded shadow wavefronts, as
    the integrator sends them (killed lanes included)."""
    last = len(rec.occluded) - 1
    check(last > 0, f"{len(rec.occluded)} shadow traces recorded")
    return [(f"shadow rays of bounce {b}", _sample_rows(rec.occluded[b], k,
                                                        rng))
            for b in (0, last)]


def _parity_bf8_trees(rng):
    """The warp K1 and closest_v6 bit-equal to their per-ray arms over the
    other BF8 and BF8V6 trees the static paths build: the Courtyard at
    detail 1.0 ("auto": the flat tree and its opaque and alpha subset
    trees, and the BF8V6 of its SBVH where pt's 640 KiB cap on the unified
    table admits one), the 64 instances flattened, opaque
    and with alpha cards (and the cards' subset trees), and the static
    alpha variant's three trees; on N_COURT-ray sets of real wavefronts
    (bounce 0 and bounce 1) and of random rays."""
    import torch
    from pt_torch.accel import archive
    from pt_torch.accel.bvh8 import build_packet_bvh_sah
    from pt_torch.scene.standin import make_courtyard_scene
    t0 = time.perf_counter()
    ns = port_namespace()
    # (what, scene, instancing, closest traces per bounce: 1, or 9 with the
    # alpha loops of a split scene)
    cases = (("Courtyard 1.0",
              lambda: make_courtyard_scene(1.0, COURT_TEX_SCALE_PARITY),
              "auto", 9),
             ("64 instances flattened",
              lambda: build_instanced_scene(ns, N_INST), "flatten", 1),
             ("64 instances + cards flattened",
              lambda: build_instanced_scene(ns, N_INST, alpha=True),
              "flatten", 9),
             ("static alpha variant",
              lambda: build_animated_scene(ns, 224, N_CARDS, animate=False),
              "auto", 9))
    for what, make, mode, per in cases:
        r = _renderer(make(), 512, 1, 2, "cuda", mode)
        r._ensure_accel()
        trees = [("full", r.accel.bvh)]
        sp = r.accel.alpha_split
        if sp is not None:
            trees += [("opaque", sp.bvh_opaque), ("alpha", sp.bvh_alpha)]
        check(len(trees) == (3 if per == 9 else 1)
              and all(type(t).__name__ == "BF8BVH" for _, t in trees),
              f"{what}: trees {[type(t).__name__ for _, t in trees]}")
        if what.startswith("Courtyard"):
            v6 = archive.build_bf8_v6(build_packet_bvh_sah(
                r.accel.wpos.cpu().numpy(), r.ds.tri_idx.cpu().numpy(),
                block=32, max_leaves=8192,
                tri_opaque_np=r.ds.tri_opaque.cpu().numpy(), spatial=True,
                device=r.device))
            if v6 is None:          # pt's 640 KiB cap on the unified table
                log(f"[parity] {what}: no BF8V6 fits (build_bf8_v6 gives "
                    "None), none checked")
            else:
                trees.append(("BF8V6", v6))
        log(f"[parity] {what}: {r.ds.num_triangles} triangles; "
            + "; ".join(f"{name} tree {t.n_leaves} leaves of block "
                        f"{t.block}, depth {t.depth}" for name, t in trees))
        with _Recorder() as rec:
            r.render(1)
        live1 = (rec.closest[per][2] > 1e-4).cpu().numpy()
        b0 = _sample_rows(rec.closest[0], N_COURT, rng)
        b1 = _sample_rows(rec.closest[per], N_COURT, rng, live1)
        shadow = _shadow_sets(rec, N_COURT, rng)
        for name, tree in trees:
            for set_name, rays in (("bounce0", b0), ("bounce1", b1),
                                   ("random", _random_rays(tree, N_COURT,
                                                           rng))):
                _bf8_arms(tree, rays, f"{what} {name} tree, {set_name}",
                          rng)
            for set_name, rays in shadow:
                _bf8_occ_arms(tree, rays, f"{what} {name} tree, {set_name}")
        del r, rec
    torch.cuda.synchronize()
    log(f"[parity] warp K1/K2 and v6 walks over the other static trees "
        f"done in {time.perf_counter() - t0:.1f} s")


def _parity_v4(rng):
    """K3/K4 against their plain versions over the Morton tree of the
    Animated Heightfield's second frame, on real wavefronts; the warp
    kernels (K3/K4 and closest_ordered) against their per-ray arm bit for
    bit on the same sets (closest_ordered also against its plain warp
    schedule), over that tree, the Morton tree of the same triangles at
    block 128 and two static SAH trees (the fallback at the default block,
    and one at block >= 512 whose pages are staged in 16 or more
    chunks)."""
    import torch
    from pt_torch.accel.bvh8 import build_packet_bvh, build_packet_bvh_sah
    t0 = time.perf_counter()
    scene = build_animated_scene(port_namespace(), 224)
    r = _renderer(scene, 512, 1, 3, "cuda")
    _step_frame(r)
    _step_frame(r)
    with _Recorder() as rec:
        r.render(1)
    bvh = r.accel.bvh
    check(type(bvh).__name__ == "PacketBVH", "animated scene: no PacketBVH")
    log(f"[parity] Animated Heightfield n=224: {r.ds.num_triangles} "
        f"triangles, {bvh.pages.shape[0]} leaves of block {bvh.block}, "
        f"{bvh.n_top} top nodes")
    live2 = (rec.closest[2][2] > 1e-4).cpu().numpy()
    check(0 < (~live2).sum(), "bounce 2 has no killed lanes")
    sets = (("bounce0", _sample_rows(rec.closest[0], N_PARITY, rng)),
            ("bounce2", _sample_rows(rec.closest[2], N_PARITY, rng, live2)),
            ("bounce2 with killed lanes",
             _sample_rows(rec.closest[2], N_PARITY, rng)),
            ("random", _random_rays(bvh, N_PARITY, rng)))
    dists = [torch.as_tensor(rng.uniform(0.05, 20.0, o.shape[0])
                             .astype(np.float32), device="cuda")
             for _, (o, _, _) in sets]
    shadow = [(f"shadow rays of bounce {b}",
               _sample_rows(rec.occluded[b], N_PARITY, rng)) for b in (0, 2)]
    wpos, tri = r.accel.wpos, r.ds.tri_idx
    opq = r.ds.tri_opaque.cpu().numpy()
    t1 = time.perf_counter()
    trees = [("Morton tree", bvh),
             ("Morton tree at block 128",
              build_packet_bvh(wpos, tri, block=128,
                               tri_opaque=r.ds.tri_opaque)),
             ("static SAH fallback",
              build_packet_bvh_sah(wpos.cpu().numpy(), tri.cpu().numpy(),
                                   tri_opaque_np=opq, spatial=True,
                                   device="cuda")),
             ("static SAH at 256 leaves",
              build_packet_bvh_sah(wpos.cpu().numpy(), tri.cpu().numpy(),
                                   tri_opaque_np=opq, spatial=True,
                                   max_leaves=256, device="cuda"))]
    log(f"[parity] trees for the warp kernels: "
        + "; ".join(f"{name}: block {tr.block}, {tr.pages.shape[0]} leaves, "
                    f"{tr.n_top} nodes" for name, tr in trees)
        + f" ({time.perf_counter() - t1:.1f} s to build the three more)")
    check([tr.block for _, tr in trees[:2]] == [64, 128]
          and trees[3][1].block >= 512, "the trees' blocks are not 64, 128 "
          "and >= 512")
    errs = {"closest_v4": 0.0, "occluded_v4": 0.0}
    for name, tree in trees:
        tag = "" if tree is bvh else f"{name}, "
        for (what, (o, d, t)), dist in zip(sets, dists):
            _arms_equal(tree, o, d, t, dist, tag + what)
            _closest_arms("closest_ordered", tree, (o, d, t),
                          f"{name} (depth {tree.depth}), {what}")
            errs["closest_v4"] = max(errs["closest_v4"], _compare_closest(
                tree, o, d, t, tag + what, name="closest_v4"))
            errs["occluded_v4"] = max(errs["occluded_v4"], _compare_occluded(
                tree, o, d, dist, tag + what, name="occluded_v4"))
        # the shadow wavefronts as the integrator sends them (killed lanes
        # too)
        for what, (o, d, t) in shadow:
            _arms_equal(tree, o, d, t, t, tag + what)
            errs["occluded_v4"] = max(errs["occluded_v4"], _compare_occluded(
                tree, o, d, t, tag + what, name="occluded_v4"))
    torch.cuda.synchronize()
    log(f"[parity] K3/K4 and closest_ordered done in "
        f"{time.perf_counter() - t0:.1f} s")
    return errs


def _compare_bf8i(bvh, o, d, t, what, errs, rng):
    """K5 (plain and raw ids) and K6 (all and opaque only) against their
    plain versions on one ray set, and bit-equal to their per-ray arm. A
    lane whose ids differ from the plain version's at |dt| = 0 is an exact
    tie between two leaves (the kernel's leaf-box retest `tnear < best_t`
    may cull the second leaf before the smaller id is seen): counted apart.
    Any other differing lane is a hit at the rim of a leaf box that the
    walk's slab test and the plain version's exhaustive test decide
    differently; both kinds together may be at most 1 lane in 1000. Where
    the ids agree, t, u and v must be bit-equal."""
    import torch
    from pt_torch.accel import kernels
    n = o.shape[0]
    for raw in (False, True):
        hk = kernels.closest_bf8i(bvh, o, d, t, raw_ids=raw)
        hp = kernels.closest_bf8i_plain(bvh, o, d, t, raw_ids=raw)
        differ = hk.tri != hp.tri
        ties = differ & (hk.t == hp.t)
        same = ~differ
        dt = (hk.t - hp.t).abs()[same]
        du = (hk.u - hp.u).abs()[same]
        dv = (hk.v - hp.v).abs()[same]
        err = float(torch_max(dt))
        log(f"[parity] closest_bf8i {what}{' raw_ids' if raw else ''}: {n} "
            f"rays, hits {int((hp.tri >= 0).sum())}, ids differ on "
            f"{int(differ.sum())} lanes, {int(ties.sum())} of them ties at "
            f"|dt| = 0; where ids agree max|dt| {err:.3e}, max|du| "
            f"{float(torch_max(du)):.3e}, max|dv| {float(torch_max(dv)):.3e}")
        check(int(differ.sum()) <= max(1, n // 1000),
              f"closest_bf8i {what}: ids differ on {int(differ.sum())} lanes")
        check(err == 0.0 and float(torch_max(du)) == 0.0
              and float(torch_max(dv)) == 0.0,
              f"closest_bf8i {what}: t, u or v differ from the plain version")
        errs["closest_bf8i"] = max(errs["closest_bf8i"], err)
    dist = torch.as_tensor(rng.uniform(0.05, 30.0, n).astype(np.float32),
                           device="cuda")
    for flag in (False, True):
        errs["occluded_bf8i"] = max(errs["occluded_bf8i"], _compare_occluded(
            bvh, o, d, dist, what, name="occluded_bf8i", opaque_only=flag))
    _arms_equal(bvh, o, d, t, dist, what, ("closest_bf8i", "occluded_bf8i"))


def _random_rays(bvh, n, rng):
    import torch
    lo, hi = bvh.root_lo.cpu().numpy(), bvh.root_hi.cpu().numpy()
    ro = rng.uniform(lo - 2.0, hi + 2.0, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return [torch.as_tensor(ro, device="cuda"),
            torch.as_tensor(rd, device="cuda"),
            torch.full((n,), 1e4, device="cuda")]


def _describe_instanced(bvh) -> str:
    return (f"n8={bvh.n8}, {bvh.n_leaves} leaves, {bvh.n_segs} segments, "
            f"block {bvh.block}, leaf_retest={bvh.leaf_retest}, "
            f"{bvh.pages.shape[0]} shared pages, depth {bvh.depth}")


def courtyard_renderer(detail: float, instancing: str, spp: int,
                       tex_scale: float):
    """(Renderer on the card, seconds to make the scene, to flatten it and
    build its texture pool, to build its accel) for the Courtyard at
    `detail` and `tex_scale`, 512², 5 bounces."""
    import torch
    from pt_torch.scene.standin import make_courtyard_scene
    t0 = time.perf_counter()
    scene = make_courtyard_scene(detail, tex_scale)
    t1 = time.perf_counter()
    r = _renderer(scene, 512, spp, 5, "cuda", instancing)
    t2 = time.perf_counter()
    r._ensure_accel()
    torch.cuda.synchronize()
    return r, t1 - t0, t2 - t1, time.perf_counter() - t2


def _parity_bf8i(rng):
    """K5/K6 against their plain versions and bit-equal to their per-ray
    arm: over the 64-instance tree that "auto" selects, and over the three
    trees of the Courtyard at detail 0.85 with instancing="shared" (both
    `leaf_retest` values, the alpha bit, the 2-page alpha tree), on real
    wavefronts and random rays."""
    import torch
    t0 = time.perf_counter()
    errs = {"closest_bf8i": 0.0, "occluded_bf8i": 0.0}
    r = _renderer(build_instanced_scene(port_namespace(), N_INST), 512, 1, 2,
                  "cuda")
    r._ensure_accel()
    bvh = r.accel.bvh
    check(type(bvh).__name__ == "BF8Instanced",
          f"64-instance scene: auto selected {type(bvh).__name__}")
    log(f"[parity] {N_INST}-instance scene: {r.ds.num_triangles} flattened "
        f"triangles; BF8Instanced {_describe_instanced(bvh)}")
    with _Recorder() as rec:
        r.render(1)
    live1 = (rec.closest[1][2] > 1e-4).cpu().numpy()
    for what, rays in (("64 instances, bounce0",
                        _sample_rows(rec.closest[0], N_PARITY, rng)),
                       ("64 instances, bounce1",
                        _sample_rows(rec.closest[1], N_PARITY, rng, live1)),
                       ("64 instances, random",
                        _random_rays(bvh, N_PARITY, rng))):
        _compare_bf8i(bvh, *rays, what, errs, rng)
    del r
    r, scene_s, upload_s, build_s = courtyard_renderer(
        0.85, "shared", 1, COURT_TEX_SCALE_PARITY)
    sp = r.accel.alpha_split
    check(sp is not None, "Courtyard 0.85 shared: no split trees")
    trees = (("full", r.accel.bvh), ("opaque", sp.bvh_opaque),
             ("alpha", sp.bvh_alpha))
    for name, tree in trees:
        check(type(tree).__name__ == "BF8Instanced",
              f"Courtyard 0.85 shared: {name} tree is {type(tree).__name__}")
        log(f"[parity] Courtyard 0.85 {name} tree: "
            f"{_describe_instanced(tree)}")
    check([t.n_segs for _, t in trees] == [985, 145, 840]
          and [t.leaf_retest for _, t in trees] == [False, True, True]
          and sp.bvh_alpha.pages.shape[0] == 2,
          "Courtyard 0.85: the trees are not the ones expected")
    with _Recorder() as rec:
        r.render(1)
    # per bounce 9 closest traces (1 opaque + 4 alpha, then 4 alpha for the
    # shadow rays): [0] holds the primary rays, [9] bounce 1's
    live1 = (rec.closest[9][2] > 1e-4).cpu().numpy()
    for name, tree in trees:
        for what, rays in (("bounce0",
                            _sample_rows(rec.closest[0], N_COURT, rng)),
                           ("bounce1", _sample_rows(rec.closest[9], N_COURT,
                                                    rng, live1)),
                           ("random", _random_rays(tree, N_COURT, rng))):
            _compare_bf8i(tree, *rays, f"Courtyard {name} tree, {what}",
                          errs, rng)
    torch.cuda.synchronize()
    log(f"[parity] K5/K6 done in {time.perf_counter() - t0:.1f} s (Courtyard "
        f"0.85: scene {scene_s:.1f} s, flatten + textures {upload_s:.1f} s, "
        f"three instanced trees {build_s:.1f} s)")
    return errs


def _bound(n, out_bytes, counts, bvh=None, node_bytes=None):
    """Least time for the launch, from what this launch's rays touched: the
    bytes (rays read once, results written once, and each wide node and
    triangle that any ray visited read once, a node as `node_bytes` where
    given; for an instanced structure `bvh` also the index pair of each leaf
    visited and the transform of each segment reached) over the HBM rate vs
    the counted f32 operations over the f32 rate."""
    totals = [int(c) for c in counts.totals.tolist()]
    nodes_seen = int(counts.node_seen.sum())
    tris_seen = int(counts.tri_seen.sum())
    extra_bytes = extra_ops = 0
    if len(totals) == 4:        # instanced BF8: as BF8, plus per leaf visit
        # the two indices and the ray's map into the segment's space
        nodes, leaf_boxes, leaf_visits, tris = totals
        slabs, per_node = 8 * nodes + leaf_boxes, BYTES_PER_NODE
        seen = counts.leaf_seen.bool()
        segs_seen = int(bvh.leaf_seg[seen].unique().numel())
        extra_bytes = (int(seen.sum()) * BYTES_PER_LEAF_INDEX
                       + segs_seen * BYTES_PER_SEG_XFORM)
        extra_ops = leaf_visits * OPS_PER_XFORM
    elif len(totals) == 3:      # BF8: 8 child slabs a visit + leaf retests
        nodes, leaf_boxes, tris = totals
        slabs, per_node = 8 * nodes + leaf_boxes, BYTES_PER_NODE
    else:                       # binary tree: one slab a counted node
        nodes, tris = totals
        slabs, per_node = nodes, BYTES_PER_NODE_V4
    nbytes = (n * (12 + 12 + 4) + n * out_bytes + extra_bytes
              + nodes_seen * (node_bytes or per_node)
              + tris_seen * BYTES_PER_TRI)
    ops = slabs * OPS_PER_SLAB + tris * OPS_PER_WOOP + extra_ops
    return dict(**_bound_of(nbytes, ops), node_visits=nodes, tri_tests=tris,
                nodes_seen=nodes_seen, tris_seen=tris_seen)


def _bound_of(nbytes, ops):
    """The larger of `nbytes` over the HBM rate and `ops` over the f32
    rate, in ms."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_ops=ops)


def _least_bound(results, what):
    """Several walks that computed one function on the same rays over the
    same leaves: each result's bound becomes that of the least work any of
    them did (the least bytes and the least operations, each from its own
    counted launch), since the function needs no more. The walk's own
    bound stays as `own_bound_ms`."""
    least = _bound_of(min(r["bound_bytes"] for r in results.values()),
                      min(r["bound_ops"] for r in results.values()))
    for res in results.values():
        res.setdefault("own_bound_ms", res["bound_ms"])
        res.update(least)
    log(f"[archive] bound on {what}: {least['bound_ms']:.5f} ms by "
        f"{least['bound_by']} ({least['bound_bytes']} bytes, "
        f"{least['bound_ops']} operations: the least of "
        + ", ".join(f"{k} {r['own_bound_ms']:.5f} ms"
                    for k, r in results.items()) + ")")


def _time_kernel(name, bvh, args, plain=True):
    """Time kernel `name` and (with `plain`) its plain version on one
    recorded wavefront, at the shape the main path gave it, work out the
    launch's bound from a counted launch, and hold the two results against
    each other."""
    import torch
    from pt_torch.accel import kernels
    k_fn = getattr(kernels, name)
    p_fn = getattr(kernels, name + "_plain")
    counts = kernels.work_counts(bvh)
    counted(kernels, name)(bvh, *args, counts=counts)
    n = args[0].shape[0]
    bound = _bound(n, 16 if name.startswith("closest") else 1, counts, bvh)
    out = {}
    ms = cuda_ms(lambda: out.update(k=k_fn(bvh, *args)), reps=5)
    if not plain:
        return dict(ms=ms, n=n, **bound)
    # the instanced plain versions take tens of seconds at this width: one
    # run, not warmed
    plain_ms = cuda_ms(lambda: out.update(p=p_fn(bvh, *args)), reps=1,
                       warm=not name.endswith("bf8i"))
    if name.startswith("closest"):
        differ = int((out["k"].tri != out["p"].tri).sum())
        same = out["k"].tri == out["p"].tri
        err = float(torch_max((out["k"].t - out["p"].t).abs()[same]))
    else:
        differ = int((out["k"] != out["p"]).sum())
        err = float(differ > 0)
    check(differ <= n // 1000,
          f"{name}: {differ} of {n} lanes differ from the plain version")
    return dict(ms=ms, plain_ms=plain_ms, n=n, differ=differ, err=err,
                **bound)


def _profile(fn, what: str, top: int = 12) -> None:
    """Where the time of `fn()` goes: torch.profiler over one call — device
    kernel time by name, kernel launches, and the device busy share (summed
    kernel time over the host wall clock of the profiled call; the
    profiler's own host overhead makes this a lower bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        # device-side kernel events only (CPU op events carry the same
        # device time again, attributed to the op that launched it)
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    busy_ms = sum(ms for ms, _, _ in rows)
    launches = sum(n for _, n, _ in rows)
    if not rows:
        log("[profile] torch.profiler recorded no device time")
        return
    log(f"[profile] {what}: wall {wall_ms:.1f} ms under the profiler, "
        f"device kernel time {busy_ms:.1f} ms (busy share "
        f"{busy_ms / wall_ms:.3f}), {launches} device kernels")
    for ms, n, key in sorted(rows, reverse=True)[:top]:
        log(f"[profile]   {ms:8.3f} ms  x{n:<5d} {key[:90]}")


def phase_main():
    import torch
    from pt_torch.accel import kernels
    from pt_torch.out.saver import write_image
    from pt_torch.post.pipeline import postprocess
    t0 = time.perf_counter()
    r = _renderer(224, 512, 4, 5, "cuda")
    r.render()                                        # warm render
    torch.cuda.synchronize()
    log(f"[main] warm render (accel build included): "
        f"{time.perf_counter() - t0:.1f} s")
    rays0 = r.rays_traced
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    for _ in range(3):
        r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = {k: kernels.launches[k] for k in ("closest_bf8", "occluded_bf8")}
    other = {k: v for k, v in kernels.launches.items()
             if v and k not in counts}
    rays = r.rays_traced - rays0
    peak = torch.cuda.max_memory_allocated() / 2**20
    film = r.film_mean()
    check(film.shape == (512, 512, 3), f"film shape {film.shape}")
    check(bool(np.isfinite(film).all()), "film has non-finite values")
    check(float(np.abs(film).max()) > 0.0, "film is all zero")
    for k, v in counts.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
    check(not other, f"other kernels ran on the main path: {other}")
    log(f"[main] Heightfield n=224, 512x512, 5 bounces, 4 spp: "
        f"{dt / 3 * 1e3:.1f} ms per render step, {rays / dt / 1e6:.3f} "
        f"useful Mrays/s ({rays} rays in 3 steps), peak memory "
        f"{peak:.0f} MiB, launches {counts}, film mean "
        f"{float(film.mean()):.5f}")
    # the spread of the step time within this call: more blocks of 3 steps
    blocks = [dt / 3 * 1e3]
    for _ in range(BLOCKS - 1):
        t1 = time.perf_counter()
        for _ in range(3):
            r.render()
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t1) / 3 * 1e3)
    log(f"[main] ms per render step in {BLOCKS} blocks of 3 steps: "
        f"{', '.join(f'{b:.1f}' for b in blocks)} (min {min(blocks):.1f}, "
        f"max {max(blocks):.1f})")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    png = OUT_DIR / "heightfield_512.png"
    image = postprocess(r.accum, float(r.total_samples), r.post)
    write_image(str(png), image.cpu().numpy())
    check(png.stat().st_size > 1000, "PNG not written")
    log(f"[main] wrote {png.relative_to(ROOT)} ({png.stat().st_size} bytes)")

    _profile(lambda: r.render(1),
             "static, one sample (5 bounces, 262144 lanes)")

    with _Recorder() as rec:
        r.render(1)
    times = _kernel_times(r, (("closest_bf8", "closest"),
                              ("occluded_bf8", "occluded")), "main", rec)
    _ab_bounces(r.accel.bvh, rec, times, (("closest_bf8", "closest"),
                                          ("occluded_bf8", "occluded")),
                "main")
    _log_build_of("main", "bf8w", "Bf8Walk")
    _log_build_of("main", "bf8wo", "Bf8AnyHit")
    return counts, times, dict(ms_per_step=dt / 3 * 1e3,
                               mrays=rays / dt / 1e6, peak_mib=peak,
                               ms_per_step_blocks=blocks)


def _kernel_times(r, pairs, tag, rec=None):
    """CUDA-event time, plain time and bound of each (kernel name, recorded
    calls) pair on the bounce-0 and bounce-2 wavefronts of one more sample
    (outside any counted run), or of the recorded sample `rec`."""
    if rec is None:
        with _Recorder() as rec:
            r.render(1)
    bvh = r.accel.bvh
    times = {}
    for name, which in pairs:
        calls = getattr(rec, which)
        for b in (0, 2):
            tm = _time_kernel(name, bvh, calls[b])
            times[(name, b)] = tm
            log(f"[{tag}] {name} bounce {b}: {tm['n']} lanes, "
                f"{tm['ms']:.3f} ms (plain {tm['plain_ms']:.1f} ms), bound "
                f"{tm['bound_ms']:.5f} ms by {tm['bound_by']} "
                f"({tm['bound_bytes']} bytes); {tm['node_visits']} node "
                f"visits, {tm['tri_tests']} triangle tests; "
                f"{tm['nodes_seen']} distinct nodes, {tm['tris_seen']} "
                f"distinct triangles; {tm['differ']} lanes differ from the "
                f"plain version, max|dt| {tm['err']:.3e}")
    return times


def _tree_signature(bvh):
    """(root lo, root hi, checksum of the pages' W rows) of a structure, on
    the host. The b rows are left out: padding columns hold 1e30 there."""
    return (bvh.root_lo.cpu().numpy().copy(), bvh.root_hi.cpu().numpy().copy(),
            float(bvh.pages[:, :3, :3 * bvh.block].double().abs().sum()))


def phase_animated():
    """The animated frame loop at full width: scene.update → update_scene_data
    → rebuild → render, ANIM_FRAMES counted frames after one warm frame."""
    import torch
    from pt_torch.accel import kernels
    from pt_torch.out.saver import write_image
    t0 = time.perf_counter()
    scene = build_animated_scene(port_namespace(), 224)
    check(scene.has_animated_instances, "the scene is not animated")
    r = _renderer(scene, 512, 4, 5, "cuda")
    check(_step_frame(r), "scene.update reported no change")
    r.render()                                        # warm frame
    torch.cuda.synchronize()
    log(f"[anim] Animated Heightfield n=224: {r.ds.num_triangles} triangles; "
        f"warm frame {time.perf_counter() - t0:.1f} s")
    sig = _tree_signature(r.accel.bvh)
    frames = []
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_all = time.perf_counter()
    for f in range(ANIM_FRAMES):
        th = time.perf_counter()
        check(_step_frame(r), "scene.update reported no change")
        host_ms = (time.perf_counter() - th) * 1e3
        check(r.total_samples == 0 and float(r.accum.abs().sum()) == 0.0,
              "the film was not reset by the scene change")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # from the second counted frame on nothing in the rebuild may wait
        # for the card (the first uploads nothing new either, but leaves the
        # allocator free to grow)
        if f > 0:
            torch.cuda.set_sync_debug_mode("error")
        start.record()
        r._ensure_accel()
        end.record()
        torch.cuda.set_sync_debug_mode("default")
        t1 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        render_ms = (time.perf_counter() - t1) * 1e3
        rays = r.rays_traced
        check(r.total_samples == 4, f"frame {f}: {r.total_samples} samples")
        new_sig = _tree_signature(r.accel.bvh)
        moved = (not np.array_equal(sig[0], new_sig[0])
                 or not np.array_equal(sig[1], new_sig[1]))
        check(moved and sig[2] != new_sig[2],
              f"frame {f}: the tree did not change")
        sig = new_sig
        frames.append(dict(update_host_ms=host_ms,
                           rebuild_ms=start.elapsed_time(end),
                           render_ms=render_ms, rays=rays,
                           mrays=rays / render_ms / 1e3))
        log(f"[anim] frame {f}: update_seg_transforms (host) "
            f"{host_ms:.2f} ms, rebuild {frames[-1]['rebuild_ms']:.3f} ms, "
            f"render step {render_ms:.1f} ms, {rays} rays, "
            f"{frames[-1]['mrays']:.3f} useful Mrays/s, root hi "
            f"{new_sig[1].round(3).tolist()}")
    wall = time.perf_counter() - t_all
    counts = {k: kernels.launches[k] for k in ("closest_v4", "occluded_v4")}
    other = {k: v for k, v in kernels.launches.items() if k not in counts}
    peak = torch.cuda.max_memory_allocated() / 2**20
    for k, v in counts.items():
        check(v == 20 * ANIM_FRAMES,
              f"kernel {k}: {v} launches in {ANIM_FRAMES} frames, not "
              f"{20 * ANIM_FRAMES}")
    check(not any(other.values()), f"BF8 kernels ran on the animated path: "
          f"{other}")
    film = r.film_mean()
    check(film.shape == (512, 512, 3), f"film shape {film.shape}")
    check(bool(np.isfinite(film).all()), "film has non-finite values")
    check(float(np.abs(film).max()) > 0.0, "film is all zero")
    log(f"[anim] {ANIM_FRAMES} frames, 512x512, 5 bounces, 4 spp: "
        f"{wall / ANIM_FRAMES * 1e3:.1f} ms per frame in all (checks "
        f"included), peak memory {peak:.0f} MiB, launches {counts}, film "
        f"mean {float(film.mean()):.5f}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    png = OUT_DIR / "animated_heightfield_512.png"
    write_image(str(png), r.snapshot())
    check(png.stat().st_size > 1000, "PNG not written")
    log(f"[anim] wrote {png.relative_to(ROOT)} ({png.stat().st_size} bytes)")
    _profile(lambda: r.render(1),
             "animated, one sample (5 bounces, 262144 lanes)", top=6)

    def rebuild():
        r._accel_dirty = True
        r._ensure_accel()
    _profile(rebuild, "animated, one rebuild (99458 triangles)", top=8)
    with _Recorder() as rec:
        r.render(1)
    pairs = (("closest_v4", "closest"), ("occluded_v4", "occluded"))
    times = _kernel_times(r, pairs, "anim", rec)
    _ab_bounces(r.accel.bvh, rec, times, pairs, "anim")
    mean = lambda k: float(np.mean([fr[k] for fr in frames]))  # noqa: E731
    return counts, times, dict(frames=frames, peak_mib=peak,
                               rebuild_ms=mean("rebuild_ms"),
                               render_ms=mean("render_ms"),
                               mrays=mean("mrays"))


def _ab_warp(bvh, cases, tag):
    """The A/B of a warp kernel's two designs inside this call, on recorded
    wavefronts: `cases` of (kernel name, label, the call's arguments, its
    `_time_kernel` record). The per-ray arm and the warp kernel in turns
    (per-ray, warp, warp, per-ray; each the least of 2 blocks of 5 launches
    behind the device sleep), against the record's unchanged bound. The
    plain warp schedule runs on the same rays: its hits must equal the
    kernel's bit for bit, and its counts (pages staged per warp round, the
    distinct leaves in them, lanes per group, chunks staged, warp steps)
    explain the A/B. Adds `per_ray_ms`, `ab_ms` and `schedule` to each
    record."""
    import torch
    from pt_torch.accel import kernels
    for name, label, args, tm in cases:
        warp_fn = getattr(kernels, name)
        ray_fn = getattr(kernels, PER_RAY[name])
        n = args[0].shape[0]
        tw, tr = warp_fn(bvh, *args), ray_fn(bvh, *args)
        t0 = time.perf_counter()
        plain, sched = getattr(kernels, name + "_warp_plain")(bvh, *args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if name.startswith("closest"):
            same = all(torch.equal(a, c) and torch.equal(a, e) for a, c, e
                       in zip(_bits(tw), _bits(tr), _bits(plain)))
        else:
            same = torch.equal(tw, tr) and torch.equal(tw, plain)
        check(same, f"{name} {label}: the warp kernel, the per-ray arm and "
              "the plain warp schedule differ")
        arms = {"per_ray": [], "warp": []}
        for arm in ("per_ray", "warp", "warp", "per_ray"):
            fn = ray_fn if arm == "per_ray" else warp_fn
            arms[arm].append(min(cuda_ms(lambda: fn(bvh, *args), reps=5)
                                 for _ in range(2)))
        tm["per_ray_ms"] = float(np.mean(arms["per_ray"]))
        tm["ab_ms"] = float(np.mean(arms["warp"]))
        tm["schedule"] = sched._asdict()
        bound = tm["bound_ms"]
        log(f"[{tag}] A/B {name} {label}, {n} lanes: per-ray "
            f"{arms['per_ray'][0]:.3f} / {arms['per_ray'][1]:.3f} ms, "
            f"warp {arms['warp'][0]:.3f} / {arms['warp'][1]:.3f} ms "
            f"({tm['per_ray_ms'] / tm['ab_ms']:.2f}x); bound "
            f"{bound:.5f} ms by {tm['bound_by']}: per-ray "
            f"{tm['per_ray_ms'] / bound:.1f}x, warp "
            f"{tm['ab_ms'] / bound:.1f}x the bound")
        log(f"[{tag}] warp schedule {name} {label} (plain, {plain_s:.1f} s; "
            f"hits equal the kernels'): "
            f"{sched.groups / max(sched.rounds, 1):.2f} page groups per "
            f"warp round, {sched.leaves / max(sched.groups, 1):.2f} "
            f"leaves and {sched.leaf_visits / max(sched.groups, 1):.2f} "
            f"lanes per group, {sched.rounds / max(sched.warps, 1):.1f} "
            f"rounds per warp, {sched.chunk_loads / max(sched.groups, 1):.2f}"
            f" chunks staged per group, {sched.tri_tests / n:.1f} triangle "
            f"tests per lane; {sched._asdict()}")


def _ab_bounces(bvh, rec, times, pairs, tag):
    """`_ab_warp` on the bounce-0 and bounce-2 wavefronts of `rec`, against
    the records `_kernel_times` made of them."""
    _ab_warp(bvh, [(name, f"bounce {b}", getattr(rec, which)[b],
                    times[(name, b)]) for name, which in pairs
                   for b in (0, 2)], tag)


def _alpha_hits(r):
    """Counts over one bounce-0 wavefront of an alpha scene: lanes with a
    decal (an α < 0.5 surface skipped) and lanes whose final hit is an
    alpha-tested triangle (an α ≥ 0.5 surface accepted)."""
    from pt_torch.render import integrator as ti
    inv_view, inv_proj = r._camera_mats()
    state = ti.init_rng_state(r._px, r._py, r.width, 0)
    _, o, d, _ = ti.raygen(r._px, r._py, r.width, r.height, inv_view,
                           inv_proj, state, r.settings)
    alive = o.new_ones(o.shape[0], dtype=bool)
    hit, _, _, has = ti.trace_closest_alpha(r.ds, r.tex, r.accel, o, d, alive)
    on_alpha = hit.is_hit & ~r.ds.tri_opaque[hit.tri.clamp(min=0).long()]
    return int(has.sum()), int(on_alpha.sum())


def phase_alpha():
    """The two alpha variants at 256², 3 bounces."""
    import torch
    from pt_torch.accel import kernels
    mask = alpha_mask_texture(7)[..., 3]
    check(bool((mask < 128).any() and ((mask >= 128) & (mask < 255)).any()
               and (mask == 255).any()),
          "the mask texture lacks one of the three alpha classes")
    # animated: single-tree loops, every trace a K3 launch
    t0 = time.perf_counter()
    scene = build_animated_scene(port_namespace(), 224, N_CARDS)
    r = _renderer(scene, 256, 2, 3, "cuda")
    n_alpha = int((~r.ds.tri_opaque).sum())
    check(r.ds.has_alpha and n_alpha >= 5000 and not r.tex.all_constant,
          f"alpha scene: {n_alpha} alpha triangles")
    _step_frame(r)
    r.render()                                        # warm frame
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    frames = 2
    t1 = time.perf_counter()
    for _ in range(frames):
        check(_step_frame(r), "scene.update reported no change")
        r.render()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) / frames * 1e3
    counts = dict(kernels.launches)
    check(type(r.accel.bvh).__name__ == "PacketBVH"
          and r.accel.alpha_split is None, "animated alpha: wrong accel")
    # per sample and bounce: 4 rounds of the closest loop and 4 of the
    # shadow loop, each a closest-hit trace of the whole tree
    check(counts["closest_v4"] == frames * 2 * 3 * 8
          and counts["closest_bf8"] == counts["occluded_bf8"] == 0,
          f"animated alpha launches {counts}")
    decals, accepted = _alpha_hits(r)
    check(decals > 0 and accepted > 0,
          f"animated alpha: {decals} decals, {accepted} accepted alpha hits")
    film = r.film_mean()
    check(bool(np.isfinite(film).all()) and float(film.max()) > 0,
          "animated alpha film")
    log(f"[alpha] animated, {r.ds.num_triangles} triangles ({n_alpha} "
        f"alpha-tested), 256x256, 3 bounces, 2 spp: {ms:.1f} ms per frame "
        f"(rebuild + render), launches {counts}; bounce 0: {decals} lanes "
        f"with a decal, {accepted} accepted alpha hits; film mean "
        f"{float(film.mean()):.5f}; {time.perf_counter() - t0:.1f} s")
    # static: SBVH -> BF8 split trees, K1/K2
    t0 = time.perf_counter()
    scene = build_animated_scene(port_namespace(), 224, N_CARDS,
                                 animate=False)
    r = _renderer(scene, 256, 1, 3, "cuda")
    r.render()                                        # builds the trees
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    r.render()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    counts = dict(kernels.launches)
    sp = r.accel.alpha_split
    check(sp is not None, "static alpha: no split trees")
    names = {type(b).__name__ for b in (r.accel.bvh, sp.bvh_opaque,
                                        sp.bvh_alpha)}
    # per bounce: 1 opaque + 4 alpha closest traces, then 1 opaque occlusion
    # + 4 alpha closest traces
    check(names == {"BF8BVH"} and counts["closest_bf8"] == 3 * 9
          and counts["occluded_bf8"] == 3 and counts["closest_v4"] == 0,
          f"static alpha: trees {names}, launches {counts}")
    decals, accepted = _alpha_hits(r)
    check(decals > 0 and accepted > 0,
          f"static alpha: {decals} decals, {accepted} accepted alpha hits")
    film = r.film_mean()
    check(bool(np.isfinite(film).all()) and float(film.max()) > 0,
          "static alpha film")
    log(f"[alpha] static split, 256x256, 3 bounces, 1 spp: trees built in "
        f"{build_s:.1f} s (opaque {sp.bvh_opaque.n_leaves} leaves, alpha "
        f"{sp.bvh_alpha.n_leaves} leaves), {ms:.1f} ms per step, launches "
        f"{counts}; bounce 0: {decals} decals, {accepted} accepted alpha "
        f"hits; film mean {float(film.mean()):.5f}")


def _counted_steps(r, names, steps: int = 3):
    """`steps` render steps with the launch counters set to 0 just before
    and read just after: (seconds, launches of `names`, all launches, useful
    rays, peak MiB)."""
    import torch
    from pt_torch.accel import kernels
    rays0 = r.rays_traced
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    for _ in range(steps):
        r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    every = dict(kernels.launches)
    return (dt, {k: every[k] for k in names}, every, r.rays_traced - rays0,
            torch.cuda.max_memory_allocated() / 2**20)


def _check_film(r, what: str):
    film = r.film_mean()
    check(film.shape == (r.height, r.width, 3), f"{what}: film {film.shape}")
    check(bool(np.isfinite(film).all()), f"{what}: non-finite film values")
    check(float(np.abs(film).max()) > 0.0, f"{what}: film is all zero")
    return film


def _write_png(r, name: str, tag: str):
    from pt_torch.out.saver import write_image
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    png = OUT_DIR / name
    write_image(str(png), r.snapshot())
    check(png.stat().st_size > 1000, "PNG not written")
    log(f"[{tag}] wrote {png.relative_to(ROOT)} ({png.stat().st_size} bytes)")


def _page_bytes(accel) -> int:
    """Bytes of Woop pages an accel holds: its tree's and its split
    trees'."""
    trees = [accel.bvh]
    if accel.alpha_split is not None:
        trees += [accel.alpha_split.bvh_opaque, accel.alpha_split.bvh_alpha]
    return sum(t.pages.numel() * 4 for t in trees)


def _primary_hits(r):
    """Global triangle id of every primary ray's final hit (frame 0),
    through the renderer's own accel and, on an alpha scene, its alpha
    loop."""
    import torch
    from pt_torch.render import integrator as ti
    inv_view, inv_proj = r._camera_mats()
    state = ti.init_rng_state(r._px, r._py, r.width, 0)
    _, o, d, _ = ti.raygen(r._px, r._py, r.width, r.height, inv_view,
                           inv_proj, state, r.settings)
    if r.ds.has_alpha:
        alive = o.new_ones(o.shape[0], dtype=torch.bool)
        return ti.trace_closest_alpha(r.ds, r.tex, r.accel, o, d, alive)[0].tri
    return ti.trace_closest(r.accel.bvh, o, d,
                            torch.full_like(o[:, 0], ti.TMAX)).tri


def phase_instanced():
    """The shared-BLAS path at full width, opaque and alpha, against the
    flatten path of the same scene."""
    import torch
    bf8i = ("closest_bf8i", "occluded_bf8i")
    out = {}
    for alpha in (False, True):
        tag = "inst-alpha" if alpha else "inst"
        arms = {}
        for mode in ("auto", "flatten"):
            t0 = time.perf_counter()
            scene = build_instanced_scene(port_namespace(), N_INST,
                                          alpha=alpha)
            r = _renderer(scene, 512, 4, 5, "cuda", mode)
            t1 = time.perf_counter()
            r._ensure_accel()
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t1
            kinds = [type(r.accel.bvh).__name__]
            sp = r.accel.alpha_split
            if sp is not None:
                kinds += [type(sp.bvh_opaque).__name__,
                          type(sp.bvh_alpha).__name__]
            # "auto" must select the shared-BLAS structure for every tree;
            # the flatten arm takes whatever static tree fits
            check("BF8Instanced" not in kinds if mode == "flatten"
                  else kinds == ["BF8Instanced"] * (3 if alpha else 1),
                  f"{tag} {mode}: structures {kinds}")
            r.render()                                    # warm step
            torch.cuda.synchronize()
            dt, counts, every, rays, peak = _counted_steps(r, bf8i)
            _check_film(r, f"{tag} {mode}")
            # per step 4 spp x 5 bounces; per bounce a closest and a shadow
            # trace, or on the alpha scene 9 closest (1 opaque + 4 alpha, 4
            # alpha for the shadow rays) and 1 occlusion
            per = (9, 1) if alpha else (1, 1)
            if mode == "auto":
                check(counts == {"closest_bf8i": 60 * per[0],
                                 "occluded_bf8i": 60 * per[1]}
                      and sum(every.values()) == sum(counts.values()),
                      f"{tag}: launches {every}")
                log(f"[{tag}] BF8Instanced {_describe_instanced(r.accel.bvh)}"
                    + ("" if sp is None else
                       f"; opaque tree {_describe_instanced(sp.bvh_opaque)}; "
                       f"alpha tree {_describe_instanced(sp.bvh_alpha)}"))
            else:
                check(every["closest_bf8"] == 60 * per[0]
                      and every["occluded_bf8"] == 60 * per[1]
                      and sum(every.values()) == 60 * sum(per),
                      f"{tag} flatten: launches {every}")
            arms[mode] = dict(r=r, build_s=build_s, ms=dt / 3 * 1e3,
                              mrays=rays / dt / 1e6, peak=peak,
                              counts=counts, pages=_page_bytes(r.accel))
            log(f"[{tag}] instancing={mode}: {r.ds.num_triangles} flattened "
                f"triangles, scene + flatten {t1 - t0:.1f} s, accel build "
                f"{build_s:.2f} s, 512x512, 5 bounces, 4 spp: "
                f"{dt / 3 * 1e3:.1f} ms per render step, "
                f"{rays / dt / 1e6:.3f} useful Mrays/s, peak memory "
                f"{peak:.0f} MiB, page bytes {arms[mode]['pages']}, "
                f"structures {kinds}, launches in 3 steps {every}")
        sh, fl = arms["auto"], arms["flatten"]
        # the gates of pt's own A/B of the two arms: same RNG, so the films
        # differ only where a hit flipped
        flips = float((_primary_hits(sh["r"]) != _primary_hits(fl["r"]))
                      .float().mean())
        fs, ff = sh["r"].film_mean(), fl["r"].film_mean()
        shift = abs(float(fs.mean()) - float(ff.mean())) / float(ff.mean())
        moved = float((np.abs(fs - ff).max(axis=-1)
                       > 1e-3 * (1.0 + np.abs(ff).max(axis=-1))).mean())
        log(f"[{tag}] shared against flatten: primary-hit flips "
            f"{flips:.5f} of the pixels (limit 0.005), mean film shift "
            f"{shift:.5f} (limit 0.02), film pixels that differ by more "
            f"than 1e-3 relative {moved:.4f}; page bytes shared / flattened "
            f"{sh['pages'] / fl['pages']:.4f}; accel build {sh['build_s']:.2f}"
            f" s against {fl['build_s']:.2f} s; step {sh['ms']:.1f} ms "
            f"against {fl['ms']:.1f} ms")
        check(flips <= 0.005, f"{tag}: {flips:.5f} of the primary hits flip")
        check(shift <= 0.02, f"{tag}: mean film shift {shift:.5f}")
        _write_png(sh["r"], f"instanced{'_alpha' if alpha else ''}_512.png",
                   tag)
        if not alpha:
            _profile(lambda: sh["r"].render(1),
                     "instanced, one sample (5 bounces, 262144 lanes)", top=6)
            with _Recorder() as rec:
                sh["r"].render(1)
            pairs = (("closest_bf8i", "closest"), ("occluded_bf8i",
                                                   "occluded"))
            out["times"] = _kernel_times(sh["r"], pairs, tag, rec)
            _ab_bounces(sh["r"].accel.bvh, rec, out["times"], pairs, tag)
            del rec             # its wavefronts would count in the next peak
            out["counts"] = sh["counts"]
            out["flatten_k1"] = _ab_flatten_k1(fl["r"], f"{tag}-flatten")
        else:
            out["alpha_tree"] = _ab_alpha_tree(sh["r"], tag)
        out[tag] = {k: v for k, v in sh.items() if k != "r"}
        if not alpha:
            out[tag]["flatten_k1_ab"] = out["flatten_k1"]
        out[tag]["flatten_ms"] = fl["ms"]
        out[tag]["flatten_build_s"] = fl["build_s"]
        del arms, sh, fl, r
    return out["counts"], out["times"], {k: out[k] for k in (
        "inst", "inst-alpha", "alpha_tree")}


def _ab_flatten_k1(r, tag):
    """The warp K1 on the flattened 64 instances' bounce-0 and bounce-2
    wavefronts: the A/B of its two designs, each against the bound of a
    counted launch on the same rays (no plain run: the brute force over
    387,202 triangles would take minutes)."""
    with _Recorder() as rec:
        r.render(1)
    times = {("closest_bf8", b): _time_kernel("closest_bf8", r.accel.bvh,
                                              rec.closest[b], plain=False)
             for b in (0, 2)}
    _ab_bounces(r.accel.bvh, rec, times, (("closest_bf8", "closest"),), tag)
    return {b: {k: v for k, v in times[("closest_bf8", b)].items()
                if k != "schedule"} for b in (0, 2)}


def _ab_alpha_tree(r, tag):
    """K5 on the alpha-card tree (64 leaves over one shared page: a card's
    four triangles, a cross of two quads, padded out to 32 columns), where
    it runs 8 of its 9 launches a bounce: the A/B of its two designs on the
    first alpha round of bounces 0 and 2, each against its bound."""
    with _Recorder() as rec:
        r.render(1)
    # per bounce 9 closest traces: 1 opaque, then 4 alpha rounds for the
    # camera or bounce rays, then 4 for the shadow rays
    check(len(rec.closest) == 45, f"{tag}: {len(rec.closest)} closest traces")
    tree = r.accel.alpha_split.bvh_alpha
    times = {}
    cases = []
    for b in (0, 2):
        args = rec.closest[9 * b + 1]
        times[b] = _time_kernel("closest_bf8i", tree, args)
        cases.append(("closest_bf8i", f"alpha tree, bounce {b} round 1",
                      args, times[b]))
    _ab_warp(tree, cases, tag)
    return {b: {k: v for k, v in tm.items() if k != "schedule"}
            for b, tm in times.items()}


def _agreement(kernel, hk, hp, what):
    """Kernel result `hk` against its plain version's `hp` on one ray set:
    where the ids agree, t, u and v must be equal; a lane whose ids differ
    at equal t is an exact tie between two leaves (the walk's leaf-box
    retest can cull the second leaf before its smaller id is seen) and is
    counted apart; any other differing lane fails the run. Occlusion must
    agree on every lane."""
    if kernel.startswith("occluded"):
        differ = int((hk != hp).sum())
        check(differ == 0, f"{kernel} {what}: {differ} lanes differ from the "
              "plain version")
        return dict(differ=0, ties=0, err=0.0)
    differ = hk.tri != hp.tri
    ties = differ & (hk.t == hp.t)
    same = ~differ
    err = max(float(torch_max((a - b).abs()[same]))
              for a, b in ((hk.t, hp.t), (hk.u, hp.u), (hk.v, hp.v)))
    other = int((differ & ~ties).sum())
    check(other == 0 and err == 0.0,
          f"{kernel} {what}: {other} lanes differ from the plain version "
          f"beyond exact ties; max |d(t, u, v)| {err:.3e} where ids agree")
    return dict(differ=int(differ.sum()), ties=int(ties.sum()), err=err)


def _parity_exact(kernel, bvh, sets, rng):
    """`kernel` against its plain version on each (name, (o, d, t)) ray
    set; occlusion kernels get seeded distances on the closest sets."""
    import torch
    from pt_torch.accel import kernels
    err = 0.0
    for what, (o, d, t) in sets:
        if kernel.startswith("occluded") and not what.startswith("shadow"):
            t = torch.as_tensor(rng.uniform(0.05, 20.0, o.shape[0])
                                .astype(np.float32), device="cuda")
        hk = getattr(kernels, kernel)(bvh, o, d, t)
        hp = getattr(kernels, kernel + "_plain")(bvh, o, d, t)
        agree = _agreement(kernel, hk, hp, what)
        found = hp if isinstance(hp, torch.Tensor) else hp.tri >= 0
        log(f"[archive] parity {kernel} {what}: {o.shape[0]} rays, "
            f"{agree['differ']} lanes differ, {agree['ties']} of them exact "
            f"ties; {int(found.sum())} "
            f"{'occluded' if found is hp else 'hits'}")
        err = max(err, agree["err"])
    return err


def _parity_sets(rec, bvh, rng):
    """16,384-ray sets from a recorded sample: bounce 0, bounce 2's live
    lanes, bounce 2 with the lanes the integrator killed, seeded random rays,
    and the shadow rays of bounces 0 and 2 as the integrator sends them."""
    live2 = (rec.closest[2][2] > 1e-4).cpu().numpy()
    check(0 < (~live2).sum(), "bounce 2 has no killed lanes")
    return (("bounce0", _sample_rows(rec.closest[0], N_PARITY, rng)),
            ("bounce2", _sample_rows(rec.closest[2], N_PARITY, rng, live2)),
            ("bounce2 with killed lanes",
             _sample_rows(rec.closest[2], N_PARITY, rng)),
            ("random", _random_rays(bvh, N_PARITY, rng)),
            ("shadow rays of bounce 0",
             _sample_rows(rec.occluded[0], N_PARITY, rng)),
            ("shadow rays of bounce 2",
             _sample_rows(rec.occluded[2], N_PARITY, rng)))


def _time_walk(kernel, fn, bvh, args, what, plain=True, node_bytes=None):
    """CUDA-event ms per launch of `fn(bvh, *args)` (an entry point, or the
    wrapper of `kernel`; the least of 3 blocks of 5 launches, since a host
    stall longer than `cuda_ms`'s device sleep leaves gaps between launches
    in a block), the bound from a counted launch of `kernel` on the same
    rays and, with `plain`, the plain version's time (one run, not warmed:
    it takes seconds) and its agreement with the kernel."""
    from pt_torch.accel import kernels
    counts = kernels.work_counts(bvh)
    counted(kernels, kernel)(bvh, *args, counts=counts)
    n = args[0].shape[0]
    closest = kernel.startswith("closest")
    res = dict(n=n, **_bound(n, 16 if closest else 1, counts, bvh,
                             node_bytes))
    out = {}
    res["ms"] = min(cuda_ms(lambda: out.update(k=fn(bvh, *args)), reps=5)
                    for _ in range(3))
    if plain:
        p_fn = getattr(kernels, kernel + "_plain")
        res["plain_ms"] = cuda_ms(lambda: out.update(p=p_fn(bvh, *args)),
                                  reps=1, warm=False)
        res.update(_agreement(kernel, out["k"], out["p"], what))
    log(f"[archive] {kernel} via {getattr(fn, '__name__', kernel)} on {what}:"
        f" {n} lanes, {res['ms']:.3f} ms"
        + (f" (plain {res['plain_ms']:.1f} ms, {res['differ']} lanes "
           f"differ, {res['ties']} exact ties)" if plain else "")
        + f", bound {res['bound_ms']:.5f} ms by {res['bound_by']} "
        f"({res['bound_bytes']} bytes); {res['node_visits']} "
        f"{'node visits' if len(counts.totals) == 3 else 'slab tests'}, "
        f"{res['tri_tests']} triangle tests ({res['tri_tests'] / n:.1f} per "
        f"lane); {res['nodes_seen']} distinct nodes, {res['tris_seen']} "
        f"distinct triangles")
    return res


def _reset_counts():
    from pt_torch.accel import archive, kernels
    kernels.reset_launch_counts()
    archive.reset_call_counts()


def _entry_launches(what, direct=()):
    """Kernel launches per entry point since the counters were set to 0
    (`archive.launches`, read from the kernels' own launch counters):
    every entry point called launched its kernel once per call, and the
    entry points' launches of a kernel are all of its launches, but for the
    kernels in `direct`, which the run also called by their wrappers."""
    from pt_torch.accel import archive, kernels
    got = {k: v for k, v in archive.launches.items() if v}
    called = {k: v for k, v in archive.calls.items() if v}
    check(got == called, f"{what}: launches {got} against calls {called}")
    for kernel in {archive.KERNEL_OF[e] for e in got}:
        ours = sum(v for e, v in got.items()
                   if archive.KERNEL_OF[e] == kernel)
        total = kernels.launches[kernel]
        check(total > ours if kernel in direct else total == ours,
              f"{what}: {kernel} launched {total} times, {ours} of them by "
              f"entry points {got}")
    return got


def _path_a():
    """pt's kernel A/B harnesses at full size (65,536 rays), with the launch
    counters set to 0 before each and read after: every arm shows 0 oracle
    mismatches, the occlusion arms agree with v1. Returns the launches per
    entry point and each bench's result."""
    from pt_torch.benches import bvh_kernels, widesub_ab
    t0 = time.perf_counter()
    _reset_counts()
    bk = bvh_kernels.main(emit=lambda line: log(f"[archive] {line}"))
    launches = _entry_launches("bvh_kernels", direct=("occluded_v4",))
    check(set(launches) == {"packet_closest", "packet_closest_sub",
                            "packet_closest_v3", "packet_occluded",
                            "packet_occluded_sub"},
          f"bvh_kernels: launches per entry point {launches}")
    for arm in bk["arms"]:
        check(arm["oracle_mismatches"] == 0
              and arm.get("disagree_with_v1", 0) == 0,
              f"bvh_kernels {arm['arm']}: {arm}")
    ws = {}
    for scene in ("heightfield", "courtyard"):
        _reset_counts()
        ws[scene] = widesub_ab.main(
            scene=scene, emit=lambda line: log(f"[archive] {line}"))
        got = _entry_launches(f"widesub_ab {scene}", direct=("closest_bf8",))
        check(list(got) == ["packet_closest_bf8w"],
              f"widesub_ab {scene}: launches per entry point {got}")
        for arm in ws[scene]["arms"]:
            check(arm["oracle_mismatches"] == 0,
                  f"widesub_ab {scene} {arm['arm']}: {arm}")
        if scene == "heightfield":
            launches.update(got)
    log(f"[archive] path (a): both harnesses in "
        f"{time.perf_counter() - t0:.1f} s; launches per entry point "
        f"{launches}")
    return launches, bk, ws["heightfield"]


def _path_b():
    """The Heightfield at 512², 5 bounces, 4 spp with its tree swapped for a
    BF8V6, against the BF8 frame of the same RNG. Returns (the renderer,
    launches per entry point in 3 steps, the step's numbers)."""
    import torch
    from pt_torch.accel import archive
    arms = {}
    for kind in ("BF8BVH", "BF8V6"):
        t0 = time.perf_counter()
        r = _renderer(224, 512, 4, 5, "cuda")
        r._ensure_accel()
        if kind == "BF8V6":
            v6, fine = archive.swap_in_bf8_v6(r)
            log(f"[archive] BF8V6 of the production SBVH: n8 {v6.n8}, "
                f"{v6.n_leaves} leaves of block {v6.block}, unified table "
                f"{v6.u_lo.shape[0]} rows "
                f"({(v6.u_lo.shape[0] * 6 + v6.n8 * 16) * 4 / 1024:.0f} KiB "
                f"by pt's budget of 640), depth {v6.depth}; the fine binary "
                f"tree {fine.n_top} nodes, depth {fine.depth}; pages shared "
                f"with the fine tree: {v6.pages.data_ptr() == fine.pages.data_ptr()}")
            check(v6.pages.data_ptr() == fine.pages.data_ptr(),
                  "BF8V6 copied its pages")
        check(type(r.accel.bvh).__name__ == kind, f"accel is not {kind}")
        build_s = time.perf_counter() - t0
        r.render()                                        # warm step
        _reset_counts()
        used = (("closest_v6", "occluded_v6") if kind == "BF8V6"
                else ("closest_bf8", "occluded_bf8"))
        dt, counts, every, rays, peak = _counted_steps(r, used)
        calls = _entry_launches(f"path (b) {kind}")
        film = _check_film(r, f"Heightfield, {kind}")
        check(counts == {used[0]: 60, used[1]: 60}
              and sum(every.values()) == 120,
              f"{kind}: launches in 3 steps {every}")
        check(calls == ({"packet_closest_v6": 60, "packet_occluded_v6": 60}
                        if kind == "BF8V6" else {}),
              f"{kind}: launches per entry point in 3 steps {calls}")
        arms[kind] = dict(ms=dt / 3 * 1e3, mrays=rays / dt / 1e6, peak=peak,
                          film=film, hits=_primary_hits(r), calls=calls,
                          build_s=build_s)
        log(f"[archive] path (b), Heightfield n=224 with {kind}, 512x512, 5 "
            f"bounces, 4 spp: {dt / 3 * 1e3:.1f} ms per render step, "
            f"{rays / dt / 1e6:.3f} useful Mrays/s, peak memory {peak:.0f} "
            f"MiB, launches in 3 steps {every}, per entry point {calls}")
        if kind == "BF8BVH":
            del r
            torch.cuda.empty_cache()
    a, b = arms["BF8BVH"], arms["BF8V6"]
    mse = float(np.mean((a["film"] - b["film"]) ** 2))
    flips = float((a["hits"] != b["hits"]).float().mean())
    log(f"[archive] path (b) BF8V6 against BF8, same RNG: film MSE {mse:.3e} "
        f"(limit 1e-3), primary-hit flips {flips:.6f} of the pixels (limit "
        f"0.005); step {b['ms']:.1f} ms against {a['ms']:.1f} ms, peak "
        f"{b['peak']:.0f} MiB against {a['peak']:.0f} MiB")
    check(mse < 1e-3, f"BF8V6 film MSE {mse} against the BF8 film")
    check(flips <= 0.005, f"BF8V6: {flips:.5f} of the primary hits flip")
    stats = {k: {x: y for x, y in v.items() if x in ("ms", "mrays", "peak")}
             for k, v in arms.items()}
    stats.update(film_mse=mse, flips=flips)
    return r, v6, fine, b["calls"], stats


def phase_archive():
    """pt's archive kernels through the entry points that select them: path
    (a), the A/B harnesses; path (b), a static frame whose tree is a BF8V6;
    direct calls of v6k2 and v7; parity of the five new kernels on real
    wavefronts; their times (and closest_ordered against K3 on the Morton
    tree's wavefronts), each bound from the least work of the walks that
    computed the same function on the same rays; the cross-device BF8V6
    cell. Returns (launches per entry point, a row of numbers per entry
    point, path (b)'s numbers)."""
    import torch
    from pt_torch.accel import archive, kernels
    from pt_torch.accel.bvh8 import build_bf8
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    launches, bk, ws = _path_a()
    r, v6, fine, calls, b_stats = _path_b()
    launches.update(calls)

    # one more sample, recorded: the wavefronts for parity, times and the
    # direct calls
    with _Recorder() as rec:
        r.render(1)
    _reset_counts()
    direct = []
    for o, d, t in rec.closest:
        direct.append((archive.packet_closest_v6k2(v6, o, d, t),
                       archive.packet_closest_v7(v6, o, d, t, window=8)))
    torch.cuda.synchronize()
    n_calls = len(rec.closest)
    calls = _entry_launches("direct calls")
    check(calls == {"packet_closest_v6k2": n_calls,
                    "packet_closest_v7": n_calls},
          f"direct calls: launches per entry point {calls}")
    launches.update(calls)
    for (o, d, t), (h2, h7) in zip(rec.closest, direct):
        h6 = kernels.closest_v6(v6, o, d, t)
        for what, h in (("v6k2", h2), ("v7", h7)):
            _agreement("closest_v6", h, h6, f"{what} against v6")
    log(f"[archive] direct calls over {n_calls} recorded wavefronts: "
        f"launches per entry point {calls}")
    # the host's time per entry-point call, enqueue only: the timed blocks
    # below hold 5 launches behind a ~20 ms device sleep
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(20):
        archive.packet_closest_v6(v6, *rec.closest[0])
    host_ms = (time.perf_counter() - t1) / 20 * 1e3
    torch.cuda.synchronize()
    log(f"[archive] host time per packet_closest_v6 call: {host_ms:.3f} ms "
        "enqueued")
    check(5 * host_ms < 15.0, f"host time per call {host_ms:.3f} ms: five "
          "launches would outlast the timing's device sleep")

    # parity on real wavefronts: v6 kernels over the BF8V6, the ordered walk
    # over the SAH tree of the harness and over the fine SBVH
    errs = {}
    sets = _parity_sets(rec, v6, rng)
    closest_sets = [s_ for s_ in sets if not s_[0].startswith("shadow")]
    for kernel in ("closest_v6", "closest_v6k2", "closest_v7",
                   "occluded_v6"):
        errs[kernel] = _parity_exact(
            kernel, v6, sets if kernel.startswith("occluded")
            else closest_sets, rng)
    errs["closest_ordered"] = max(
        _parity_exact("closest_ordered", tree, closest_sets, rng)
        for tree in (bk["tree"], fine))
    for what, tree in (("harness SAH tree", bk["tree"]), ("fine SBVH", fine)):
        for set_name, rays in closest_sets:
            _closest_arms("closest_ordered", tree, rays,
                          f"{what} (block {tree.block}, depth {tree.depth}), "
                          f"{set_name}")

    # times on the real bounce-0 and bounce-2 wavefronts (262,144 lanes);
    # the walks over the fine SBVH's leaves compute one function, and so do
    # the two occlusion walks: each group's bound is its least work
    times = {}
    b8 = build_bf8(fine)
    for b in (0, 2):
        c_args, s_args = rec.closest[b], rec.occluded[b]
        what = f"static bounce {b}"
        v6_walks = (("closest_v6", archive.packet_closest_v6, True),
                    ("closest_v6k2", archive.packet_closest_v6k2, True),
                    ("closest_v7", archive.packet_closest_v7, False))
        for kernel, fn, plain in v6_walks:
            times[(kernel, b)] = _time_walk(kernel, fn, v6, c_args, what,
                                            plain=plain,
                                            node_bytes=BYTES_PER_NODE_V6)
        times[("closest_ordered", b)] = _time_walk(
            "closest_ordered", kernels.closest_ordered, fine, c_args,
            f"{what}, fine SBVH")
        times[("closest_bf8", b)] = _time_walk(
            "closest_bf8", kernels.closest_bf8, b8, c_args,
            f"{what}, BF8 of the fine SBVH", plain=False)
        _least_bound({k: times[(k, b)] for k in (
            "closest_v6", "closest_v6k2", "closest_v7", "closest_ordered",
            "closest_bf8")}, f"{what}, closest hit over the fine SBVH's "
            "leaves")
        times[("occluded_v6", b)] = _time_walk(
            "occluded_v6", archive.packet_occluded_v6, v6, s_args,
            f"static shadow rays of bounce {b}")
        times[("occluded_bf8", b)] = _time_walk(
            "occluded_bf8", kernels.occluded_bf8, b8, s_args,
            f"static shadow rays of bounce {b}, BF8 of the fine SBVH",
            plain=False)
        _least_bound({k: times[(k, b)] for k in ("occluded_v6",
                                                 "occluded_bf8")},
                     f"static shadow rays of bounce {b}")
        times[("closest_v7", b)]["plain_ms"] = \
            times[("closest_v6", b)]["plain_ms"]      # the same function
    # the warp BF8V6 walks against their per-ray designs on the same
    # wavefronts
    _ab_bounces(v6, rec, times, (("closest_v6", "closest"),
                                 ("closest_v6k2", "closest"),
                                 ("closest_v7", "closest"),
                                 ("occluded_v6", "occluded")), "archive")
    _log_build_of("archive", "bf8w", "V6Walk")
    _log_build_of("archive", "v6w", "TwoPops")
    _log_build_of("archive", "v6w", "LeafQueue")
    _log_build_of("archive", "bf8wo", "V6AnyHit")
    # the warp closest_ordered against its per-ray design, over the fine
    # SBVH
    _ab_warp(fine, [("closest_ordered", f"fine SBVH, bounce {b}",
                     rec.closest[b], times[("closest_ordered", b)])
                    for b in (0, 2)], "archive")
    _log_build_of("archive", "ordw", "ordered_warp_kernels")
    del r, rec

    errs["closest_ordered"] = max(errs["closest_ordered"],
                                  _morton_ordered(rng, times))
    # the entry points' own workloads: path (a)'s for A1/A2/A7-A10, path
    # (b)'s bounce 0 for A3-A6
    workloads = {"closest_ordered": ("bvh_kernels sorted rays", bk["tree"],
                                     bk["workloads"]["sorted"]),
                 "occluded_v4": ("bvh_kernels shadow rays", bk["tree"],
                                 bk["workloads"]["shadow"]),
                 "closest_bf8": ("widesub_ab Heightfield rays", ws["tree"],
                                 ws["workload"])}
    rows = {}
    by_kernel = {}
    for entry, (_, kernel) in ARCHIVE.items():
        fn = getattr(archive, entry)
        if kernel in workloads:
            what, tree, args = workloads[kernel]
            tm = _time_walk(kernel, fn, tree, args, what,
                            plain=kernel not in by_kernel)
            if kernel == "closest_ordered" and kernel not in by_kernel:
                # K3 computes the same function on the same rays and tree
                k3 = _time_walk("closest_v4", kernels.closest_v4, tree, args,
                                what, plain=False)
                _least_bound({"closest_ordered": tm, "closest_v4": k3},
                             what)
                # its two designs in turns, with the warp schedule's groups
                harness = dict(tm)
                _ab_warp(tree, [("closest_ordered", what, args, harness)],
                         "archive")
            elif kernel in by_kernel:
                for k in ("plain_ms", "bound_ms", "bound_by", "bound_bytes",
                          "bound_ops"):
                    tm[k] = by_kernel[kernel][k]
            if kernel in PER_RAY:
                # the kernel's first design (K1's for A2, K4's for A8/A9) on
                # the same rays, in the same call
                ray_fn = getattr(kernels, PER_RAY[kernel])
                tm["per_ray_ms"] = min(
                    cuda_ms(lambda: ray_fn(tree, *args), reps=5)
                    for _ in range(3))
                log(f"[archive] {entry} on {what}: warp {kernel} "
                    f"{tm['ms']:.3f} ms, per-ray {tm['per_ray_ms']:.3f} ms")
            by_kernel.setdefault(kernel, tm)
        else:
            tm = {k: v for k, v in times[(kernel, 0)].items()
                  if k != "schedule"}
            if "per_ray_ms" in times[(kernel, 2)]:
                tm.update(per_ray_ms_bounce2=times[(kernel, 2)]["per_ray_ms"],
                          ab_ms_bounce2=times[(kernel, 2)]["ab_ms"])
            what = "static bounce 0, BF8V6"
        tm["workload"] = what
        tm["err"] = max(tm.get("err", 0.0), errs.get(kernel, 0.0))
        if kernel == "closest_ordered":       # its A/B on the wavefronts
            keep = ("per_ray_ms", "ab_ms", "bound_ms")
            tm["ab"] = {what: {k: harness[k] for k in keep}}
            tm["ab"].update({
                f"{tree_name} bounce {b}": {k: times[(key, b)][k]
                                            for k in keep}
                for tree_name, key in (("fine SBVH", "closest_ordered"),
                                       ("Morton tree",
                                        "closest_ordered morton"))
                for b in (0, 2)})
        rows[entry] = tm
    _cross_device_v6()
    log(f"[archive] done in {time.perf_counter() - t0:.1f} s")
    return launches, rows, b_stats


def _morton_ordered(rng, times):
    """closest_ordered over the Animated Heightfield's Morton tree (its
    second frame): parity on real wavefronts, and its time beside K3's on
    the bounce-0 and bounce-2 wavefronts (262,144 lanes), both held to the
    bound of the lesser work of the two; then the A/B of closest_ordered's
    two designs on the same wavefronts, beside the warp K3."""
    scene = build_animated_scene(port_namespace(), 224)
    r = _renderer(scene, 512, 1, 3, "cuda")
    _step_frame(r)
    _step_frame(r)
    with _Recorder() as rec:
        r.render(1)
    bvh = r.accel.bvh
    check(type(bvh).__name__ == "PacketBVH", "animated scene: no PacketBVH")
    log(f"[archive] Morton tree of the Animated Heightfield: {bvh.n_top} "
        f"nodes, depth {bvh.depth}, block {bvh.block}")
    sets = [s_ for s_ in _parity_sets(rec, bvh, rng)
            if not s_[0].startswith("shadow")]
    err = _parity_exact("closest_ordered", bvh, sets, rng)
    from pt_torch.accel import kernels
    for b in (0, 2):
        what = f"animated bounce {b}, Morton tree"
        o_ = times[("closest_ordered morton", b)] = _time_walk(
            "closest_ordered", kernels.closest_ordered, bvh, rec.closest[b],
            what)
        v_ = times[("closest_v4 morton", b)] = _time_walk(
            "closest_v4", kernels.closest_v4, bvh, rec.closest[b], what,
            plain=False)
        _least_bound({"closest_ordered": o_, "closest_v4": v_}, what)
        log(f"[archive] {what}: ordered walk {o_['ms']:.3f} ms against K3 "
            f"{v_['ms']:.3f} ms ({v_['ms'] / o_['ms']:.2f}x), "
            f"{o_['ms'] / o_['bound_ms']:.1f}x and "
            f"{v_['ms'] / v_['bound_ms']:.1f}x the bound; triangle tests "
            f"{o_['tri_tests']} against {v_['tri_tests']}")
    _ab_warp(bvh, [("closest_ordered", f"Morton tree, animated bounce {b}",
                    rec.closest[b], times[("closest_ordered morton", b)])
                   for b in (0, 2)], "archive")
    for b in (0, 2):
        o_ = times[("closest_ordered morton", b)]
        v_ = times[("closest_v4 morton", b)]
        log(f"[archive] animated bounce {b}, Morton tree: the warp ordered "
            f"walk {o_['ab_ms']:.3f} ms (per-ray {o_['per_ray_ms']:.3f}) "
            f"beside the warp K3 {v_['ms']:.3f} ms; bound "
            f"{o_['bound_ms']:.5f} ms")
    return err


def _cross_device_v6():
    """The Heightfield (n=64) with the BF8V6 tree at 64², 1 spp, 3 bounces:
    card against CPU, MSE < 1e-3."""
    from pt_torch.accel import archive
    t0 = time.perf_counter()
    films = {}
    for dev in ("cuda", "cpu"):
        r = _renderer(64, 64, 1, 3, dev)
        archive.swap_in_bf8_v6(r)
        r.render()
        films[dev] = r.film_mean()
    mse = float(np.mean((films["cuda"] - films["cpu"]) ** 2))
    log(f"[archive] cross-device Heightfield n=64 with BF8V6, 64x64, 1 spp, "
        f"3 bounces: film MSE cuda vs cpu {mse:.3e} (limit 1e-3), "
        f"{time.perf_counter() - t0:.1f} s")
    check(bool(np.isfinite(mse)) and mse < 1e-3,
          f"BF8V6 cross-device film MSE {mse} >= 1e-3")


def phase_courtyard():
    """The Courtyard at 512², 5 bounces, 2 spp: detail 0.85 forced through
    the shared-BLAS path, and the full scene with "auto", which the segment
    cap and the low duplication keep on the flat BF8 path."""
    from pt_torch.core.config import Config
    from pt_torch.scene.textures import _budget_max_dim
    for detail, mode in ((0.85, "shared"), (1.0, "auto")):
        tag = f"court-{detail}"
        r, scene_s, upload_s, build_s = courtyard_renderer(
            detail, mode, 2, COURT_TEX_SCALE)
        sp = r.accel.alpha_split
        check(sp is not None, f"{tag}: no split trees")
        kinds = [type(t).__name__ for t in (r.accel.bvh, sp.bvh_opaque,
                                            sp.bvh_alpha)]
        segs = int(r.ds.seg_transform.shape[0])
        if mode == "shared":
            check(kinds == ["BF8Instanced"] * 3 and segs == 985,
                  f"{tag}: {kinds}, {segs} segments")
            used = ("closest_bf8i", "occluded_bf8i")
        else:
            check(kinds == ["BF8BVH"] * 3 and segs == 1135,
                  f"{tag}: {kinds}, {segs} segments")
            used = ("closest_bf8", "occluded_bf8")
        r.render()                                        # warm step
        dt, counts, every, rays, peak = _counted_steps(r, used, steps=2)
        check(counts == {used[0]: 2 * 2 * 5 * 9, used[1]: 2 * 2 * 5}
              and sum(every.values()) == sum(counts.values()),
              f"{tag}: launches {every}")
        _check_film(r, tag)
        decals, accepted = _alpha_hits(r)
        check(decals > 0 and accepted > 0,
              f"{tag}: {decals} decals, {accepted} accepted alpha hits")
        max_dim = _budget_max_dim(r.scene.textures, Config())
        log(f"[{tag}] Courtyard detail {detail}, tex_scale {COURT_TEX_SCALE}, "
            f"instancing={mode}: {r.ds.num_triangles} triangles "
            f"({int((~r.ds.tri_opaque).sum())} alpha-tested), {segs} "
            f"segments, {len(r.scene.textures)} textures (size cap "
            f"{max_dim}, pool {tuple(r.tex.data.shape)} "
            f"{str(r.tex.data.dtype).split('.')[-1]}); scene {scene_s:.1f} s,"
            f" flatten + textures {upload_s:.1f} s, accel {build_s:.1f} s "
            f"({', '.join(kinds)}); 512x512, 5 bounces, 2 spp: "
            f"{dt / 2 * 1e3:.1f} ms per render step, {rays / dt / 1e6:.3f} "
            f"useful Mrays/s, peak memory {peak:.0f} MiB, launches in 2 "
            f"steps {counts}; bounce 0: {decals} decals, {accepted} accepted "
            f"alpha hits")
        _write_png(r, f"courtyard_{detail}_512.png", tag)
        del r


def phase_default():
    """The Default scene (Cornell box, glass and mirror cubes, the four
    embedded PNG textures) at 512², 5 bounces, 3 steps of 4 spp."""
    from pt_torch.post.pipeline import PostProcessSettings, postprocess
    from pt_torch.scene.examples import TEST_SCENES
    t0 = time.perf_counter()
    r = _renderer(TEST_SCENES["Default"](), 512, 4, 5, "cuda")
    r.render()                                            # warm step
    bvh = r.accel.bvh
    check(type(bvh).__name__ == "BF8BVH" and not r.tex.all_constant
          and len(r.scene.textures) == 4, "Default: wrong accel or textures")
    dt, counts, every, rays, peak = _counted_steps(
        r, ("closest_bf8", "occluded_bf8"))
    check(counts == {"closest_bf8": 60, "occluded_bf8": 60}
          and sum(every.values()) == 120, f"Default: launches {every}")
    _check_film(r, "Default")
    # background pixels with bloom off: 1 - exp(-skybox colour)
    snap = postprocess(r.accum, float(r.total_samples),
                       PostProcessSettings(enable_bloom=False)).cpu().numpy()
    sky = 1.0 - np.exp(-r.ds.skybox_color.cpu().numpy())
    background = int((np.abs(snap - sky).max(axis=-1) < 1e-5).sum())
    check(background > 1000, f"Default: {background} background pixels")
    log(f"[default] Default scene: {r.ds.num_triangles} triangles, "
        f"{bvh.n_leaves} leaves, texture pool {tuple(r.tex.data.shape)}; "
        f"512x512, 5 bounces, 4 spp: {dt / 3 * 1e3:.1f} ms per render step, "
        f"{rays / dt / 1e6:.3f} useful Mrays/s, peak memory {peak:.0f} MiB, "
        f"{background} background pixels equal 1 - exp(-sky); "
        f"{time.perf_counter() - t0:.1f} s")
    _write_png(r, "default_512.png", "default")


def _film(scene_fn, width, bounces, frames, dev, instancing="auto"):
    r = _renderer(scene_fn(), width, 1, bounces, dev, instancing)
    for _ in range(frames):
        _step_frame(r)
        r.render()
    return r.film_mean()


def phase_cross_device():
    ns = port_namespace()
    paths = (
        ("Heightfield n=64, 64x64, 3 bounces", lambda: 64, 64, 1),
        ("animated alpha n=16 + 60 cards, 32x32, 3 bounces, frame 2",
         lambda: build_animated_scene(ns, 16, 60), 32, 2),
        ("static alpha split n=16 + 60 cards, 32x32, 3 bounces",
         lambda: build_animated_scene(ns, 16, 60, animate=False), 32, 1),
        ("instanced alpha, 6 instances of a 12x12 grid, shared, 32x32, "
         "3 bounces", lambda: build_instanced_scene(ns, 6, 12, alpha=True),
         32, 1),
    )
    for what, scene_fn, width, frames in paths:
        t0 = time.perf_counter()
        mode = "shared" if what.startswith("instanced") else "auto"
        films = {dev: _film(scene_fn, width, 3, frames, dev, mode)
                 for dev in ("cuda", "cpu")}
        mse = float(np.mean((films["cuda"] - films["cpu"]) ** 2))
        log(f"[cross] {what}, 1 spp: film MSE cuda vs cpu {mse:.3e} (limit "
            f"1e-3), {time.perf_counter() - t0:.1f} s")
        check(bool(np.isfinite(mse)) and mse < 1e-3,
              f"{what}: film MSE {mse} >= 1e-3")


def _pops_checks(tag, bvh8, rows, rng):
    """Phase 11's checks on every bounce's wavefront of a bench run: K1's
    pops launch (the warp kernel's pops instance) and its per-ray arm give
    hits bit-equal to the warp K1's and pops equal to each other and to the
    bench's own launch's on every lane, and, on a 16,384-lane sample, the
    plain walk's (whose hits equal the kernel's there); the pops sum to the
    node visits plus leaf retests of a counted launch; the bench's rounds,
    per-warp rounds and lockstep share are those of the per-ray arm's pops
    (and rounds[b] the most of done[b, :]); no lane's stack passes the
    tree's bound. Returns the largest difference found (0 when every check
    passed)."""
    import torch
    from pt_torch.accel import kernels
    from pt_torch.benches import drain_sim
    check(bvh8.stack_bound <= kernels.BF8_STACK,
          f"{tag}: stack bound {bvh8.stack_bound}")
    threads = kernels.bf8_threads_per_block("cuda")
    err = 0.0
    for row in rows:
        o, d, tmax = row["wavefront"]
        o, d = o.contiguous(), d.contiguous()
        n = o.shape[0]
        limit = torch.full((n,), float(tmax), device=o.device)
        hk = kernels.closest_bf8(bvh8, o, d, limit)
        pops = torch.full((n,), -1, dtype=torch.int32, device=o.device)
        hp = kernels.closest_bf8(bvh8, o, d, limit, pops=pops)
        pops_r = torch.full((n,), -1, dtype=torch.int32, device=o.device)
        hr = kernels.closest_bf8_per_ray(bvh8, o, d, limit, pops=pops_r)
        counts = kernels.work_counts(bvh8)
        kernels.closest_bf8_per_ray(bvh8, o, d, limit, counts=counts)
        same = all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(_bits(hk), _bits(hp), _bits(hr)))
        t_err = float(torch.maximum((hk.t - hp.t).abs().max(),
                                    (hk.t - hr.t).abs().max()))
        n_pops = int((pops != pops_r).sum())
        totals = counts.totals.tolist()
        idx = torch.as_tensor(np.sort(rng.choice(n, min(N_PARITY, n),
                                                 replace=False)),
                              device=o.device)
        peak = torch.zeros(idx.numel(), dtype=torch.int32, device=o.device)
        hw, pw = kernels.closest_bf8_walk_plain(bvh8, o[idx], d[idx],
                                                limit[idx], peak=peak)
        walk_same = all(torch.equal(a, b[idx]) for a, b in zip(hw, hk))
        p_err = float((pw - pops[idx]).abs().max())
        # the bench's numbers from the per-ray arm's pops
        lanes_r = drain_sim.lanes_of(pops_r, threads)
        done_r = lanes_r.max(axis=2)
        rounds_r = done_r.max(axis=1)
        lockstep_r = float(lanes_r.sum()) / max(drain_sim.WARP
                                                * int(done_r.sum()), 1)
        if "done" in row:
            model_same = (np.array_equal(done_r, row["done"])
                          and np.array_equal(rounds_r, row["rounds"])
                          and drain_sim.simulate(done_r)
                          == (row["current"], row["lower"], row["rows"]))
        else:
            model_same = (int(np.median(rounds_r)) == row["rounds_p50"]
                          and int(rounds_r.max()) == row["rounds_max"])
        model_same = model_same and lockstep_r == row["lockstep"]
        log(f"[{tag}] bounce {row['bounce']}: {n} lanes, the warp pops "
            f"launch's and the per-ray arm's hits {'equal' if same else 'DIFFER from'} "
            f"the warp K1's (max|dt| {t_err:.3e}); {n_pops} lanes' pops "
            f"differ between the two; pops sum {int(pops.sum())} against "
            f"node visits + leaf retests {totals[0] + totals[1]}; pops "
            f"equal the plain walk's on {idx.numel()} lanes: {p_err == 0} "
            f"(walk hits equal the kernel's: {walk_same}); the bench's "
            f"rounds and lockstep {lockstep_r:.4f} from the per-ray arm's "
            f"pops: {'the same' if model_same else 'DIFFERENT'}; lane pops "
            f"mean {float(pops.float().mean()):.2f} max {int(pops.max())}; "
            f"stack peak {int(peak.max())} of bound {bvh8.stack_bound}")
        check(same, f"{tag} bounce {row['bounce']}: the pops launches' hits "
              "differ from K1's")
        check(n_pops == 0 and torch.equal(pops, row["pops"]),
              f"{tag} bounce {row['bounce']}: pops differ between launches")
        check(int(pops.sum()) == totals[0] + totals[1],
              f"{tag} bounce {row['bounce']}: pops sum {int(pops.sum())} "
              f"against {totals[0] + totals[1]}")
        check(p_err == 0 and walk_same,
              f"{tag} bounce {row['bounce']}: pops differ from the plain walk")
        check(model_same, f"{tag} bounce {row['bounce']}: the bench's rounds "
              "or lockstep differ from the per-ray arm's")
        if "done" in row:
            check(bool((row["rounds"] == row["done"].max(axis=1)).all()),
                  f"{tag} bounce {row['bounce']}: rounds != max(done)")
        check(int(peak.max()) <= bvh8.stack_bound,
              f"{tag} bounce {row['bounce']}: stack peak {int(peak.max())}")
        err = max(err, t_err, p_err)
    return err


def _time_pops(bvh8, row, what):
    """K1's pops launch (the warp kernel's pops instance) against its
    per-ray arm on one wavefront, in turns (per-ray, warp, warp, per-ray;
    each the least of 2 blocks of 5 launches), beside the uncounted warp
    and per-ray K1 (the least of 3 blocks); its plain version's time (one
    run; its pops must equal the kernel's on every lane), and its bound:
    K1's bound on these rays from a counted launch, plus the 4 bytes per
    lane the launch writes."""
    import torch
    from pt_torch.accel import kernels
    o, d, tmax = row["wavefront"]
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    limit = torch.full((n,), float(tmax), device=o.device)
    pops = torch.empty(n, dtype=torch.int32, device=o.device)
    counts = kernels.work_counts(bvh8)
    kernels.closest_bf8_per_ray(bvh8, o, d, limit, counts=counts)
    k1 = _bound(n, 16, counts, bvh8)
    res = dict(n=n, k1_bound_ms=k1["bound_ms"],
               **_bound_of(k1["bound_bytes"] + 4 * n, k1["bound_ops"]))
    arms = {"per_ray": [], "warp": []}
    fns = {"per_ray": kernels.closest_bf8_per_ray, "warp": kernels.closest_bf8}
    for arm in ("per_ray", "warp", "warp", "per_ray"):
        arms[arm].append(min(cuda_ms(lambda: fns[arm](
            bvh8, o, d, limit, pops=pops), reps=5) for _ in range(2)))
    res["ms"] = float(np.mean(arms["warp"]))
    res["per_ray_ms"] = float(np.mean(arms["per_ray"]))
    res["k1_ms"] = min(cuda_ms(lambda: kernels.closest_bf8(
        bvh8, o, d, limit), reps=5) for _ in range(3))
    res["per_ray_k1_ms"] = min(cuda_ms(lambda: kernels.closest_bf8_per_ray(
        bvh8, o, d, limit), reps=5) for _ in range(3))
    kernels.closest_bf8(bvh8, o, d, limit, pops=pops)
    out = {}
    res["plain_ms"] = cuda_ms(lambda: out.update(
        p=kernels.closest_bf8_walk_plain(bvh8, o, d, limit)), reps=1,
        warm=False)
    check(torch.equal(out["p"][1], pops),
          f"{what}: the plain walk's pops differ from the kernel's")
    log(f"[budget] A/B of the pops launch on {what}: {n} lanes, per-ray "
        f"{arms['per_ray'][0]:.3f} / {arms['per_ray'][1]:.3f} ms, warp "
        f"{arms['warp'][0]:.3f} / {arms['warp'][1]:.3f} ms "
        f"({res['per_ray_ms'] / res['ms']:.2f}x); beside the warp K1 "
        f"{res['k1_ms']:.3f} ms and the uncounted per-ray K1 "
        f"{res['per_ray_k1_ms']:.3f} ms (plain walk {res['plain_ms']:.1f} "
        f"ms, pops equal on every lane); bound {res['bound_ms']:.5f} ms by "
        f"{res['bound_by']} ({res['bound_bytes']} bytes: K1's "
        f"{k1['bound_bytes']} + 4 per lane; K1's bound {k1['bound_ms']:.5f} "
        f"ms): warp {res['ms'] / res['bound_ms']:.1f}x, per-ray "
        f"{res['per_ray_ms'] / res['bound_ms']:.1f}x the bound")
    return res


def phase_budget():
    """Phase 11: pt's frame budget (`pt_torch.benches.budget`, B1 rounds_of)
    at its defaults and pt's drain model (`.drain_sim`, B2 done_rounds_of)
    for the Heightfield and the Courtyard at COURT_TEX_SCALE, each run with
    the launch counters set to 0 just before and read just after; the
    checks of `_pops_checks` on every bounce's wavefront; the pops variant
    timed beside K1 on the bounce-0 and bounce-2 wavefronts of the budget
    (B1) and of the Heightfield's drain run (B2). Returns the two entry
    points' rows."""
    import torch
    from pt_torch.accel import kernels
    from pt_torch.benches import budget, drain_sim
    from pt_torch.scene.flatten import flatten_scene, world_vertices
    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    kernels.reset_launch_counts()
    bud = budget.main(device="cuda", emit=lambda line: log(f"[budget] {line}"))
    torch.cuda.synchronize()
    b_launches = {k: v for k, v in kernels.launches.items() if v}
    log(f"[budget] launches in budget.main: {b_launches}")
    check(b_launches.get("closest_bf8_pops") == len(bud["bounces"])
          and "closest_bf8_pops_per_ray" not in b_launches
          and b_launches.get("closest_bf8", 0) > 0
          and b_launches.get("occluded_bf8", 0) > 0,
          f"budget.main: launches {b_launches}")
    t1 = time.perf_counter()
    kernels.reset_launch_counts()
    drains = {scene: drain_sim.main(
        device="cuda", scene=scene, tex_scale=COURT_TEX_SCALE,
        emit=lambda line, s=scene: log(f"[drain] {line}"))
        for scene in ("heightfield", "courtyard")}
    torch.cuda.synchronize()
    d_launches = {k: v for k, v in kernels.launches.items() if v}
    log(f"[drain] launches in drain_sim.main (both scenes): {d_launches}")
    check(d_launches.get("closest_bf8_pops") == sum(
        len(r["bounces"]) for r in drains.values())
        and "closest_bf8_pops_per_ray" not in d_launches
        and d_launches.get("closest_bf8", 0) > 0,
        f"drain_sim.main: launches {d_launches}")
    t2 = time.perf_counter()
    # the Courtyard's texture cut: drain_sim shades with the default pool
    geo = []
    for scale in (COURT_TEX_SCALE, COURT_TEX_SCALE_PARITY):
        ds = flatten_scene(drain_sim.make_scene("courtyard",
                                                tex_scale=scale),
                           device="cuda")
        geo.append((world_vertices(ds)[0], ds.tri_idx, ds.tri_opaque))
    same = all(torch.equal(a, b) for a, b in zip(*geo))
    log(f"[drain] Courtyard at tex_scale {COURT_TEX_SCALE} and "
        f"{COURT_TEX_SCALE_PARITY}: {geo[0][1].shape[0]} triangles, world "
        f"vertices, indices and opacity bit-equal: {same} (the texture cut "
        "changes no triangle; drain_sim shades with the default pool)")
    check(same and geo[0][1].shape[0] == drains["courtyard"]["triangles"],
          "the Courtyard's texture cut changes its triangles")
    errs = {"rounds_of": _pops_checks("budget", bud["tree"], bud["bounces"],
                                      rng),
            "done_rounds_of": max(_pops_checks(f"drain {s}", r["tree"],
                                               r["bounces"], rng)
                                  for s, r in drains.items())}
    t3 = time.perf_counter()
    runs = {"rounds_of": (bud, "budget", b_launches),
            "done_rounds_of": (drains["heightfield"], "drain_sim Heightfield",
                               d_launches)}
    rows = {}
    for entry, (res, what, launches) in runs.items():
        tm = {b: _time_pops(res["tree"], res["bounces"][b],
                            f"{what} bounce {b}") for b in (0, 2)}
        rows[entry] = dict(tm[0], launches=launches["closest_bf8_pops"],
                           err=errs[entry], workload=f"{what} bounce 0",
                           ms_bounce2=tm[2]["ms"],
                           k1_ms_bounce2=tm[2]["k1_ms"],
                           per_ray_ms_bounce2=tm[2]["per_ray_ms"],
                           per_ray_k1_ms_bounce2=tm[2]["per_ray_k1_ms"],
                           plain_ms_bounce2=tm[2]["plain_ms"],
                           bound_ms_bounce2=tm[2]["bound_ms"])
    _log_build_of("budget", "bf8w", "Bf8PopsWalk")
    log(f"[budget] phase 11 in {time.perf_counter() - t0:.1f} s (budget.main "
        f"{t1 - t0:.1f} s, drain_sim.main {t2 - t1:.1f} s, checks "
        f"{t3 - t2:.1f} s, times {time.perf_counter() - t3:.1f} s)")
    return rows


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (ROOT / "pt_torch" / "accel" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no pt_torch/)")
    sys.path.insert(0, str(ROOT))
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass-against", metavar="CHECKOUT",
                    help="also compare every kernel library's machine code "
                    "with CHECKOUT's (pt_torch/benches/sass_diff.py)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    name, count, smi = phase_device()
    phase_build()
    phase_sass(args.sass_against)
    errs = phase_parity()
    counts, times, main_stats = phase_main()
    a_counts, a_times, anim_stats = phase_animated()
    phase_alpha()
    i_counts, i_times, inst_stats = phase_instanced()
    ar_launches, ar_rows, ar_stats = phase_archive()
    phase_courtyard()
    phase_default()
    phase_cross_device()
    b_rows = phase_budget()
    counts.update(a_counts)
    counts.update(i_counts)
    times.update(a_times)
    times.update(i_times)
    rows = []
    for k in KERNELS:
        tm = times[(k, 0)]
        rows.append({"name": k, "route": "cuda", "source": SOURCES[k],
                     "replaces": REPLACES[k], "launches": counts[k],
                     "max_abs_err": max(errs[k], tm["err"],
                                        times[(k, 2)]["err"]),
                     "ms": tm["ms"],
                     "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                     "bound_by": tm["bound_by"], "library_ms": None,
                     "wavefront": "bounce 0",
                     "ms_bounce2": times[(k, 2)]["ms"],
                     "plain_ms_bounce2": times[(k, 2)]["plain_ms"],
                     "bound_ms_bounce2": times[(k, 2)]["bound_ms"]})
        if k in PER_RAY:        # the in-call A/B against the first design
            rows[-1].update(per_ray_ms=tm["per_ray_ms"], ab_ms=tm["ab_ms"],
                            per_ray_ms_bounce2=times[(k, 2)]["per_ray_ms"],
                            ab_ms_bounce2=times[(k, 2)]["ab_ms"])
    for entry, (line, kernel) in ARCHIVE.items():
        tm = ar_rows[entry]
        rows.append({"name": entry, "route": "cuda",
                     "source": SOURCES[kernel],
                     "replaces": f"pt/accel/pallas_bvh_archive.py:{line} "
                                 f"{entry}",
                     "launches": ar_launches[entry],
                     "max_abs_err": tm["err"], "ms": tm["ms"],
                     "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                     "bound_by": tm["bound_by"], "library_ms": None,
                     "kernel": kernel, "workload": tm["workload"],
                     "lanes": tm["n"]})
        rows[-1].update({k: tm[k] for k in ("per_ray_ms", "ab_ms",
                                            "per_ray_ms_bounce2",
                                            "ab_ms_bounce2", "ab")
                         if k in tm})
    for entry, line in (("rounds_of", "benches/budget.py:56"),
                        ("done_rounds_of", "benches/drain_sim.py:40")):
        tm = b_rows[entry]
        rows.append({"name": entry, "route": "cuda",
                     "source": "pt_torch/accel/csrc/bf8_warp_kernels.cu",
                     "replaces": f"{line} {entry}",
                     "launches": tm["launches"], "max_abs_err": tm["err"],
                     "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                     "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                     "library_ms": None,
                     "kernel": "closest_bf8 (pops)",
                     "workload": tm["workload"], "lanes": tm["n"],
                     "k1_ms": tm["k1_ms"], "ms_bounce2": tm["ms_bounce2"],
                     "k1_ms_bounce2": tm["k1_ms_bounce2"],
                     "per_ray_ms": tm["per_ray_ms"],
                     "per_ray_ms_bounce2": tm["per_ray_ms_bounce2"],
                     "per_ray_k1_ms": tm["per_ray_k1_ms"],
                     "per_ray_k1_ms_bounce2": tm["per_ray_k1_ms_bounce2"],
                     "plain_ms_bounce2": tm["plain_ms_bounce2"],
                     "bound_ms_bounce2": tm["bound_ms_bounce2"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s; static main path "
        f"{json.dumps(main_stats)}; animated main path "
        f"{json.dumps(anim_stats)}; instanced main path "
        f"{json.dumps(inst_stats)}; archive path (b) "
        f"{json.dumps(ar_stats)}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
