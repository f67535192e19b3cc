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
   counters set to 0 just before and read just after (exactly 51
   closest_bf8 and 51 occluded_bf8 launches: per step one merged bounce 0
   of the four samples, then four tails of 4 bounces); film checks, a PNG
   through `postprocess` + `write_image`, ms per render step, Mrays/s, peak
   memory, one more block of 3 steps for the spread within the call, a
   torch.profiler breakdown of one sample, and K1/K2's CUDA-event time on
   the real bounce-0 and bounce-2 wavefronts against plain version and bound;
   the A/B of K1's and K2's two designs on the same wavefronts (per-ray,
   warp, warp, per-ray), the plain warp schedule's groups, lanes per group
   and chunks staged there, and ptxas's -v line and resident blocks of the
   warp K1 and K2;
4b. the render loop (`[loop]` lines), on the Heightfield at 512², 5
   bounces, 4 spp: the film with wavefront compaction on and off (every
   size class patched huge) bit-equal over two steps; eight render(1)
   calls bit-equal to two render(4) steps; exactly 17 closest_bf8 and 17
   occluded_bf8 launches a step and the lane count of each (the merged
   1,048,576-lane bounce 0, then each tail's wavefront or compacted
   class); ms per step, Mrays/s and peak memory of the loop against the
   per-sample uncompacted loop the port ran before, in turns (loop,
   per-sample, per-sample, loop, twice) in this call, their films
   bit-equal, and a torch.profiler breakdown of one step of each; a
   second `set_scene` of the same scene served from the accel cache; the
   Default scene streamed and waited for, bit-equal to the unstreamed
   film at 64²; `render_adaptive` at tol=0 bit-equal to the uniform film
   at 512², and at tol=0.05 card against CPU (film MSE < 1e-3) on the
   Default at 64²; `python -m pt_torch.run.cli render --adaptive` in this
   process (exit code 0, the PNG decoded). The trace wavefronts that the
   other phases record for timing and parity are taken with compaction
   off: each is the full per-sample wavefront of 262,144 lanes, as before
   the loop compacted. The accel cache is emptied before each phase;
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
   and the static one (split trees, K1/K2, and one round kernel a round,
   `alpha_closest_round` / `alpha_shadow_round`), with checks that decals
   and accepted alpha hits occur;
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
   pixels, mean film shift <= 2%; its launches (K1/K2 only: 51/51 in 3
   steps, 459/51 with the cards) and, opaque, the A/B of K1's two designs
   on its bounce-0 and bounce-2 wavefronts;
8. archive: `pt`'s archive kernels through the entry points that select
   them (`pt_torch.accel.archive`), with the launch and call counters set to
   0 before each run and read after. Path (a): `pt_torch.benches.bvh_kernels`
   and `.widesub_ab` (Heightfield and Courtyard) at 65,536 rays, every arm
   with 0 oracle mismatches and the occlusion arms agreeing with v1, one
   JSON line per arm with its CUDA-event time. Path (b): the Heightfield at
   512², 5 bounces, 4 spp with its tree swapped for a BF8V6 (exactly 51
   closest_v6 and 51 occluded_v6 launches in 3 steps, no K1/K2), against the
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
   segments, above the cap: the flat BF8 path with split trees); then the
   latter at the 4K still's 3840x2160, 1 spp: each call of the two split
   loops at bounce 0 and bounce 2 runs once through the round kernels and
   once through their plain twins (`_round_kernel_args` patched to None)
   on the same inputs, hits, decals and occlusion bit-equal, one round
   kernel a round, each round timed by CUDA events in both arms beside its
   bytes bound from its lanes (the kernels line's two R1 rows); the Default
   scene (embedded PNG textures) at 512², written to a PNG;
10. cross-device film, card (kernels) against CPU (plain versions), MSE <
    1e-3 each: the Heightfield (n=64) at 64², 1 spp, 3 bounces; two animated
    alpha frames, the static alpha variant and a small instanced alpha scene
    at 32²;
10b. entry (`[entry]` lines), the main path's two callers, launch counters
    set to 0 just before each call and read just after:
    `render_image_stats` on the Heightfield (n=224, its Morton tree) at
    512², 5 bounces, 4 spp, one warm call and 3 timed ones (ms per call,
    useful Mrays/s, peak memory; exactly 20 closest_v4 and 20 occluded_v4
    launches a call, nothing else, no plain version called); the same work
    on the Animated Heightfield through `Renderer` (update, rebuild, render)
    and through `render_image_stats` in turns (R, S, S, R twice), and a
    torch.profiler breakdown of one `render_image_stats` sample; card
    against the CPU (film MSE < 1e-3) on the Default at `entry()`'s
    settings (32², 1 spp, 3 bounces) and the Heightfield (n=64) at 64², 2
    spp; `pt_torch.run.cli.main(["render", ...])` with no --device on the
    Default at 512², 4 spp, 5 bounces (exit code 0, the PNG decoded by the
    port's decoder, 17 closest_bf8 and 17 occluded_bf8 launches, wall
    seconds) and at 32², 2 spp, to HDR with no --device against --device cpu
    (film MSE < 1e-3); an OfflineRenderer render of 2 spp, checkpointed
    and resumed to 4, bit-equal to an uninterrupted 4-spp render; and
    `list-scenes`, `pt`'s seven "Test Scenes" in `pt`'s order;
10c. debug, HDR10 and stats (`[debug]` lines), launch counters set to 0
    just before each call and read just after: `render_debug_image` with
    the kernel backend on the Heightfield (n=224, its Morton tree) at
    640x480, `pt`'s `debug` size, in each of the 8 modes and in COLOR mode
    without shadows: exactly 1 closest_v4 launch a frame, 1 occluded_v4
    more in COLOR mode with shadows, no brute-force call, ms per frame (CUDA
    events; the frame's Morton build included); at 128x96 the kernel frames
    against brute force on the card, and on the Heightfield n=32 the card
    against the CPU (the CPU's brute-force plain versions take minutes per
    frame at n=224), each at most 0.5% of the pixels off by more than 1e-4;
    the static alpha variant at 256²: the see-through frame traces K3 in
    the single-tree alpha loop (ALPHA_ROUNDS launches, as many as the CPU
    run's plain calls on a small variant, whose frames also agree card
    against CPU), force-opaque once, and force-opaque, cull-backfaces and
    disable-color-texture each change the frame; `python -m
    pt_torch.run.cli debug --mode normal` in this process (the Default,
    640x480, brute force as in `pt`: no launch; the PNG decoded); HDR10:
    the Default at 512², 5 bounces, 4 spp through `Renderer` (17
    closest_bf8 + 17 occluded_bf8 a step) with `snapshot(hdr=True)`, the
    PQ image card against CPU at 256² (MSE < 1e-3), and `render --hdr`
    through the CLI (the PNG decoded, 17 + 17 launches); the `stats`
    command in this process (brute: no launch; the board holds `pt`'s
    keys);
10d. scene import and file output (`[import]` lines), launch counters set
    to 0 just before each call and read just after: the Courtyard at
    detail 1.0 (COURT_TEX_SCALE) exported by the port's exporter with
    Pillow unimportable and reimported (triangle and alpha-tested counts
    equal to the built-in scene's, its lights, at least 40 textures and a
    camera); `render --scene <that glb>` at 512², 2 spp, 5 bounces with no
    --device (exit code 0, the PNG decoded, only K1/K2 launched, or K5/K6
    where "auto" picks shared BLAS, no plain version called, wall
    seconds); the accel build of the imported and the built-in scene; the
    imported film against the built-in scene's as the file carries it
    (MSE < 1e-3; the exporter, as `pt`'s, drops a roughness texture
    separate from the metallic one, and glTF has no skybox: the film of
    the unchanged scene is logged); a small Courtyard glb card against CPU
    at 32² (MSE < 1e-3); a node-animated glb of the Heightfield n=224
    through `Renderer`, 3 frames of 4 spp at 512² (17 closest_v4 + 17
    occluded_v4 a step), and at n=16 card against CPU; every scene fixture
    of `tests/data` through `render` at 32², 1 spp, card against CPU
    (MSE < 1e-3); the DDS fixtures through `load_texture_mips` and the
    pool (card equal to CPU); ffmpeg and Pillow logged, 3 frames at 64² to
    numbered PNGs, and `--format mp4` through ffmpeg where present and the
    MJPEG AVI where Pillow is (each frame within a mean 8 of 255 of the
    PNG frame);
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
    logs its own seconds;
12. the LBVH backend (`[bvh]` lines), `pt`'s threaded LBVH walked in
    tensor code, no kernel: ids exact against brute force on 65,536 random
    rays over 4,096 random triangles (the any-hit query too; conditions
    tested every step and every 8 bit-equal); `render --backend bvh` on
    the Default at 512², 4 spp through the CLI; one 1-spp, 1-bounce step
    on the Heightfield n=224 at 512² (build ms, ms, lockstep steps and host
    syncs a trace, µs a step); one 4-spp, 5-bounce step at 512² on the
    Heightfield cut to BVH_N (ms a step, its film against the kernels'
    film, MSE < 1e-3) and at 64² card against CPU (MSE < 1e-3). Every
    tree tensor on the card; no kernel launch, plain version or brute
    force;
13. the lane-order knobs (`[knobs]` lines), off and on in turns at 512²,
    4 spp, 5 bounces: `sort_rays` on the Animated Heightfield (17 K3 + 17
    K4 a step either way), `shade_sorted` on the Heightfield (17 K1 + 17
    K2); films bit-equal, ms a step of each arm;
13b. multi-device rendering (`[dist]` lines): one gang of 4 ranks on the
    card over gloo (`pt_torch.dist.launch.Gang`), started once; the
    Heightfield n=224 at 512², 5 bounces, 4 spp. `render_image_sharded`
    over the 4 ranks: the bands joined bit-equal to `render_image_stats`
    here, rays equal, each rank 20 closest_v4 + 20 occluded_v4 (launch
    counters set to 0 just before and read just after) and no plain
    version; the 2-D meshes 4x1 and 1x4 bit-equal to the 1-D modes, the
    2x2 mean 1.5-2.6x and the spp mode's 3-5x the single film's;
    `Renderer(mesh=)` over 1, 2 and 4 ranks: one render(4) step's film and
    rays bit-equal to one device's Renderer here, also with compaction off,
    each rank 17 closest_bf8 + 17 occluded_bf8 and no plain version, then
    3 timed steps (ms a step, Mrays/s over the ranks, peak MiB per rank:
    the ranks share one card, so this is no scaling figure);
    `render_adaptive` at tol=0 bit-equal to one device's; `OfflineRenderer`
    under the mesh writes one PNG, its bytes equal to a 1-rank mesh's; the
    sharded film at 64² against the CPU's (MSE < 1e-3);
14. the viewer (`[view]` lines), last, since it re-imports the shading
    modules in this process: `run_viewer` on a loopback port in a thread
    over an `Application` on the card, the Heightfield at 512²; over HTTP
    /frame and /state (the JPEG within a mean 8 of 255 of the snapshot it
    was published from), W held through /input (the camera moves, the
    film restarts), /settings, /scene to the Animated Heightfield (only
    K3/K4 from then on), the H key (`reload_shaders`), the render trigger
    (a PNG); frames a second, JPEG ms and the launches a frame; no plain
    call.

Phase 3 also holds K5 (closest_bf8i, with raw_ids) and K6 (occluded_bf8i,
with opaque_only), the warp kernels, against their plain versions over the
64-instance tree and over the three trees of the Courtyard at detail 0.85
(lanes that differ at |dt| = 0, exact ties between leaves, are counted
apart), and bit-equal to their per-ray arm (closest_bf8i_per_ray,
occluded_bf8i_per_ray) on every lane of the same sets.

Prints the kernels' JSON line (K1-K6, each with its per-ray arm's time
from the A/B, and for K1-K4 `launches_entry`, their launches in phase
10b's CLI render (K1/K2) or in one `render_image_stats` call (K3/K4), and
from phase 10c `launches_hdr` (K1/K2: a 4-spp HDR10 step) and
`launches_debug` (K3: a debug frame, and `launches_debug_alpha` in the
alpha loop; K4: a COLOR frame with shadows), from phase 10d
`launches_import` (K1/K2, or K5/K6: the imported Courtyard's CLI render;
K3/K4: a 4-spp step of the animated import), from phase 14
`launches_view` (K1/K2: a viewer frame of the Heightfield; K3/K4: one of
the Animated Heightfield), from phase 13b `launches_dist` (per rank of
the 4: K1/K2 in a `Renderer(mesh=)` render(4) step, K3/K4 in a
`render_image_sharded` call), then one row per archive
entry point, with the kernel it
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

import io
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
# the Heightfield's grid size in [bvh]'s 4-spp Renderer cell and its card
# against CPU film: cut from 224, where one 4-spp step of the threaded walk
# took 67.6 s; a 1-spp, 1-bounce step keeps n=224 (BVH_FULL_N)
BVH_N = 64
BVH_FULL_N = 224
BVH_RAYS = 65536    # random rays of [bvh]'s gate against brute force
VIEW_N = 224        # the Heightfield of [view], static and animated

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
    fill_animated_scene(b, ns, n, n_cards, animate, seed)
    return b.create_scene()


def fill_animated_scene(b, ns, n: int = 224, n_cards: int = 0,
                        animate: bool = True, seed: int = 7) -> None:
    """`build_animated_scene`'s content, added to the builder `b` (what a
    scene manager's loader does with the builder it is handed)."""
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
              instancing: str = "auto", backend: str = "pallas"):
    """A Renderer on `device` for `scene` (an int n: the static Heightfield
    of that grid size)."""
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.renderer import Renderer
    from pt_torch.scene.examples import make_heightfield_scene
    r = Renderer(PathTracingSettings(sample_count=spp, bounce_count=bounces,
                                     backend=backend),
                 device=device, instancing=instancing)
    r.set_scene(make_heightfield_scene(scene) if isinstance(scene, int)
                else scene, stream_textures=False)
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
    and timing on the real wavefronts). Calls go through unchanged, and
    the renderer compacts nothing within the block: each recorded trace of
    a render(1) is the sample's full film-wide wavefront."""

    def __init__(self):
        from pt_torch.render import integrator
        from pt_torch.run import renderer
        self.mod = integrator
        self.loop = renderer
        self.closest = []
        self.occluded = []

    def __enter__(self):
        import torch
        m = self.mod
        self._orig = (m.trace_closest, m.trace_occluded)
        self._compact = self.loop._compact

        def whole(carry, k):
            return carry, torch.arange(carry.alive.shape[0],
                                       device=carry.alive.device)
        self.loop._compact = whole

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
        self.loop._compact = self._compact


class _LaneLog:
    """The lane count of every trace call of the integrator within the
    block, in call order."""

    def __enter__(self):
        from pt_torch.render import integrator
        self.mod = integrator
        self._orig = (integrator.trace_closest, integrator.trace_occluded)
        self.closest, self.occluded = [], []

        def logged(fn, into):
            def call(bvh, o, d, t):
                into.append(int(o.shape[0]))
                return fn(bvh, o, d, t)
            return call
        integrator.trace_closest = logged(self._orig[0], self.closest)
        integrator.trace_occluded = logged(self._orig[1], self.occluded)
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
    # per step: one merged bounce 0 of the four samples, then four tails of
    # 4 bounces, a closest and a shadow trace each
    for k, v in counts.items():
        check(v == 3 * 17, f"kernel {k}: {v} launches in 3 steps, not 51")
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


def _per_sample_step(r, samples: int) -> None:
    """One render step of the per-sample loop the port ran before `pt`'s:
    each sample one film-wide wavefront through raygen and every bounce,
    uncompacted, then the film's scatter-add; the same RNG seeding, so the
    same film. The reference arm of the [loop] timing."""
    from pt_torch.render.integrator import (_finite_or_zero, bounce_once,
                                            init_rng_state, raygen,
                                            start_carry)
    r._ensure_accel()
    inv_view, inv_proj = r._camera_mats()
    flat = r.accum.view(-1, 3)
    for rep in range(samples):
        state = init_rng_state(r._px, r._py, r.width,
                               (r.total_samples + rep) & 0xFFFFFFFF)
        state, o, d, diff = raygen(r._px, r._py, r.width, r.height,
                                   inv_view, inv_proj, state, r.settings)
        carry = start_carry(state, o, d, diff)
        for bounce in range(r.settings.bounce_count):
            carry = bounce_once(r.ds, r.tex, r.accel, carry, r.settings,
                                bounce)
        flat.index_add_(0, r._film_perm, _finite_or_zero(carry.radiance))
        r._rays_chunks.append(carry.rays)
    r.total_samples += samples


def phase_loop():
    """The render loop (`[loop]` lines): compaction and spp-major groups
    against the per-sample loop, the accel cache, texture streaming and the
    adaptive film, on the card."""
    import torch
    from pt_torch.accel import kernels
    from pt_torch.run import renderer as loop
    from pt_torch.scene.examples import (make_default_scene,
                                         make_heightfield_scene)
    from pt_torch.scene.textures import decode_png
    t0 = time.perf_counter()
    spp, bounces, width = 4, 5, 512
    n = width * width
    scene = make_heightfield_scene(224)

    # the accel cache: the first build, then the same scene again
    r = _renderer(scene, width, spp, bounces, "cuda")
    tb = time.perf_counter()
    r._ensure_accel()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - tb
    tree = r.accel.bvh
    tb = time.perf_counter()
    r.set_scene(scene, stream_textures=False)
    r._ensure_accel()
    torch.cuda.synchronize()
    again_s = time.perf_counter() - tb
    check(r.accel.bvh is tree, "[loop] a second set_scene rebuilt the tree")
    log(f"[loop] accel cache, Heightfield n=224: first build {first_s:.3f} "
        f"s, a second set_scene of the same scene {again_s:.3f} s "
        f"(flatten, attributes and the key; the tree from the cache)")

    # compaction on and off, two steps each
    r.render()                          # sample 0 observes, 1-3 compact
    r.render()
    plan = r._plans[("tail", n)]
    check(min(plan) <= n // 2, f"[loop] the plan {plan} compacts nothing")
    size_class = loop._size_class
    loop._size_class = lambda k, minimum=1024: 1 << 30
    try:
        off = _renderer(scene, width, spp, bounces, "cuda")
        off.render()
        off.render()
        check(all(c == 1 << 30 for c in off._plans[("tail", n)]),
              "[loop] the patched plan")
    finally:
        loop._size_class = size_class
    same = torch.equal(r.accum, off.accum)
    log(f"[loop] compaction on (plan {plan} for bounces 1-4) and off, two "
        f"steps of 4 spp: films bit-equal: {same}; rays {r.rays_traced} "
        f"and {off.rays_traced}")
    check(same and r.rays_traced == off.rays_traced,
          "[loop] compaction changed the film")
    del off

    # spp-major groups: eight render(1) calls against two render(4) steps
    single = _renderer(scene, width, 1, bounces, "cuda")
    for _ in range(4):
        single.render(1)
    accum4 = single.accum.clone()
    for _ in range(4):
        single.render(1)
    same = torch.equal(r.accum, single.accum)
    log(f"[loop] two render(4) steps against eight render(1) calls: films "
        f"bit-equal: {same}")
    check(same, "[loop] the grouped film differs from the per-sample one")
    del single

    # one step: its launches and the lanes of each
    kernels.reset_launch_counts()
    with _LaneLog() as lanes:
        r.render()
    torch.cuda.synchronize()
    got = {k: v for k, v in kernels.launches.items() if v}
    check(got == {"closest_bf8": 17, "occluded_bf8": 17},
          f"[loop] a step launched {got}")
    tails = [lanes.closest[1 + 4 * i:5 + 4 * i] for i in range(4)]
    check(lanes.closest[0] == 4 * n and lanes.occluded[0] == 4 * n
          and all(t[0] == n and all(c <= n and c % 1024 == 0
                                    and c & (c - 1) == 0 for c in t[1:])
                  for t in tails) and lanes.closest == lanes.occluded,
          f"[loop] lanes a launch {lanes.closest} / {lanes.occluded}")
    log(f"[loop] one step, 512x512, 5 bounces, 4 spp: launches {got}; lanes "
        f"a closest launch: bounce 0 merged {lanes.closest[0]}, then the "
        f"four tails (bounces 1-4) {tails}; the shadow launches the same")

    # the loop against the per-sample loop, in turns
    ps = _renderer(scene, width, spp, bounces, "cuda")
    ps._ensure_accel()
    _per_sample_step(ps, spp)           # warm
    ps.reset_accumulation()
    turns = {"loop": [], "per-sample": []}
    peaks = {"loop": [], "per-sample": []}
    rays = {"loop": 0, "per-sample": 0}
    secs = {"loop": 0.0, "per-sample": 0.0}
    for name in ("loop", "per-sample", "per-sample", "loop") * 2:
        arm = r if name == "loop" else ps
        rays0 = arm.rays_traced
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ta = time.perf_counter()
        if name == "loop":
            r.render()
        else:
            _per_sample_step(ps, spp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - ta
        turns[name].append(dt * 1e3)
        secs[name] += dt
        peaks[name].append(torch.cuda.max_memory_allocated() / 2**20)
        rays[name] += arm.rays_traced - rays0
    mean = {k: sum(v) / len(v) for k, v in turns.items()}
    mrays = {k: rays[k] / secs[k] / 1e6 for k in turns}
    log(f"[loop] in turns (loop, per-sample, per-sample, loop, twice), "
        f"Heightfield "
        f"n=224, 512x512, 5 bounces, 4 spp, ms per step: "
        + "; ".join(f"{k} {', '.join(f'{v:.1f}' for v in vs)} (mean "
                    f"{mean[k]:.1f}, {mrays[k]:.3f} useful Mrays/s, peak "
                    f"{max(peaks[k]):.0f} MiB)" for k, vs in turns.items())
        + f"; loop / per-sample {mean['loop'] / mean['per-sample']:.3f}")
    # the per-sample arm's four steps are samples 0-15 of a fresh film
    ref = _renderer(scene, width, spp, bounces, "cuda")
    for _ in range(4):
        ref.render()
    same = torch.equal(ps.accum, ref.accum)
    check(same, "[loop] the per-sample loop's film differs from the loop's")
    log(f"[loop] the per-sample arm's film (16 spp) bit-equal to the "
        f"loop's: {same}")
    del ref
    _profile(r.render, "the loop, one step (4 spp, 5 bounces, 512x512)",
             top=8)
    _profile(lambda: _per_sample_step(ps, spp),
             "the per-sample loop, one step (4 spp, 5 bounces, 512x512)",
             top=8)
    del ps

    # render_adaptive at tol=0 against the uniform film of the same samples
    ra = _renderer(scene, width, 1, bounces, "cuda")
    stats = ra.render_adaptive(tol=0.0, max_spp=4, min_spp=1, check_every=4)
    same = torch.equal(ra.accum, accum4)
    log(f"[loop] render_adaptive tol=0, max_spp 4, 512x512: {stats}; film "
        f"bit-equal to four render(1) calls: {same}; plan "
        f"{ra._plans.get(('full', n))}")
    check(same and stats["spp_min"] == stats["spp_max"] == 4,
          "[loop] the tol=0 adaptive film differs from the uniform one")
    del ra, r

    # the Default scene streamed and waited for, against the unstreamed
    films = {}
    for stream in (True, False):
        d = loop.Renderer(loop.PathTracingSettings(sample_count=2,
                                                   bounce_count=bounces),
                          device="cuda")
        d.set_scene(make_default_scene(), stream_textures=stream)
        d.on_resize(64, 64)
        if stream:
            check(d.tex.count < 9 + 4, "[loop] no placeholder pool")
            d.wait_for_textures()
        d.render()
        films[stream] = d.accum
    same = torch.equal(films[True], films[False])
    log(f"[loop] Default 64x64, 2 spp: streamed and waited for against "
        f"unstreamed, films bit-equal: {same}")
    check(same, "[loop] the streamed film differs")

    # render_adaptive at tol=0.05, card against CPU
    out = {}
    for dev in ("cuda", "cpu"):
        d = loop.Renderer(loop.PathTracingSettings(sample_count=1,
                                                   bounce_count=3),
                          device=dev)
        d.set_scene(make_default_scene(), stream_textures=False)
        d.on_resize(64, 64)
        st = d.render_adaptive(tol=0.05, max_spp=16, min_spp=2,
                               check_every=2)
        out[dev] = (d.film_mean(), st)
    mse = float(np.mean((out["cuda"][0] - out["cpu"][0]) ** 2))
    log(f"[loop] render_adaptive tol=0.05, Default 64x64, 3 bounces: card "
        f"{out['cuda'][1]}, CPU {out['cpu'][1]}; film MSE {mse:.3e} (limit "
        f"1e-3)")
    check(bool(np.isfinite(mse)) and mse < 1e-3,
          f"[loop] adaptive film MSE {mse}")

    # the CLI with --adaptive, in this process
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    png = OUT_DIR / "cli_adaptive_64.png"
    rc, _, cli_s, cli_launches = _cli(
        ["render", "--scene", "Test Scenes/Default", "--size", "64x64",
         "--spp", "16", "--bounces", "3", "--adaptive", "0.05", "--out",
         str(png)])
    check(rc == 0, f"[loop] cli render --adaptive returned {rc}")
    decoded = decode_png(png.read_bytes())
    check(decoded.shape[:2] == (64, 64) and int(decoded[..., :3].max()) > 0,
          f"[loop] cli --adaptive PNG decodes to {decoded.shape}")
    log(f"[loop] python -m pt_torch.run.cli render --adaptive 0.05 --size "
        f"64x64 --spp 16 --bounces 3: rc 0, {cli_s:.2f} s wall, launches "
        f"{cli_launches}")
    log(f"[loop] phase: {time.perf_counter() - t0:.1f} s")
    return dict(ms=mean, mrays=mrays, peak_mib={k: max(v) for k, v in
                                                peaks.items()},
                turns_ms=turns, lanes=lanes.closest)


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
        check(v == 17 * ANIM_FRAMES,
              f"kernel {k}: {v} launches in {ANIM_FRAMES} frames, not "
              f"{17 * ANIM_FRAMES}")
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
    # per bounce 4 rounds of the closest loop and 4 of the shadow loop,
    # each a closest-hit trace of the whole tree; a frame traces the 2
    # samples' bounce 0 merged, then 2 tails of 2 bounces
    check(counts["closest_v4"] == frames * (1 + 2 * 2) * 8
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
    # + 4 alpha closest traces, and a round kernel after each alpha trace
    check(names == {"BF8BVH"} and counts["closest_bf8"] == 3 * 9
          and counts["occluded_bf8"] == 3 and counts["closest_v4"] == 0
          and counts["alpha_closest_round"] == 3 * 4
          and counts["alpha_shadow_round"] == 3 * 4,
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
    _failed_subset_trees()


def _failed_subset_trees():
    """A static alpha scene whose two subset SBVH builds are made to fail
    (each subset under `pt`'s 4096-triangle cap): the split stays, each
    subset gets its Morton tree built on the card, and the step runs K3/K4
    only, with no brute-force call. Its film against the same scene's
    film over the BF8 subset trees (the same hits)."""
    import torch
    from pt_torch.accel import kernels
    from pt_torch.run import renderer as trend
    scene = build_animated_scene(port_namespace(), 32, 600, animate=False)
    films = {}
    real = trend.build_packet_bvh_sah
    saved = trend.Renderer._accel_cache
    for arm in ("bf8", "failed"):
        trend.Renderer._accel_cache = None
        r = _renderer(scene, 256, 1, 3, "cuda")
        opq = r.ds.tri_opaque.cpu().numpy()
        sizes = {int(opq.sum()), int((~opq).sum())}
        check(max(sizes) <= trend._FAILED_SUBSET_MAX
              and len(opq) not in sizes,
              f"failed subsets: subset sizes {sizes} of {len(opq)}")
        if arm == "failed":
            trend.build_packet_bvh_sah = (
                lambda wpos, rows, *a, **k: None if len(rows) in sizes
                else real(wpos, rows, *a, **k))
        try:
            r.render()                                # builds the trees
        finally:
            trend.build_packet_bvh_sah = real
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with _BruteCalls() as brute:
            t1 = time.perf_counter()
            r.render()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
        counts = {k: v for k, v in kernels.launches.items() if v}
        sp = r.accel.alpha_split
        names = (None if sp is None else
                 (type(sp.bvh_opaque).__name__, type(sp.bvh_alpha).__name__))
        want_tree, closest, occluded = (
            ("BF8BVH", "closest_bf8", "occluded_bf8") if arm == "bf8" else
            ("PacketBVH", "closest_v4", "occluded_v4"))
        # per bounce 1 opaque + 4 alpha closest traces, then 1 opaque
        # occlusion + 4 alpha closest traces, all on the subset trees, and
        # a round kernel after each alpha trace
        check(names == (want_tree, want_tree)
              and counts == {closest: 3 * 9, occluded: 3,
                             "alpha_closest_round": 3 * 4,
                             "alpha_shadow_round": 3 * 4}
              and brute.calls == 0,
              f"failed subsets, {arm} arm: trees {names}, launches "
              f"{counts}, {brute.calls} brute calls")
        films[arm] = r.film_mean()
        log(f"[alpha] failed subsets, {arm} arm: {len(opq)} triangles "
            f"(subsets {sorted(sizes)}), subset trees {names}, 256x256, 3 "
            f"bounces, 1 spp: {ms:.1f} ms per step, launches {counts}, "
            f"{brute.calls} brute calls")
    trend.Renderer._accel_cache = saved
    mse = float(np.mean((films["failed"] - films["bf8"]) ** 2))
    check(bool(np.isfinite(films["failed"]).all()) and mse < 1e-3,
          f"failed subsets: film MSE {mse:.3e} against the BF8 split")
    log(f"[alpha] failed subsets: film MSE {mse:.3e} against the BF8 "
        f"subset trees' film (bound 1e-3)")


def _counted_steps(r, names, steps: int = 3):
    """`steps` render steps with the launch counters set to 0 just before
    and read just after: (seconds, launches of `names`, all launches, useful
    rays, peak MiB; None for a renderer on the CPU)."""
    import torch
    from pt_torch.accel import kernels
    cuda = r.device.type == "cuda"
    rays0 = r.rays_traced
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    for _ in range(steps):
        r.render()
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    every = dict(kernels.launches)
    return (dt, {k: every[k] for k in names}, every, r.rays_traced - rays0,
            torch.cuda.max_memory_allocated() / 2**20 if cuda else None)


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
            # per step 17 bounces (a merged bounce 0, then 4 tails of 4);
            # per bounce a closest and a shadow trace, or on the alpha
            # scene 9 closest (1 opaque + 4 alpha, 4 alpha for the shadow
            # rays) and 1 occlusion
            per = (9, 1) if alpha else (1, 1)
            # and on the alpha scene one round kernel a round, 4 + 4
            rounds = {"alpha_closest_round": 51 * 4,
                      "alpha_shadow_round": 51 * 4} if alpha else {}
            check(all(every[k] == v for k, v in rounds.items()),
                  f"{tag} {mode}: round kernels {every}")
            if mode == "auto":
                check(counts == {"closest_bf8i": 51 * per[0],
                                 "occluded_bf8i": 51 * per[1]}
                      and sum(every.values()) == sum(counts.values())
                      + sum(rounds.values()),
                      f"{tag}: launches {every}")
                log(f"[{tag}] BF8Instanced {_describe_instanced(r.accel.bvh)}"
                    + ("" if sp is None else
                       f"; opaque tree {_describe_instanced(sp.bvh_opaque)}; "
                       f"alpha tree {_describe_instanced(sp.bvh_alpha)}"))
            else:
                check(every["closest_bf8"] == 51 * per[0]
                      and every["occluded_bf8"] == 51 * per[1]
                      and sum(every.values()) == 51 * sum(per)
                      + sum(rounds.values()),
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
        check(counts == {used[0]: 51, used[1]: 51}
              and sum(every.values()) == 102,
              f"{kind}: launches in 3 steps {every}")
        check(calls == ({"packet_closest_v6": 51, "packet_occluded_v6": 51}
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
        # a step: the 2 samples' bounce 0 merged, then 2 tails of 4; a
        # round kernel after each of a bounce's 8 alpha traces
        check(counts == {used[0]: 2 * 9 * 9, used[1]: 2 * 9}
              and every["alpha_closest_round"] == 2 * 9 * 4
              and every["alpha_shadow_round"] == 2 * 9 * 4
              and sum(every.values()) == sum(counts.values()) + 2 * 9 * 8,
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
        if mode == "auto":
            rounds = _round_kernels_4k(r)
        del r
    return rounds


# least bytes of a round (alpha_round_kernels.cu): N + a P + b H with bf16
# texels, b + 32 with f32
ROUND_BYTES = {"closest": (45, 120), "shadow": (33, 93)}


def _round_kernels_4k(r):
    """The split loops' round kernels on the 4K still's wavefronts: `r`
    (the flat Courtyard) at 3840x2160, one sample. Each call of a split loop
    at bounce 0 and bounce 2 runs with the round kernels and again with the
    plain twins on the same inputs (the launch counts reset before each);
    its hits, decals and occlusion must be bit-equal. Each round is timed
    between two CUDA events behind a device sleep in both arms, with its N
    lanes, P pending and H that fetch a texel, and its bytes bound. Returns
    the kernels line's R1 rows, by kernel."""
    import torch
    from pt_torch.accel import kernels
    from pt_torch.render import integrator as integ
    r.on_resize(3840, 2160)
    kernels.reset_launch_counts()
    r.render(1)                                   # warm at this size
    torch.cuda.synchronize()
    per_sample = dict(kernels.launches)
    check(per_sample["alpha_closest_round"] == 5 * integ.ALPHA_ROUNDS
          and per_sample["alpha_shadow_round"] == 5 * integ.ALPHA_ROUNDS,
          f"[rounds] a 4K sample launched {per_sample}")
    extra = 0 if r.tex.data.dtype == torch.bfloat16 else 32
    loops = {"closest": integ._trace_closest_alpha_split,
             "shadow": integ._trace_occluded_alpha_split}
    rounds = {"closest": integ._closest_round,
              "shadow": integ._shadow_round}
    kernel_args = integ._round_kernel_args
    calls = {"closest": 0, "shadow": 0}
    armed = []          # the rounds of the arm that runs, while one runs
    res = {}

    def timed_round(loop):
        def run(ds, tex, accel, sp, st, dirs, hit, last):
            if not armed:
                return rounds[loop](ds, tex, accel, sp, st, dirs, hit, last)
            fetch = st.pending & (hit.tri >= 0)
            if loop == "closest":
                fetch &= st.t_accum + hit.t < st.bound
            lanes = torch.stack([st.pending.sum(), fetch.sum()])
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            # as in cuda_ms: the host queues the round before it starts
            torch.cuda._sleep(40_000_000)
            e0.record()
            out = rounds[loop](ds, tex, accel, sp, st, dirs, hit, last)
            e1.record()
            armed[-1].append((lanes, e0, e1))
            return out
        return run

    def bits(a):
        return a.view(torch.int32) if a.dtype == torch.float32 else \
            a.to(torch.int32)

    def twice(loop):
        def run(*a, **k):
            bounce = calls[loop]
            calls[loop] += 1
            if bounce not in (0, 2):
                return loops[loop](*a, **k)
            arms = {}
            for arm in ("kernel", "plain"):
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                armed.append([])
                if arm == "plain":
                    integ._round_kernel_args = lambda *x: None
                try:
                    out = loops[loop](*a, **k)
                finally:
                    integ._round_kernel_args = kernel_args
                torch.cuda.synchronize()
                arms[arm] = (out, armed.pop(),
                             kernels.launches[f"alpha_{loop}_round"])
            (got, k_rounds, k_n), (want, p_rounds, p_n) = \
                arms["kernel"], arms["plain"]
            flat = ((lambda o: (*o[0], *o[1:])) if loop == "closest" else
                    (lambda o: (o,)))
            differ = [int((bits(x) != bits(y)).sum())
                      for x, y in zip(flat(got), flat(want))]
            n = a[4].shape[0]
            check(k_n == integ.ALPHA_ROUNDS and p_n == 0
                  and not any(differ),
                  f"[rounds] {loop} loop, bounce {bounce} ({n} lanes): "
                  f"{k_n} and {p_n} round launches, lanes differing "
                  f"{differ}")
            a_p, b_h = ROUND_BYTES[loop]
            rows = []
            for (lanes, e0, e1), (_, q0, q1) in zip(k_rounds, p_rounds):
                pend, fetch = (int(x) for x in lanes)
                nbytes = n + a_p * pend + (b_h + extra) * fetch
                rows.append(dict(pending=pend, fetch=fetch,
                                 ms=e0.elapsed_time(e1),
                                 plain_ms=q0.elapsed_time(q1),
                                 bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3))
            res[(loop, bounce)] = dict(n=n, rounds=rows)
            return got
        return run

    integ._trace_closest_alpha_split = twice("closest")
    integ._trace_occluded_alpha_split = twice("shadow")
    integ._closest_round = timed_round("closest")
    integ._shadow_round = timed_round("shadow")
    try:
        r.render(1)
        torch.cuda.synchronize()
    finally:
        integ._trace_closest_alpha_split = loops["closest"]
        integ._trace_occluded_alpha_split = loops["shadow"]
        integ._closest_round = rounds["closest"]
        integ._shadow_round = rounds["shadow"]
    check(set(res) == {(lp, b) for lp in loops for b in (0, 2)},
          f"[rounds] split loop calls {calls}, checked {sorted(res)}")
    _check_film(r, "rounds")
    out = {}
    for loop in loops:
        name = f"alpha_{loop}_round"
        b0, b2 = res[(loop, 0)], res[(loop, 2)]
        for bounce, b in ((0, b0), (2, b2)):
            log(f"[rounds] {loop} loop, bounce {bounce}, {b['n']} lanes, "
                "bit-equal to the plain twin; by round pending/fetching, "
                "kernel ms, plain ms, bound ms: " + "; ".join(
                    f"{x['pending']}/{x['fetch']} {x['ms']:.4f} "
                    f"{x['plain_ms']:.3f} {x['bound_ms']:.5f}"
                    for x in b["rounds"]))
        first, first2 = b0["rounds"][0], b2["rounds"][0]
        out[name] = {
            "name": name, "id": "R1", "route": "cuda",
            "source": "pt_torch/accel/csrc/alpha_round_kernels.cu",
            "replaces": "none: pt/render/integrator.py "
                        f"{loops[loop].__name__}'s rounds, tensor code",
            "launches": per_sample[name], "launches_per": "4K sample",
            "max_abs_err": 0.0, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "wavefront": "4K still, bounce 0, round 1", "lanes": b0["n"],
            "pending": first["pending"], "fetch": first["fetch"],
            "ms_bounce2": first2["ms"],
            "plain_ms_bounce2": first2["plain_ms"],
            "bound_ms_bounce2": first2["bound_ms"], "lanes_bounce2": b2["n"],
            "rounds": {str(b): res[(loop, b)]["rounds"] for b in (0, 2)}}
    log("[rounds] " + json.dumps(list(out.values())))
    return out


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
    check(counts == {"closest_bf8": 51, "occluded_bf8": 51}
          and sum(every.values()) == 102, f"Default: launches {every}")
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


# pt's "Test Scenes" group, in pt's order (pt/scene/examples.py:458-466)
TEST_SCENE_NAMES = ("Default", "MetallicRoughness Cubes",
                    "Roughness Test Cubes", "Heightfield", "Reuse Mesh",
                    "Courtyard", "Courtyard Flythrough")
# the keys `pt`'s `stats` command prints on the Default (pt/run/cli.py:212-222)
PT_STATS_KEYS = ("Acceleration Structure Build", "Frame total",
                 "Mesh Upload", "Render", "Samples Per Frame", "Scene Load",
                 "Total Samples", "Update")
# the plain versions of the kernels the two entry points reach
ENTRY_PLAIN = ("closest_bf8_plain", "occluded_bf8_plain", "closest_v4_plain",
               "occluded_v4_plain")


class _PlainCalls:
    """Within the block, count the calls of the plain versions in `names`
    (ENTRY_PLAIN by default; each wrapped in `pt_torch.accel.kernels`, the
    module the wrappers call them through)."""

    def __init__(self, names=ENTRY_PLAIN):
        self.names = names

    def __enter__(self):
        from pt_torch.accel import kernels
        self.calls = dict.fromkeys(self.names, 0)
        self._saved = {k: getattr(kernels, k) for k in self.names}

        def counting(name, fn):
            def wrapped(*args, **kwargs):
                self.calls[name] += 1
                return fn(*args, **kwargs)
            return wrapped
        for k, fn in self._saved.items():
            setattr(kernels, k, counting(k, fn))
        return self

    def __exit__(self, *exc):
        from pt_torch.accel import kernels
        for k, fn in self._saved.items():
            setattr(kernels, k, fn)


def _entry_inputs(scene, width: int, device: str):
    """What `render_image_stats` takes for `scene` on `device`: the
    flattened scene, its texture pool and the first camera's matrices at a
    `width`² film."""
    from pt_torch.render.textures import default_texture_pool
    from pt_torch.scene.flatten import flatten_scene
    from pt_torch.scene.textures import build_scene_textures
    ds = flatten_scene(scene, device=device)
    tex = (build_scene_textures(scene, device=device) if scene.textures
           else default_texture_pool(device=device))
    cam = scene.cameras[0]
    cam.on_resize(width, width)
    return ds, tex, cam.inv_view, cam.inv_proj


def _cli(argv):
    """`pt_torch.run.cli.main(argv)` in this process: (exit code, standard
    output, wall seconds, every kernel's launches), with the launch counters
    set to 0 just before and read just after."""
    import contextlib
    import io
    import torch
    from pt_torch.accel import kernels
    from pt_torch.run import cli
    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return rc, out.getvalue(), dt, {k: v for k, v in kernels.launches.items()
                                    if v}


def _offline_film(scene_fn, width, spp, path, ckpt=None):
    """An OfflineRenderer run of `scene_fn()` on the card, 3 bounces, 2
    samples a step: its Renderer."""
    from pt_torch.out.saver import OutputInfo
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.offline import OfflineRenderer, RenderSettings
    from pt_torch.run.renderer import Renderer
    r = Renderer(PathTracingSettings(sample_count=1, bounce_count=3),
                 device="cuda")
    r.set_scene(scene_fn())
    frames = OfflineRenderer(r).render(RenderSettings(
        output=OutputInfo(str(path), width, width, 30.0, "png"),
        frame_count=1, max_sample_count=spp, samples_per_step=2,
        checkpoint_path=ckpt and str(ckpt)))
    check(frames == 1 and r.total_samples == spp,
          f"offline render: {frames} frames, {r.total_samples} spp")
    return r


def phase_entry():
    """The main path's two callers (`[entry]` lines): (a)
    `render_image_stats` on the Heightfield at full size (Morton tree: the
    warp K3/K4, exactly sample_count x bounce_count launches of each per
    call, no plain version, no other kernel); (b) `render_image_stats` on
    the card against the CPU, the Default at `entry()`'s settings and the
    Heightfield (n=64) at 2 spp; (c) `python -m pt_torch.run.cli render` in
    this process, with no --device: the Default at 512², then at 32² to
    HDR with no --device and with --device cpu; (d) an offline render
    resumed from its checkpoint against an uninterrupted one; (e)
    `list-scenes`. Returns the launches and times for the summary."""
    import torch
    from pt_torch.accel import kernels
    from pt_torch.render.integrator import (PathTracingSettings,
                                            render_image_stats)
    from pt_torch.scene.examples import (make_default_scene,
                                         make_heightfield_scene)
    from pt_torch.scene.textures import decode_png, read_radiance_hdr
    t0 = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    # (a) render_image_stats at full size
    spp, bounces, width = 4, 5, 512
    settings = PathTracingSettings(sample_count=spp, bounce_count=bounces)
    args = _entry_inputs(make_heightfield_scene(224), width, "cuda")
    ta = time.perf_counter()
    render_image_stats(*args, width, width, 0, settings)
    torch.cuda.synchronize()
    warm = time.perf_counter() - ta
    torch.cuda.reset_peak_memory_stats()
    want = {"closest_v4": spp * bounces, "occluded_v4": spp * bounces}
    secs, rays = [], []
    with _PlainCalls() as plain:
        for frame in range(1, 4):
            kernels.reset_launch_counts()
            ta = time.perf_counter()
            img, n = render_image_stats(*args, width, width, frame,
                                        settings)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - ta)
            got = {k: v for k, v in kernels.launches.items() if v}
            check(got == want, f"[entry] render_image_stats launched {got}, "
                  f"want {want}")
            rays.append(int(n))
    check(not any(plain.calls.values()),
          f"[entry] plain versions ran on the card: {plain.calls}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    film = img.cpu().numpy() / spp
    check(film.shape == (width, width, 3) and bool(np.isfinite(film).all())
          and float(film.max()) > 0.0, "[entry] render_image_stats film")
    ms = [s * 1e3 for s in secs]
    mrays = sum(rays) / sum(secs) / 1e6
    log(f"[entry] render_image_stats, Heightfield n=224 ({args[0].num_triangles}"
        f" triangles, Morton tree), {width}x{width}, {bounces} bounces, "
        f"{spp} spp: warm call {warm:.2f} s, ms per call "
        f"{', '.join(f'{m:.1f}' for m in ms)} (mean {sum(ms) / 3:.1f}), "
        f"{mrays:.3f} useful Mrays/s ({rays[0]} rays a call), peak memory "
        f"{peak:.0f} MiB, launches per call {got}, plain calls "
        f"{plain.calls}")

    # (a2) the same work through Renderer, in turns on one scene: the
    # Animated Heightfield (the Morton tree rebuilt for each call of both)
    r = _renderer(build_animated_scene(port_namespace(), 224), width, spp,
                  bounces, "cuda")
    _step_frame(r)
    r.render()
    iv, ip = r._camera_mats()

    def stats_call():
        render_image_stats(r.ds, r.tex, iv, ip, width, width, 0, settings)

    def renderer_step():
        _step_frame(r)
        r.render()
    stats_call()
    turns = {"Renderer": [], "render_image_stats": []}
    for name in ("Renderer", "render_image_stats", "render_image_stats",
                 "Renderer") * 2:
        fn = renderer_step if name == "Renderer" else stats_call
        ta = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - ta) * 1e3)
    log(f"[entry] in turns on the Animated Heightfield, 512x512, 5 bounces, "
        f"4 spp, ms per call (Renderer: update, rebuild, render; "
        f"render_image_stats: build, render): "
        + "; ".join(f"{k} {', '.join(f'{v:.1f}' for v in vs)} (mean "
                    f"{sum(vs) / len(vs):.1f})" for k, vs in turns.items()))
    one = PathTracingSettings(sample_count=1, bounce_count=bounces)
    _profile(lambda: render_image_stats(r.ds, r.tex, iv, ip, width, width, 0,
                                        one),
             "render_image_stats, Animated Heightfield, one sample")
    del r

    # (b) render_image_stats, card against CPU
    for what, scene_fn, w, n_spp in (
            ("Default, 32x32, 3 bounces, 1 spp (entry()'s settings)",
             make_default_scene, 32, 1),
            ("Heightfield n=64, 64x64, 3 bounces, 2 spp",
             lambda: make_heightfield_scene(64), 64, 2)):
        st = PathTracingSettings(sample_count=n_spp, bounce_count=3)
        out = {}
        for dev in ("cuda", "cpu"):
            img, n = render_image_stats(*_entry_inputs(scene_fn(), w, dev),
                                        w, w, 0, st, device=dev)
            out[dev] = (img.cpu().numpy() / n_spp, int(n))
        mse = float(np.mean((out["cuda"][0] - out["cpu"][0]) ** 2))
        log(f"[entry] render_image_stats {what}: film MSE cuda vs cpu "
            f"{mse:.3e} (limit 1e-3), rays {out['cuda'][1]} against "
            f"{out['cpu'][1]}")
        check(bool(np.isfinite(mse)) and mse < 1e-3,
              f"[entry] {what}: film MSE {mse}")

    # (c) the CLI, in this process, with no --device
    png = OUT_DIR / "cli_default_512.png"
    rc, _, cli_s, cli_launches = _cli(
        ["render", "--scene", "Test Scenes/Default", "--size", "512x512",
         "--spp", "4", "--bounces", "5", "--out", str(png)])
    check(rc == 0, f"[entry] cli render returned {rc}")
    decoded = decode_png(png.read_bytes())
    check(decoded.shape[:2] == (512, 512) and decoded[..., :3].shape[2] == 3
          and int(decoded[..., :3].max()) > 0,
          f"[entry] cli PNG decodes to {decoded.shape}")
    want_cli = {"closest_bf8": 17, "occluded_bf8": 17}
    check(cli_launches == want_cli,
          f"[entry] cli render launched {cli_launches}, want {want_cli}")
    log(f"[entry] python -m pt_torch.run.cli render --scene \"Test "
        f"Scenes/Default\" --size 512x512 --spp 4 --bounces 5 (no "
        f"--device): rc 0, {cli_s:.2f} s wall (scene, accel and texture "
        f"pool built), launches {cli_launches}, wrote "
        f"{png.relative_to(ROOT)} ({png.stat().st_size} bytes, decodes to "
        f"{decoded.shape[0]}x{decoded.shape[1]})")
    hdr = {}
    for dev in (None, "cpu"):
        path = OUT_DIR / f"cli_default_32_{dev or 'card'}.hdr"
        rc, _, _, _ = _cli(
            ["render", "--scene", "Test Scenes/Default", "--size", "32x32",
             "--spp", "2", "--bounces", "3", "--format", "hdr", "--out",
             str(path)] + (["--device", dev] if dev else []))
        check(rc == 0, f"[entry] cli render --device {dev} returned {rc}")
        hdr[dev] = read_radiance_hdr(path.read_bytes())
    mse = float(np.mean((hdr[None] - hdr["cpu"]) ** 2))
    log(f"[entry] cli render 32x32, 2 spp, 3 bounces, --format hdr: no "
        f"--device against --device cpu, film MSE {mse:.3e} (limit 1e-3)")
    check(hdr[None].shape == (32, 32, 3) and mse < 1e-3,
          f"[entry] cli hdr films: MSE {mse}")

    # (d) resume from a checkpoint, against an uninterrupted render
    ckpt = OUT_DIR / "entry_resume.ckpt.npz"
    full = _offline_film(make_default_scene, 64, 4,
                         OUT_DIR / "entry_full.png").accum.cpu().numpy()
    first = _offline_film(make_default_scene, 64, 2,
                          OUT_DIR / "entry_half.png")
    first.save_checkpoint(str(ckpt))
    resumed = _offline_film(make_default_scene, 64, 4,
                            OUT_DIR / "entry_resumed.png", ckpt)
    same = bool(np.array_equal(resumed.accum.cpu().numpy(), full))
    log(f"[entry] OfflineRenderer, Default 64x64, 3 bounces: 2 spp, "
        f"checkpoint, resumed to 4 spp: film bit-equal to an uninterrupted "
        f"4-spp render: {same}; checkpoint deleted: {not ckpt.exists()}")
    check(same and not ckpt.exists(), "[entry] resumed film differs")

    # (e) list-scenes
    rc, text, _, _ = _cli(["list-scenes"])
    names = [line.strip().split("/", 1)[1] for line in text.splitlines()
             if line.startswith("  Test Scenes/")]
    log(f"[entry] list-scenes: {names}")
    check(rc == 0 and tuple(names) == TEST_SCENE_NAMES,
          f"[entry] list-scenes gave {names}")
    log(f"[entry] phase: {time.perf_counter() - t0:.1f} s")
    return dict(stats_ms=ms, stats_mrays=mrays, stats_peak_mib=peak,
                turns_ms=turns, cli_s=cli_s,
                launches={**got, **cli_launches})


def _debug_state(scene, size, dev):
    """What `render_debug_image` takes for `scene` on `dev` at a `size` (w,
    h) film: (scene, texture pool, inverse view, inverse projection)."""
    from pt_torch.render.textures import default_texture_pool
    from pt_torch.scene.flatten import flatten_scene
    from pt_torch.scene.textures import build_scene_textures
    cam = scene.cameras[0]
    cam.on_resize(*size)
    tex = (build_scene_textures(scene, device=dev) if scene.textures
           else default_texture_pool(device=dev))
    return (flatten_scene(scene, device=dev), tex, cam.inv_view,
            cam.inv_proj)


def _debug_frame(state, size, mode, backend="pallas", dev="cuda", **flags):
    """One `render_debug_image` frame on `dev`, as a host array."""
    from pt_torch.render.debug import DebugFlags, render_debug_image
    from pt_torch.render.integrator import PathTracingSettings
    return render_debug_image(*state, size[0], size[1], mode,
                              PathTracingSettings(backend=backend),
                              DebugFlags(**flags), device=dev)


def _off_share(a, b) -> float:
    """The share of pixels whose channels differ by more than 1e-4."""
    a = a.cpu().numpy() if hasattr(a, "cpu") else a
    b = b.cpu().numpy() if hasattr(b, "cpu") else b
    return float(np.mean(np.abs(a - b).max(axis=-1) > 1e-4))


class _BruteCalls:
    """Within the block, count the integrator's brute-force calls."""

    def __enter__(self):
        from pt_torch.render import integrator
        self.calls, self._real = 0, integrator.intersect_brute

        def counting(*args, **kwargs):
            self.calls += 1
            return self._real(*args, **kwargs)
        integrator.intersect_brute = counting
        return self

    def __exit__(self, *exc):
        from pt_torch.render import integrator
        integrator.intersect_brute = self._real


def phase_debug():
    """Phase 10c (`[debug]` lines): the debug renderer on the kernels and
    by brute force, the alpha loop in a debug frame, the `debug` and
    `stats` commands, and HDR10 output. Returns the launches a debug frame
    and an HDR10 step make, and the ms per debug frame."""
    import torch
    from pt_torch.accel import kernels
    from pt_torch.out.saver import write_image
    from pt_torch.render.debug import DebugRenderMode
    from pt_torch.render.integrator import ALPHA_ROUNDS
    from pt_torch.scene.examples import (make_default_scene,
                                         make_heightfield_scene)
    from pt_torch.scene.textures import decode_png
    t0 = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    size, small = (640, 480), (128, 96)
    color = DebugRenderMode.COLOR

    def launched():
        torch.cuda.synchronize()
        return {k: v for k, v in kernels.launches.items() if v}

    # (a) the kernels at pt's debug size: launches and ms per frame
    hf = make_heightfield_scene(224)
    state = _debug_state(hf, size, "cuda")
    cases = [(m.name, m, {}) for m in DebugRenderMode]
    cases.append(("COLOR without shadows", color, {"disable_shadows": True}))
    times, frame_launches = {}, {}
    with _BruteCalls() as brute:
        for name, mode, flags in cases:
            _debug_frame(state, size, mode, **flags)           # warm
            kernels.reset_launch_counts()
            img = _debug_frame(state, size, mode, **flags)
            got = frame_launches[name] = launched()
            want = {"closest_v4": 1}
            if mode == color and not flags:
                want["occluded_v4"] = 1
            check(got == want, f"[debug] {name}: launches {got}, want {want}")
            check(tuple(img.shape) == (480, 640, 3)
                  and bool(torch.isfinite(img).all()),
                  f"[debug] {name}: frame {tuple(img.shape)}")
            times[name] = cuda_ms(lambda: _debug_frame(state, size, mode,
                                                       **flags))
    check(brute.calls == 0, f"[debug] {brute.calls} brute-force calls")
    log(f"[debug] render_debug_image, Heightfield n=224 "
        f"({state[0].num_triangles} triangles, Morton tree built in each "
        f"frame), 640x480, backend pallas: launches a frame closest_v4 1 "
        f"(+ occluded_v4 1 in COLOR with shadows), no brute-force call; ms "
        f"per frame " + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))

    # (b) 128x96: kernels against brute force on the card, and the card
    # against the CPU on a smaller Heightfield
    shares = {}
    state = _debug_state(hf, small, "cuda")
    small_hf = {dev: _debug_state(make_heightfield_scene(32), small, dev)
                for dev in ("cuda", "cpu")}
    for mode in DebugRenderMode:
        kern = _debug_frame(state, small, mode)
        kernels.reset_launch_counts()
        brute_img = _debug_frame(state, small, mode, backend="brute")
        check(not launched(), f"[debug] brute {mode.name}: {launched()}")
        card = _debug_frame(small_hf["cuda"], small, mode)
        cpu = _debug_frame(small_hf["cpu"], small, mode, dev="cpu")
        shares[mode.name] = (_off_share(kern, brute_img),
                             _off_share(card, cpu))
    worst = max(max(v) for v in shares.values())
    log(f"[debug] 128x96, per mode the share of pixels off by more than "
        f"1e-4 (kernels against brute force on the card, Heightfield n=224; "
        f"card against CPU, Heightfield n=32, backend pallas): "
        + ", ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in shares.items())
        + " (limit 0.005)")
    check(worst <= 0.005, f"[debug] 128x96 frames differ: {shares}")

    # (c) the static alpha variant: the single-tree alpha loop
    ns = port_namespace()
    alpha = _debug_state(build_animated_scene(ns, 224, N_CARDS,
                                              animate=False), (256, 256),
                         "cuda")
    frames, alpha_launches = {}, {}
    for name, flags in (("see-through", {}), ("force-opaque",
                                              {"force_opaque": True}),
                        ("cull-backfaces", {"cull_backfaces": True}),
                        ("no color texture",
                         {"disable_color_texture": True})):
        kernels.reset_launch_counts()
        frames[name] = _debug_frame(alpha, (256, 256), color, **flags)
        alpha_launches[name] = launched()
    seen = alpha_launches["see-through"]
    check(seen == {"closest_v4": ALPHA_ROUNDS, "occluded_v4": 1}
          and alpha_launches["force-opaque"] == {"closest_v4": 1,
                                                 "occluded_v4": 1},
          f"[debug] alpha launches {alpha_launches}")
    changed = {k: _off_share(v, frames["see-through"])
               for k, v in frames.items() if k != "see-through"}
    check(min(changed.values()) > 0.001, f"[debug] alpha flags: {changed}")
    tiny = {dev: _debug_state(build_animated_scene(ns, 16, 40, animate=False),
                              (32, 32), dev) for dev in ("cuda", "cpu")}
    kernels.reset_launch_counts()
    card = _debug_frame(tiny["cuda"], (32, 32), color)
    tiny_launches = launched()
    with _PlainCalls() as plain:
        cpu = _debug_frame(tiny["cpu"], (32, 32), color, dev="cpu")
    # (closest_v4_plain calls closest_bf8_plain: only the v4 names count)
    cpu_calls = {k: plain.calls[f"{k}_plain"]
                 for k in ("closest_v4", "occluded_v4")
                 if plain.calls[f"{k}_plain"]}
    tiny_share = _off_share(card, cpu)
    log(f"[debug] static alpha variant ({alpha[0].num_triangles} triangles), "
        f"256x256, COLOR: launches {alpha_launches}; share of pixels changed "
        f"against the see-through frame {changed}; the small variant (n=16, "
        f"40 cards) at 32x32: card launches {tiny_launches}, CPU plain calls "
        f"{cpu_calls}, frames off on {tiny_share:.4f} of the pixels")
    check(tiny_launches == seen and cpu_calls == seen and tiny_share <= 0.005,
          f"[debug] small alpha variant: {tiny_launches}, {cpu_calls}, "
          f"{tiny_share}")

    # (d) the debug command (the Default, 640x480, brute as in pt)
    png = OUT_DIR / "debug_normal_640x480.png"
    rc, _, cli_s, cli_launches = _cli(["debug", "--mode", "normal", "--out",
                                       str(png)])
    check(rc == 0, f"[debug] cli debug returned {rc}")
    decoded = decode_png(png.read_bytes())
    check(decoded.shape[:2] == (480, 640) and not cli_launches,
          f"[debug] cli debug: {decoded.shape}, launches {cli_launches}")
    log(f"[debug] python -m pt_torch.run.cli debug --mode normal (the "
        f"Default, 640x480, brute force, no --device): rc 0, {cli_s:.2f} s "
        f"wall, launches {cli_launches}, wrote {png.relative_to(ROOT)} "
        f"(decodes to {decoded.shape[0]}x{decoded.shape[1]})")

    # (e) HDR10
    r = _renderer(make_default_scene(), 512, 4, 5, "cuda")
    r.render()                                             # warm step
    kernels.reset_launch_counts()
    r.render()
    hdr_launches = launched()
    want_hdr = {"closest_bf8": 17, "occluded_bf8": 17}
    check(hdr_launches == want_hdr,
          f"[debug] HDR10 step: launches {hdr_launches}, want {want_hdr}")
    pq = r.snapshot(hdr=True)
    check(pq.shape == (512, 512, 3) and bool(np.isfinite(pq).all())
          and 0.0 <= float(pq.min()) and float(pq.max()) <= 1.0,
          "[debug] HDR10 snapshot")
    write_image(str(OUT_DIR / "hdr10_default_512.png"), pq)
    pqs = {}
    for dev in ("cuda", "cpu"):
        rr = _renderer(make_default_scene(), 256, 4, 5, dev)
        rr.render()
        pqs[dev] = rr.snapshot(hdr=True)
    mse = float(np.mean((pqs["cuda"] - pqs["cpu"]) ** 2))
    log(f"[debug] HDR10, the Default at 512x512, 5 bounces, 4 spp through "
        f"Renderer: launches a step {hdr_launches}, PQ image mean "
        f"{float(pq.mean()):.4f} (SDR {float(r.snapshot().mean()):.4f}); "
        f"the PQ image card against CPU at 256x256, 4 spp: MSE {mse:.3e} "
        f"(limit 1e-3)")
    check(mse < 1e-3, f"[debug] HDR10 card against CPU: MSE {mse}")
    png = OUT_DIR / "cli_default_512_hdr10.png"
    rc, _, hdr_s, cli_launches = _cli(
        ["render", "--scene", "Test Scenes/Default", "--size", "512x512",
         "--spp", "4", "--bounces", "5", "--hdr", "--out", str(png)])
    decoded = decode_png(png.read_bytes())
    check(rc == 0 and decoded.shape[:2] == (512, 512)
          and cli_launches == want_hdr,
          f"[debug] cli render --hdr: rc {rc}, {decoded.shape}, launches "
          f"{cli_launches}")
    log(f"[debug] python -m pt_torch.run.cli render --hdr (the Default, "
        f"512x512, 4 spp, 5 bounces, no --device): rc 0, {hdr_s:.2f} s "
        f"wall, launches {cli_launches}, wrote {png.relative_to(ROOT)}")

    # (f) the stats command (brute force, as pt's)
    rc, text, stats_s, cli_launches = _cli(["stats"])
    keys = {line.split(": ", 1)[0] for line in text.splitlines()}
    missing = set(PT_STATS_KEYS) - keys
    log(f"[debug] python -m pt_torch.run.cli stats (no --device): rc {rc}, "
        f"{stats_s:.2f} s wall, launches {cli_launches}, board: "
        + "; ".join(line for line in text.splitlines()
                    if line.split(": ", 1)[0] in PT_STATS_KEYS))
    check(rc == 0 and not missing and not cli_launches,
          f"[debug] stats: rc {rc}, missing {missing}, launches "
          f"{cli_launches}")
    log(f"[debug] phase: {time.perf_counter() - t0:.1f} s")
    # the kernels line's count a debug frame: the COLOR frame with shadows,
    # the one frame that launches both K3 and K4
    return dict(debug_ms=times, launches_hdr=hdr_launches,
                launches_debug=frame_launches[color.name],
                launches_debug_alpha=seen["closest_v4"])


# the plain versions the imported scenes' paths could reach: K1/K2 (flat),
# K5/K6 (shared BLAS) and K3/K4 (an animated import)
IMPORT_PLAIN = ENTRY_PLAIN + ("closest_bf8i_plain", "occluded_bf8i_plain")
# the Heightfield n=224 mesh: 2 x 223² triangles
HEIGHTFIELD_TRIS = 99_458


def write_animated_glb(n: int, path) -> None:
    """The Heightfield of grid size `n` exported by the port's exporter,
    with a 2-second node animation (translation and rotation keys, linear)
    added on the node that holds its mesh: a node-animated glTF that
    imports as an animated instance (Morton rebuild, K3/K4)."""
    from pt_torch.scene.examples import make_heightfield_scene
    from pt_torch.scene.gltf import GLTFFile
    from pt_torch.scene.gltf_export import export_glb, write_glb
    export_glb(make_heightfield_scene(n), str(path))
    g, blob = GLTFFile._parse_glb(pathlib.Path(path).read_bytes())
    node = next(i for i, nd in enumerate(g["nodes"]) if "mesh" in nd)
    times = np.asarray([0.0, 1.0, 2.0], np.float32)
    moves = np.asarray([[0, 0, 0], [0, 0.3, 0.2], [0, 0, 0]], np.float32)
    angle = np.asarray([0.0, 0.15, 0.0])
    quats = np.stack([np.zeros(3), np.sin(angle / 2), np.zeros(3),
                      np.cos(angle / 2)], -1).astype(np.float32)   # xyzw
    accessors = []
    for arr, kind in ((times, "SCALAR"), (moves, "VEC3"), (quats, "VEC4")):
        blob += b"\0" * (-len(blob) % 4)
        g["bufferViews"].append({"buffer": 0, "byteOffset": len(blob),
                                 "byteLength": arr.nbytes})
        blob += arr.tobytes()
        acc = {"bufferView": len(g["bufferViews"]) - 1,
               "componentType": 5126, "count": len(arr), "type": kind}
        if kind == "SCALAR":
            acc.update(min=[float(times.min())], max=[float(times.max())])
        g["accessors"].append(acc)
        accessors.append(len(g["accessors"]) - 1)
    g["animations"] = [{"name": "sway", "samplers": [
        {"input": accessors[0], "output": accessors[1],
         "interpolation": "LINEAR"},
        {"input": accessors[0], "output": accessors[2],
         "interpolation": "LINEAR"}], "channels": [
        {"sampler": 0, "target": {"node": node, "path": "translation"}},
        {"sampler": 1, "target": {"node": node, "path": "rotation"}}]}]
    g["buffers"][0]["byteLength"] = len(blob) + (-len(blob) % 4)
    write_glb(str(path), g, blob)


def _import_file(path):
    """The scene the port's CombinedSceneLoader makes of `path` (by
    suffix, as the CLI's "CLI/file")."""
    from pt_torch.scene.builder import SceneBuilder
    from pt_torch.scene.manager import SceneDescription
    b = SceneBuilder(pathlib.Path(path).stem)
    SceneDescription("file", [path]).to_loader().load(b)
    return b.create_scene()


def _cli_hdr_films(path, size: int, spp: int, bounces: int, tag: str):
    """`render --scene path` to HDR with no --device (the card) and with
    --device cpu: ({device: film}, the card run's launches)."""
    from pt_torch.scene.textures import read_radiance_hdr
    films, launches = {}, None
    for dev in (None, "cpu"):
        out = OUT_DIR / f"import_{tag}_{dev or 'card'}.hdr"
        rc, _, _, got = _cli(["render", "--scene", str(path), "--size",
                              f"{size}x{size}", "--spp", str(spp),
                              "--bounces", str(bounces), "--format", "hdr",
                              "--out", str(out)]
                             + (["--device", dev] if dev else []))
        check(rc == 0, f"[import] render {path} --device {dev}: rc {rc}")
        films[dev] = read_radiance_hdr(out.read_bytes())
        if dev is None:
            launches = got
    return films, launches


def _as_carried(built, imported):
    """(the built-in scene as a glTF file carries it, the built-in scene
    with only the camera as exported), with `imported` made comparable.

    The exporter, as `pt`'s, writes the metallic texture as the
    metallicRoughnessTexture and drops a separate roughness texture
    (carried: roughness textures at their default), and writes the camera
    with its up negated, world +Y where the built-in camera's is -Y (both
    copies: the camera rolled by 180 degrees, as the glb's). glTF has no
    skybox: the imported scene is given the built-in one, as a
    SceneDescription gives one. The imported camera hangs on a node and
    takes its pose at the scene's first update, which a still render never
    makes (as in `pt`): it is placed here, so the glb's own camera is the
    one held to the film."""
    import copy
    import dataclasses
    cam = copy.deepcopy(built.cameras[0])
    cam.up_direction = -cam.up_direction
    cam._update_inv_view()
    rolled = copy.copy(built)
    rolled.cameras = [cam]
    carried = copy.copy(rolled)
    carried.materials_mr = [dataclasses.replace(m, roughness_idx=2)
                            for m in built.materials_mr]
    imported.skybox = built.skybox
    check(imported.cameras[0].on_update(0.0),
          "[import] the imported camera did not take its node's pose")
    return carried, rolled


def _error_spread(a, b) -> str:
    """Where the squared error of films `a` and `b` lies: the pixels that
    differ, and the share of the error held by the worst 0.1%."""
    err = ((a - b) ** 2).mean(-1).reshape(-1)
    worst = np.sort(err)[::-1][:max(1, err.size // 1000)]
    return (f"{int((err > 0).sum())} of {err.size} pixels differ, the worst"
            f" 0.1% hold {worst.sum() / max(err.sum(), 1e-30):.3f} of the "
            f"squared error, the largest pixel {float(err.max()):.3e}")


def phase_import():
    """Phase 10d (`[import]` lines): scene files in and files out. (a) The
    Courtyard at detail 1.0 (COURT_TEX_SCALE) exported by the port's
    exporter, with Pillow blocked, and reimported: its triangle and alpha
    counts, lights, textures and camera; (b) the glb through `render` on
    the card at 512², 2 spp: exit 0, the PNG decoded, only K1/K2 (or K5/K6
    where "auto" picks shared BLAS) launched, no plain version called, the
    wall seconds and the accel build against the built-in scene's; (c) the
    imported film, through the glb's own camera, against the built-in
    scene's film as the file carries it (`_as_carried`), and the card's
    film against the CPU's (a small Courtyard glb at 32²); (d) a node-animated glb of the Heightfield n=224 through
    `Renderer`, 3 frames of 4 spp at 512² (17 K3 + 17 K4 a step), and
    its small version card against CPU; (e) every scene fixture of
    `tests/data` through `render` card against CPU, and the DDS fixtures
    through `load_texture_mips` and the pool; (f) video: ffmpeg and
    Pillow logged, 3 frames to numbered PNGs, and mp4 through each arm
    whose encoder is present. Returns the launches for the kernels line."""
    import shutil
    import torch
    from pt_torch.accel import kernels
    from pt_torch.out import saver
    from pt_torch.run.renderer import Renderer
    from pt_torch.scene.flatten import flatten_scene
    from pt_torch.scene.gltf_export import export_glb
    from pt_torch.scene.standin import make_courtyard_scene
    from pt_torch.scene.textures import (build_texture_pool, decode_png,
                                         load_texture_mips)
    from pt_torch.scene.types import TextureInfo, TextureType
    t0 = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = {}

    # (a) export, with Pillow unimportable, and reimport
    ta = time.perf_counter()
    built = make_courtyard_scene(1.0, COURT_TEX_SCALE)
    glb = OUT_DIR / "courtyard_1.0.glb"
    pil = sys.modules.get("PIL", "unset")
    sys.modules["PIL"] = None
    try:
        export_glb(built, str(glb))
    finally:
        if pil == "unset":
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = pil
    export_s = time.perf_counter() - ta
    ta = time.perf_counter()
    imported = _import_file(glb)
    import_s = time.perf_counter() - ta
    d_built = flatten_scene(built, device="cuda")
    d_imp = flatten_scene(imported, device="cuda")
    counts = [(d.num_triangles, int((~d.tri_opaque).sum()))
              for d in (d_built, d_imp)]
    log(f"[import] Courtyard detail 1.0, tex_scale {COURT_TEX_SCALE}: "
        f"exported by the port ({glb.stat().st_size / 2**20:.1f} MiB, "
        f"{export_s:.1f} s, Pillow blocked), reimported in {import_s:.1f} s:"
        f" triangles (alpha-tested) built-in {counts[0]}, imported "
        f"{counts[1]}; {len(imported.point_lights)} point lights, "
        f"directional {imported.directional_light is not None}, "
        f"{len(imported.textures)} textures, {len(imported.cameras)} "
        f"camera(s)")
    check(counts[0] == counts[1] and counts[0][1] > 0,
          f"[import] triangle counts {counts}")
    check(len(imported.point_lights) == len(built.point_lights)
          and imported.directional_light is not None
          and len(imported.textures) >= 40 and len(imported.cameras) >= 1,
          "[import] lights, textures or camera lost in the round trip")
    del d_built, d_imp

    # (b) the glb through the CLI on the card
    Renderer._accel_cache = None
    png = OUT_DIR / "import_courtyard_512.png"
    with _PlainCalls(IMPORT_PLAIN) as plain:
        rc, _, cli_s, cli_launches = _cli(
            ["render", "--scene", str(glb), "--size", "512x512", "--spp",
             "2", "--bounces", "5", "--out", str(png)])
    check(rc == 0, f"[import] render --scene {glb.name}: rc {rc}")
    decoded = decode_png(png.read_bytes())
    check(decoded.shape == (512, 512, 4) and int(decoded[..., :3].max()) > 0,
          f"[import] the CLI's PNG decodes to {decoded.shape}")
    check(not any(plain.calls.values()),
          f"[import] plain versions ran on the card: {plain.calls}")
    # the foliage's MASK materials keep the alpha split: its round kernels
    rounds = {"alpha_closest_round", "alpha_shadow_round"}
    flat = {"closest_bf8", "occluded_bf8"} | rounds
    shared = {"closest_bf8i", "occluded_bf8i"} | rounds
    check(set(cli_launches) in (flat, shared),
          f"[import] the glb render launched {cli_launches}")
    route = "K1/K2 (flat)" if set(cli_launches) == flat else \
        "K5/K6 (shared BLAS, picked by auto)"
    log(f"[import] python -m pt_torch.run.cli render --scene {glb.name} "
        f"--size 512x512 --spp 2 --bounces 5 (no --device): rc 0, "
        f"{cli_s:.2f} s wall (import, texture pool, accel built), "
        f"launches {cli_launches} ({route}), plain calls {plain.calls}, "
        f"wrote {png.relative_to(ROOT)}")
    out["launches_cli"] = cli_launches

    # (c) films: imported against built-in, both on the card; accel builds
    carried, rolled = _as_carried(built, imported)
    films, builds, kinds = {}, {}, {}
    for what, scene in (("built-in, camera as exported", rolled),
                        ("as carried", carried), ("imported", imported)):
        Renderer._accel_cache = None
        r = _renderer(scene, 512, 2, 5, "cuda")
        ta = time.perf_counter()
        r._ensure_accel()
        torch.cuda.synchronize()
        builds[what] = time.perf_counter() - ta
        kinds[what] = type(r.accel.bvh).__name__
        r.render()
        films[what] = _check_film(r, f"[import] {what}")
        del r
    mse = float(np.mean((films["imported"] - films["as carried"]) ** 2))
    spread = _error_spread(films["imported"], films["as carried"])
    mse_rough = float(np.mean(
        (films["imported"] - films["built-in, camera as exported"]) ** 2))
    log(f"[import] accel build (SBVH -> BF8 + split trees, cache emptied): "
        f"built-in {builds['as carried']:.2f} s, imported "
        f"{builds['imported']:.2f} s ({kinds['imported']}); film 512x512, 2 "
        f"spp, 5 bounces on the card, the imported scene through the glb's "
        f"camera against the built-in scene as the file carries it: MSE "
        f"{mse:.3e} (limit 1e-3), {spread}; "
        f"against the built-in scene with its separate roughness textures "
        f"(camera as exported, both with the built-in skybox): "
        f"{mse_rough:.3e} (not a gate)")
    check(np.isfinite(mse) and mse < 1e-3, f"[import] film MSE {mse}")
    out.update(cli_s=cli_s, accel_build_s=builds, film_mse=mse)
    del films, built, carried, rolled, imported
    Renderer._accel_cache = None

    # a Courtyard glb, card against CPU, through the CLI: the small one the
    # CPU tests use (detail 0.1, 26,906 triangles), at 32²; the CPU's
    # plain versions trace by brute force, which at the full scene's
    # 212,884 triangles takes minutes. The same gate as above at this
    # size on the card (the CPU's films equal the card's, as the CLI's
    # show) says whether the size sets the imported film's distance from
    # the built-in one.
    ta = time.perf_counter()
    small_built = make_courtyard_scene(0.1, 0.05)
    small_glb = OUT_DIR / "courtyard_0.1.glb"
    export_glb(small_built, str(small_glb))
    hdr, _ = _cli_hdr_films(small_glb, 32, 2, 3, "courtyard")
    mse = float(np.mean((hdr[None] - hdr["cpu"]) ** 2))
    small_imported = _import_file(small_glb)
    small_carried, _ = _as_carried(small_built, small_imported)
    pair = []
    for scene in (small_imported, small_carried):
        Renderer._accel_cache = None
        r = _renderer(scene, 32, 2, 3, "cuda")
        r.render()
        pair.append(r.film_mean())
        del r
    Renderer._accel_cache = None
    gate = float(np.mean((pair[0] - pair[1]) ** 2))
    log(f"[import] render --scene {small_glb.name} 32x32, 2 spp, 3 bounces,"
        f" --format hdr: no --device against --device cpu, film MSE "
        f"{mse:.3e} (limit 1e-3); imported against the built-in scene as "
        f"carried at this size, on the card: MSE {gate:.3e}; "
        f"{time.perf_counter() - ta:.1f} s")
    check(hdr[None].shape == (32, 32, 3) and mse < 1e-3,
          f"[import] glb films card against CPU: MSE {mse}")
    check(gate < 1e-3, f"[import] small imported films: MSE {gate}")

    # (d) an animated import through Renderer
    anim = OUT_DIR / "animated_heightfield_224.glb"
    write_animated_glb(224, anim)
    scene = _import_file(anim)
    r = _renderer(scene, 512, 4, 5, "cuda")
    check(r.ds.num_triangles >= HEIGHTFIELD_TRIS
          and scene.has_animated_instances,
          f"[import] animated glb: {r.ds.num_triangles} triangles")
    frames, want = [], {"closest_v4": 17, "occluded_v4": 17}
    with _PlainCalls(IMPORT_PLAIN) as plain:
        for _ in range(3):
            ta = time.perf_counter()
            check(_step_frame(r), "[import] the animation did not move")
            kernels.reset_launch_counts()
            r.render()
            torch.cuda.synchronize()
            got = {k: v for k, v in kernels.launches.items() if v}
            frames.append((time.perf_counter() - ta) * 1e3)
            check(got == want, f"[import] animated step launched {got}, "
                  f"want {want}")
            check(type(r.accel.bvh).__name__ == "PacketBVH",
                  "[import] animated import: no Morton tree")
    check(not any(plain.calls.values()),
          f"[import] plain versions ran on the card: {plain.calls}")
    _check_film(r, "[import] animated")
    log(f"[import] node-animated glb (Heightfield n=224, "
        f"{r.ds.num_triangles} triangles): 3 frames of update, Morton "
        f"rebuild and a 4-spp step at 512x512, 5 bounces: ms "
        f"{', '.join(f'{m:.1f}' for m in frames)}, launches a step {got}")
    out["launches_anim"] = got
    del r
    small = OUT_DIR / "animated_heightfield_16.glb"
    write_animated_glb(16, small)
    films = {}
    for dev in ("cuda", "cpu"):
        r = _renderer(_import_file(small), 32, 2, 3, dev)
        _step_frame(r)
        r.render()
        films[dev] = r.film_mean()
    mse = float(np.mean((films["cuda"] - films["cpu"]) ** 2))
    log(f"[import] node-animated glb (Heightfield n=16), one frame at 32x32,"
        f" 2 spp, 3 bounces: film MSE cuda vs cpu {mse:.3e} (limit 1e-3)")
    check(mse < 1e-3, f"[import] animated glb films: MSE {mse}")

    # (e) the repo's fixtures
    data = ROOT / "tests" / "data"
    for f in sorted(data.iterdir()):
        if f.suffix not in (".gltf", ".obj", ".fbx"):
            continue
        hdr, got = _cli_hdr_films(f, 32, 1, 3, f.stem)
        mse = float(np.mean((hdr[None] - hdr["cpu"]) ** 2))
        log(f"[import] render --scene tests/data/{f.name} 32x32, 1 spp: "
            f"card against CPU film MSE {mse:.3e} (limit 1e-3), launches "
            f"{got}")
        check(bool(np.isfinite(hdr[None]).all()) and mse < 1e-3,
              f"[import] {f.name}: MSE {mse}")
    infos, chains = [], []
    for f in sorted(data.glob("*.dds")):
        info = TextureInfo(f.name, TextureType.COLOR, path=str(f))
        mips = load_texture_mips(info)
        chains.append(f"{f.name}: "
                      + (f"{len(mips)} authored levels" if mips else "none"))
        infos.append(info)
    pools = {dev: build_texture_pool(infos, device=dev)
             for dev in ("cuda", "cpu")}
    same = all(torch.equal(getattr(pools["cuda"], k).cpu(),
                           getattr(pools["cpu"], k))
               for k in ("data", "offsets", "sizes", "mip_counts"))
    log(f"[import] DDS fixtures, load_texture_mips: {'; '.join(chains)}; "
        f"pool on the card: {pools['cuda'].count} textures, mip counts "
        f"{pools['cuda'].mip_counts[9:].tolist()}, equal to the CPU's: "
        f"{same}")
    # sorted: adv_cubemap (a placeholder, one level), adv_legacy_ati2 (4x4,
    # its chain generated: 3 levels), adv_legacy_dxt1 (8x8, 4 authored)
    check(same and pools["cuda"].mip_counts[9:].tolist() == [1, 3, 4],
          "[import] DDS pool")

    # (f) video
    ffmpeg = shutil.which("ffmpeg")
    try:
        import PIL
        pillow = PIL.__version__
    except ImportError:
        pillow = None
    log(f"[import] this machine: ffmpeg {ffmpeg or 'absent'}, Pillow "
        f"{pillow or 'absent'}")
    base = ["render", "--size", "64x64", "--spp", "1", "--bounces", "3",
            "--frames", "3"]
    rc, _, _, _ = _cli(base + ["--format", "png", "--out",
                               str(OUT_DIR / "video_frame.png")])
    pngs = [OUT_DIR / f"video_frame_{i:05d}.png" for i in range(3)]
    check(rc == 0 and all(p.exists() for p in pngs),
          f"[import] numbered PNG frames: rc {rc}")
    frames = [decode_png(p.read_bytes())[..., :3] for p in pngs]
    arms = []
    if ffmpeg:
        mp4 = OUT_DIR / "video.mp4"
        rc, _, secs, _ = _cli(base + ["--format", "mp4", "--out", str(mp4)])
        check(rc == 0 and mp4.exists() and mp4.stat().st_size > 0,
              f"[import] mp4 through ffmpeg: rc {rc}")
        arms.append(f"ffmpeg: {mp4.stat().st_size} bytes, {secs:.1f} s")
    if pillow:
        import io
        import struct
        from PIL import Image
        real = saver.ffmpeg_available
        saver.ffmpeg_available = lambda: False
        try:
            rc, _, secs, _ = _cli(base + ["--format", "mp4", "--out",
                                          str(OUT_DIR / "video_mjpeg.mp4")])
        finally:
            saver.ffmpeg_available = real
        data_avi = (OUT_DIR / "video_mjpeg.avi").read_bytes()
        avih = data_avi.index(b"avih") + 8
        n = struct.unpack("<10I", data_avi[avih:avih + 40])[4]
        errs, pos = [], 0
        for frame in frames:
            pos = data_avi.index(b"00dc", pos)
            size = struct.unpack("<I", data_avi[pos + 4:pos + 8])[0]
            jpg = np.asarray(Image.open(io.BytesIO(
                data_avi[pos + 8:pos + 8 + size])).convert("RGB"))
            errs.append(float(np.abs(jpg.astype(np.int32)
                                     - frame.astype(np.int32)).mean()))
            pos += 8 + size
        check(rc == 0 and n == 3 and max(errs) < 8.0,
              f"[import] MJPEG AVI: rc {rc}, {n} frames, mean abs errors "
              f"{errs}")
        arms.append(f"MJPEG AVI (ffmpeg patched away): {n} frames, mean abs "
                    f"error against the PNG frames "
                    f"{', '.join(f'{e:.2f}' for e in errs)} (limit 8 of 255)"
                    f", {secs:.1f} s")
    log(f"[import] render --frames 3, 64x64: numbered PNGs written; mp4 "
        f"arms run: {'; '.join(arms) or 'none (no ffmpeg, no Pillow)'}")
    log(f"[import] phase: {time.perf_counter() - t0:.1f} s")
    return out


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


def _walk_timed(fn):
    """CUDA-event ms of one threaded walk `fn()` (no warm run: nothing to
    compile), with the walk's counters set to 0 just before and read just
    after: (ms, result, counters)."""
    import torch
    from pt_torch.accel import traverse
    torch.cuda.synchronize()
    traverse.reset_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out, dict(traverse.stats)


def _no_launches(what):
    from pt_torch.accel import kernels
    got = {k: v for k, v in kernels.launches.items() if v}
    check(not got, f"{what}: kernels launched {got}")


def phase_bvh():
    """Phase 12 (`[bvh]` lines): `backend="bvh"`, `pt`'s threaded LBVH
    walked in tensor code, on the card. (a) exact ids against brute force
    on BVH_RAYS random rays over 4,096 independent random triangles, the
    any-hit query likewise, and the loop conditions tested every step or
    every 8 bit-equal; (b) `render --backend bvh` on the Default at 512²,
    4 spp, 5 bounces through the CLI; (c) `Renderer` on the Heightfield:
    at full size (BVH_FULL_N) one 512², 1-spp, 1-bounce step (a closest
    and an any-hit trace) under CUDA events, and at the cut size (BVH_N)
    one 512², 4-spp, 5-bounce step, its film against the kernels' film of
    the same RNG on the card (MSE < 1e-3); (d) the Heightfield (BVH_N) at
    64², 1 spp, 3 bounces, card against CPU (MSE < 1e-3). Every tree
    tensor on the card, no kernel launch and no plain version or brute
    force anywhere on the bvh paths. Logs build ms, ms a trace, lockstep
    steps and host syncs a trace, ms a lockstep step and ms a render
    step. Returns the phase's numbers."""
    import torch
    from pt_torch.accel import kernels, lbvh, traverse
    from pt_torch.accel.intersect import intersect_brute
    from pt_torch.render.integrator import TMIN, ThreadedTriangles
    from pt_torch.scene.textures import decode_png
    t0 = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    res = {}
    # (a) the walk against brute force
    rng = np.random.default_rng(16)
    centers = rng.uniform(-10, 10, (4096, 3))
    verts = (centers[:, None, :] + rng.normal(0, 0.4, (4096, 3, 3)))
    V = torch.as_tensor(verts.reshape(-1, 3).astype(np.float32),
                        device="cuda")
    T = torch.arange(3 * 4096, dtype=torch.int32, device="cuda").view(-1, 3)
    o = rng.uniform(-12, 12, (BVH_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(BVH_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    O = torch.as_tensor(o, device="cuda")
    D = torch.as_tensor(d, device="cuda")
    kernels.reset_launch_counts()
    tree = lbvh.build_bvh(V, T, 4)
    for name in ("aabb_lo", "aabb_hi", "miss_next", "leaf_id", "leaf_tris"):
        check(getattr(tree, name).device.type == "cuda",
              f"[bvh] ThreadedBVH.{name} is not on the card")
    ms8, hit8, st8 = _walk_timed(lambda: traverse.bvh_closest(
        tree, V, T, O, D, TMIN))
    ms1, hit1, st1 = _walk_timed(lambda: traverse.bvh_closest(
        tree, V, T, O, D, TMIN, check_every=1))
    ref = intersect_brute(V, T, O, D, TMIN)
    check(torch.equal(hit8.tri, ref.tri),
          f"[bvh] ids against brute force: "
          f"{int((hit8.tri != ref.tri).sum())} of {BVH_RAYS} differ")
    check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
              for a, b in zip(hit8, hit1)),
          "[bvh] conditions every step and every 8 steps differ")
    occ = traverse.bvh_occluded(tree, V, T, O, D, 6.0, TMIN)
    check(torch.equal(occ, intersect_brute(V, T, O, D, TMIN, 6.0).is_hit),
          "[bvh] any-hit against brute force differs")
    _no_launches("[bvh] the walk")
    log(f"[bvh] {BVH_RAYS} random rays, 4096 triangles: ids equal to brute "
        f"force ({int((hit8.tri >= 0).sum())} hits), any-hit equal "
        f"({int(occ.sum())} blocked); checks every 8 steps {ms8:.2f} ms "
        f"({st8['steps']} steps, {st8['rounds']} leaf rounds, "
        f"{st8['syncs']} syncs) against every step {ms1:.2f} ms "
        f"({st1['syncs']} syncs), bit-equal; no kernel launched")
    res["random_ms"] = {"every_8": round(ms8, 3), "every_1": round(ms1, 3)}

    # (b) the CLI on the Default
    out = OUT_DIR / "default_bvh_512.png"
    with _PlainCalls() as plain, _BruteCalls() as brute:
        rc, _, wall, launches = _cli(
            ["render", "--backend", "bvh", "--scene", "Test Scenes/Default",
             "--size", "512x512", "--spp", "4", "--bounces", "5", "--out",
             str(out)])
    img = decode_png(out.read_bytes())
    check(rc == 0 and img.shape == (512, 512, 4) and img[..., :3].max() > 0,
          f"[bvh] render --backend bvh: rc {rc}, image {img.shape}")
    check(not launches and not any(plain.calls.values()) and not brute.calls,
          f"[bvh] render --backend bvh: launches {launches}, plain "
          f"{plain.calls}, brute {brute.calls}")
    log(f"[bvh] python -m pt_torch.run.cli render --backend bvh (Default, "
        f"512², 4 spp, 5 bounces): exit 0, {wall:.2f} s wall, no kernel "
        f"launched, no plain or brute call, {out.name} decoded")
    res["cli_default_512_s"] = round(wall, 3)

    # (c) the walk at full size: one 1-spp, 1-bounce step on the
    # Heightfield n=224 (a closest and an any-hit trace of 262,144 lanes)
    rf = _renderer(BVH_FULL_N, 512, 1, 1, "cuda", backend="bvh")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rf._ensure_accel()
    end.record()
    torch.cuda.synchronize()
    build_ms = start.elapsed_time(end)
    full = rf.accel.bvh.bvh
    check(all(getattr(full, f).device.type == "cuda" for f in
              ("aabb_lo", "aabb_hi", "miss_next", "leaf_id", "leaf_tris")),
          "[bvh] the Heightfield's tree is not on the card")
    kernels.reset_launch_counts()
    with _LaneLog() as lanes:
        ms_full, _, st = _walk_timed(rf.render)
    _no_launches(f"[bvh] Heightfield n={BVH_FULL_N}")
    check(lanes.closest == [262144] and len(lanes.occluded) == 1,
          f"[bvh] n={BVH_FULL_N} step: lanes {lanes.closest}, "
          f"{lanes.occluded}")
    log(f"[bvh] Heightfield n={BVH_FULL_N} ({int(rf.ds.tri_idx.shape[0])} "
        f"triangles, {full.leaf_count} leaves of {full.leaf_size}, "
        f"{full.n_nodes} nodes) at 512², 1 spp, 1 bounce: build "
        f"{build_ms:.2f} ms, one step {ms_full:.1f} ms (CUDA events: a "
        f"closest trace of 262,144 lanes and its any-hit trace), "
        f"{st['steps']} lockstep steps, {st['rounds']} leaf rounds, "
        f"{st['syncs']} host syncs: {ms_full / 2:.1f} ms, "
        f"{st['steps'] / 2:.0f} steps and {st['syncs'] / 2:.0f} syncs a "
        f"trace, {ms_full / max(st['steps'], 1) * 1e3:.1f} us a lockstep "
        f"step; no kernel launched")
    res.update(full_build_ms=round(build_ms, 3), full_step_ms=round(ms_full, 1),
               full_steps=st["steps"], full_syncs=st["syncs"])
    del rf
    # (c) Renderer on the Heightfield at the cut size, 4 spp, 5 bounces
    r = _renderer(BVH_N, 512, 4, 5, "cuda", backend="bvh")
    r._ensure_accel()
    check(isinstance(r.accel.bvh, ThreadedTriangles),
          f"[bvh] accel is {type(r.accel.bvh).__name__}")
    bvh = r.accel.bvh.bvh
    kernels.reset_launch_counts()
    traverse.reset_stats()
    with _PlainCalls() as plain, _BruteCalls() as brute, _LaneLog() as lanes:
        t1 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t1)
    st = dict(traverse.stats)
    _no_launches("[bvh] Renderer")
    check(not any(plain.calls.values()) and not brute.calls,
          f"[bvh] Renderer: plain {plain.calls}, brute {brute.calls}")
    film = r.film_mean()
    check(np.isfinite(film).all() and film.max() > 0, "[bvh] film")
    rp = _renderer(BVH_N, 512, 4, 5, "cuda")
    rp.render()
    mse = float(np.mean((film - rp.film_mean()) ** 2))
    check(mse < 1e-3, f"[bvh] film against the kernels' film: MSE {mse}")
    traces = st["traces"]
    log(f"[bvh] Heightfield n={BVH_N} ({int(r.ds.tri_idx.shape[0])} "
        f"triangles, {bvh.leaf_count} leaves of {bvh.leaf_size}, "
        f"{bvh.n_nodes} nodes) at 512², 4 spp, 5 bounces: one step "
        f"{step_ms:.1f} ms (host clock, synchronized), {traces} traces "
        f"({len(lanes.closest)} closest, {len(lanes.occluded)} any-hit; "
        f"lanes {lanes.closest[:2]}...), {st['steps']} lockstep steps, "
        f"{st['rounds']} leaf rounds, {st['syncs']} host syncs: "
        f"{step_ms / traces:.1f} ms, {st['steps'] / traces:.0f} steps and "
        f"{st['syncs'] / traces:.0f} syncs a trace, "
        f"{step_ms / max(st['steps'], 1) * 1e3:.1f} us a lockstep step; "
        f"film against the kernels' film (17 K1 + 17 K2) MSE {mse:.3e}; no "
        f"kernel, plain or brute call")
    res.update(step_ms=round(step_ms, 1), traces=traces, steps=st["steps"],
               syncs=st["syncs"], rounds=st["rounds"],
               film_mse_vs_kernels=mse)
    del rp, r
    # (d) card against CPU
    films = {}
    for dev in ("cuda", "cpu"):
        rc_ = _renderer(BVH_N, 64, 1, 3, dev, backend="bvh")
        rc_.render()
        films[dev] = rc_.film_mean()
    mse = float(np.mean((films["cuda"] - films["cpu"]) ** 2))
    check(mse < 1e-3, f"[bvh] card against CPU: MSE {mse}")
    log(f"[bvh] Heightfield n={BVH_N} at 64², 1 spp, 3 bounces, card "
        f"against CPU: MSE {mse:.3e}")
    res["card_vs_cpu_mse"] = mse
    log(f"[bvh] phase 12 in {time.perf_counter() - t0:.1f} s")
    return res


def _knob_arms(r, field, expect):
    """`field` off and on in turns (off, on, on, off) on renderer `r`, one
    step each from a reset film (the same RNG): each step's film bit-equal
    to the first, its launches `expect`, no plain call. Returns ms per
    step of each arm."""
    import dataclasses
    import torch
    from pt_torch.accel import kernels
    base, times = r.settings, {False: [], True: []}
    first = None
    for on in (False, True, True, False):
        r.set_settings(dataclasses.replace(base, **{field: on}))
        r.reset_accumulation()
        kernels.reset_launch_counts()
        with _PlainCalls() as plain:
            t1 = time.perf_counter()
            r.render()
            torch.cuda.synchronize()
            times[on].append(1e3 * (time.perf_counter() - t1))
        got = {k: v for k, v in kernels.launches.items() if v}
        check(got == expect and not any(plain.calls.values()),
              f"[knobs] {field}={on}: launches {got}, plain {plain.calls}")
        if first is None:
            first = r.accum.clone()
        check(torch.equal(r.accum.view(torch.int32),
                          first.view(torch.int32)),
              f"[knobs] {field}={on}: film differs from {field}=False")
    r.set_settings(base)
    return times


def phase_knobs():
    """Phase 13 (`[knobs]` lines): `pt`'s two lane-order knobs on the card,
    each off and on in turns at 512², 4 spp, 5 bounces: `sort_rays` on the
    Animated Heightfield (the Morton tree: 17 K3 + 17 K4 a step either
    way) and `shade_sorted` on the static Heightfield (17 K1 + 17 K2);
    films bit-equal, no plain call. Returns ms per step of each arm."""
    t0 = time.perf_counter()
    r = _renderer(build_animated_scene(port_namespace()), 512, 4, 5, "cuda")
    _step_frame(r)
    r.render()                                   # warm, and the rebuild
    sort = _knob_arms(r, "sort_rays", {"closest_v4": 17, "occluded_v4": 17})
    del r
    r = _renderer(224, 512, 4, 5, "cuda")
    r.render()
    shade = _knob_arms(r, "shade_sorted",
                       {"closest_bf8": 17, "occluded_bf8": 17})
    out = {}
    for field, times in (("sort_rays", sort), ("shade_sorted", shade)):
        log(f"[knobs] {field} off/on in turns (off, on, on, off), 512², 4 "
            f"spp, 5 bounces: films bit-equal, launches unchanged; ms a "
            f"step off {[round(t, 1) for t in times[False]]}, on "
            f"{[round(t, 1) for t in times[True]]} (host clock, "
            f"synchronized)")
        out[field] = {"off_ms": [round(t, 1) for t in times[False]],
                      "on_ms": [round(t, 1) for t in times[True]]}
    log(f"[knobs] phase 13 in {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------------ [dist]

DIST_RANKS = 4      # the [dist] gang: ranks on cuda:0 over gloo
DIST_CROSS = 64     # [dist]'s card-against-CPU film size, over the
DIST_CROSS_N = 32   # Heightfield of this grid (the CPU traces by brute force)
DIST_STEPS = 3      # timed render(4) steps of each mesh size
K12 = ("closest_bf8", "occluded_bf8")
K34 = ("closest_v4", "occluded_v4")


def _dist_settings(spp: int, bounces: int):
    from pt_torch.render.integrator import PathTracingSettings
    return PathTracingSettings(sample_count=spp, bounce_count=bounces)


def _dist_renderer(mesh, width: int, spp: int, bounces: int, device,
                   n: int):
    """`Renderer(mesh=)` on `device` (None: the rank's card) over the
    Heightfield of grid size `n`."""
    from pt_torch.run.renderer import Renderer
    from pt_torch.scene.examples import make_heightfield_scene
    r = Renderer(_dist_settings(spp, bounces), mesh=mesh, device=device)
    r.set_scene(make_heightfield_scene(n))
    r.on_resize(width, width)
    return r


def _first(x):
    """`x` on the gang's first rank, None elsewhere (films come back once)."""
    import torch.distributed as dist
    return x if dist.get_rank() == 0 else None


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dist_rank_modes(width: int, spp: int, bounces: int, device=None,
                    n: int = BVH_FULL_N):
    """[dist] (a) and (b), in every rank, on `device` (None: the rank's
    card) over the Heightfield of grid size `n`: `render_image_sharded`
    over the gang with the launch counters set to 0 just before and read
    just after and the plain versions counted; then `render_spp_sharded`
    and the 2-D meshes 4x1, 1x4 and 2x2. (film on the first rank, rays) of
    each."""
    from pt_torch.accel import kernels
    from pt_torch.dist import mesh as dm
    from pt_torch.scene.examples import make_heightfield_scene
    device = dm.rank_device(device)
    args = (*_entry_inputs(make_heightfield_scene(n), width, device), width,
            width, 0, _dist_settings(spp, bounces))
    film = dm.film_mesh(device=device)
    with _PlainCalls() as plain:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        band, rays = dm.render_image_sharded(*args, film, device)
        _sync(device)
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launches.items() if v}
    out = {"launches": launches, "secs": secs,
           "plain": {k: v for k, v in plain.calls.items() if v},
           "film": (_first(dm.assemble_film(band, film)), int(rays))}
    img, rays = dm.render_spp_sharded(*args, film, device)
    out["spp"] = (_first(img.cpu().numpy()), int(rays))
    for f, s in ((DIST_RANKS, 1), (1, DIST_RANKS), (2, 2)):
        mesh = dm.film_spp_mesh(f, s, device=device)
        band, rays = dm.render_image_spp_sharded(*args, mesh, device)
        out[f"{f}x{s}"] = (_first(dm.assemble_film(band, mesh)), int(rays))
    return out


def dist_rank_renderer(width: int, spp: int, bounces: int, device=None,
                       n: int = BVH_FULL_N):
    """[dist] (c), in every rank: `Renderer(mesh=film_mesh(ranks[:k]))` for
    k = 1, 2, 4, on `device` over the Heightfield of grid size `n` (as
    `dist_rank_modes`). Per mesh: one render(spp) step with the
    launch counters set to 0 just before and read just after and the plain
    versions counted (film on the first rank, rays, this rank's launches
    and plain calls), then DIST_STEPS timed steps after a barrier (this
    rank's seconds and peak MiB, the mesh's rays). Then the 4-rank step
    again with every compaction class patched huge (film, rays)."""
    import torch.distributed as dist
    from pt_torch.dist import mesh as dm
    from pt_torch.run import renderer as R
    out = {}
    for k in (1, 2, DIST_RANKS):
        mesh = dm.film_mesh(range(k), device=device)
        if mesh.get_coordinate() is None:
            out[k] = None
            continue
        r = _dist_renderer(mesh, width, spp, bounces, device, n)
        with _PlainCalls() as plain:
            _, _, every, rays, _ = _counted_steps(r, K12, steps=1)
        res = {"film": _first(r.film_mean()), "rays": rays,
               "launches": {k: v for k, v in every.items() if v},
               "plain": {k: v for k, v in plain.calls.items() if v}}
        dist.barrier(mesh.get_group(0))
        res["secs"], _, _, res["steps_rays"], res["peak_mib"] = (
            _counted_steps(r, K12, steps=DIST_STEPS))
        out[k] = res
    orig = R._size_class
    R._size_class = lambda n, minimum=1024: 1 << 30
    try:
        r = _dist_renderer(dm.film_mesh(device=device), width, spp, bounces,
                           device, n)
        r.render()
        out["uncompacted"] = (_first(r.film_mean()), r.rays_traced)
    finally:
        R._size_class = orig
    return out


def dist_rank_rest(width: int, bounces: int, directory: str, device=None,
                   n: int = BVH_FULL_N, cross: int = DIST_CROSS):
    """[dist] (d)-(f), in every rank, over the whole gang, on `device` over
    the Heightfield of grid size `n` (as `dist_rank_modes`):
    `render_adaptive` at tol=0 (2 spp a pixel); `OfflineRenderer` to one
    PNG in `directory`/mesh and, on a 1-rank mesh, in `directory`/one (4
    spp in steps of 2); the 4-spp film at `cross`² of the Heightfield
    n=DIST_CROSS_N for the CPU's. What the first rank gets of each."""
    from pt_torch.dist import mesh as dm
    from pt_torch.out.saver import OutputInfo
    from pt_torch.run.offline import OfflineRenderer, RenderSettings
    mesh = dm.film_mesh(device=device)
    r = _dist_renderer(mesh, width, 1, bounces, device, n)
    stats = r.render_adaptive(tol=0.0, max_spp=2, min_spp=1, check_every=2)
    out = {"adaptive": (stats, _first(r.film_mean()))}
    for name, m in (("mesh", mesh),
                    ("one", dm.film_mesh(range(1), device=device))):
        if m.get_coordinate() is None:
            continue
        path = pathlib.Path(directory) / name / "frame.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        out[name] = OfflineRenderer(_dist_renderer(
            m, width, 1, bounces, device, n)).render(RenderSettings(
            output=OutputInfo(str(path), width, width, 30.0, "png"),
            max_sample_count=4, samples_per_step=2))
    r = _dist_renderer(mesh, cross, 4, bounces, device, DIST_CROSS_N)
    r.render()
    out["cross"] = _first(r.film_mean())
    return out


def phase_dist():
    """Phase 13b (`[dist]` lines): multi-device rendering (`pt_torch.dist`,
    `Renderer(mesh=)`) by one gang of DIST_RANKS ranks that share the card,
    over gloo (nccl refuses two ranks on one card), started once; the
    Heightfield n=224 at 512², 5 bounces, 4 spp. (a) `render_image_sharded`
    over the 4 ranks: its bands joined bit-equal to `render_image_stats` in
    this process, rays equal, each rank 20 closest_v4 + 20 occluded_v4 and
    no plain version. (b) the 2-D mesh: 4x1 and 1x4 bit-equal to the 1-D
    modes, the 2x2 mean 1.5-2.6x the single film's. (c) `Renderer(mesh=)`
    over 1, 2 and 4 ranks: render(4) films and rays bit-equal to each other
    and to the single-device Renderer's here, and with compaction off;
    each rank's K1/K2 launches (17 + 17, as one device's) and no plain
    call; ms a step, Mrays/s of the mesh, peak MiB per rank (the ranks
    share one card: not a scaling figure). (d) `render_adaptive` at tol=0
    bit-equal to the single-device one. (e) `OfflineRenderer` under the
    mesh writes one PNG, its bytes equal to a 1-rank mesh's. (f) the
    sharded film at DIST_CROSS² against the CPU's, MSE < 1e-3 (the
    Heightfield n=DIST_CROSS_N: the CPU's plain versions are brute
    force). Logs the seconds of each part."""
    import shutil
    import torch
    from pt_torch.dist.launch import Gang
    from pt_torch.render.integrator import render_image_stats
    from pt_torch.scene.examples import make_heightfield_scene
    t0 = time.perf_counter()
    spp, bounces, width = 4, 5, 512
    settings = _dist_settings(spp, bounces)
    ref, ref_rays = render_image_stats(
        *_entry_inputs(make_heightfield_scene(BVH_FULL_N), width, "cuda"),
        width, width, 0, settings)
    ref = ref.cpu().numpy()
    one = _renderer(BVH_FULL_N, width, spp, bounces, "cuda")
    one.render()
    one_film, one_rays = one.film_mean(), one.rays_traced
    one = _renderer(BVH_FULL_N, width, 1, bounces, "cuda")
    one.render_adaptive(tol=0.0, max_spp=2, min_spp=1, check_every=2)
    one_adaptive = one.film_mean()
    del one
    cpu = _renderer(DIST_CROSS_N, DIST_CROSS, 4, bounces, "cpu")
    cpu.render()
    cpu_film = cpu.film_mean()
    del cpu
    directory = OUT_DIR / "dist"
    shutil.rmtree(directory, ignore_errors=True)
    secs = {"references": time.perf_counter() - t0}
    t1 = time.perf_counter()
    with Gang(DIST_RANKS, "gloo") as gang:
        secs["start"] = time.perf_counter() - t1
        log(f"[dist] gang of {DIST_RANKS} ranks over gloo: {gang.joined}")
        out = {}
        for name, fn, args in (
                ("modes", dist_rank_modes, (width, spp, bounces)),
                ("renderer", dist_rank_renderer, (width, spp, bounces)),
                ("rest", dist_rank_rest, (width, bounces, str(directory)))):
            t1 = time.perf_counter()
            out[name] = gang.run(fn, *args, deadline=300)
            secs[name] = time.perf_counter() - t1
    modes, rend, rest = out["modes"], out["renderer"], out["rest"]
    log("[dist] seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in secs.items()))

    # (a) film bands
    film, rays = modes[0]["film"]
    check(np.array_equal(film, ref), "[dist] render_image_sharded film "
          f"differs from render_image_stats': max |d| "
          f"{float(np.abs(film - ref).max())}")
    check(rays == int(ref_rays), f"[dist] rays {rays} against {int(ref_rays)}")
    want = {k: spp * bounces for k in K34}
    for rank, res in enumerate(modes):
        check(res["launches"] == want and not res["plain"],
              f"[dist] rank {rank}: render_image_sharded launched "
              f"{res['launches']}, plain calls {res['plain']}")
    log(f"[dist] render_image_sharded over {DIST_RANKS} ranks: bands joined "
        f"bit-equal to render_image_stats, rays {rays}; per rank "
        f"{[res['launches'] for res in modes]}, no plain call; "
        f"{[round(res['secs'] * 1e3, 1) for res in modes]} ms a rank")
    # (b) the 2-D mesh
    res = modes[0]
    check(np.array_equal(res[f"{DIST_RANKS}x1"][0], film)
          and res[f"{DIST_RANKS}x1"][1] == rays,
          "[dist] the 4x1 mesh differs from film sharding")
    check(np.array_equal(res[f"1x{DIST_RANKS}"][0], res["spp"][0])
          and res[f"1x{DIST_RANKS}"][1] == res["spp"][1],
          "[dist] the 1x4 mesh differs from spp sharding")
    ratio = float(res["2x2"][0].mean() / ref.mean())
    spp_ratio = float(res["spp"][0].mean() / ref.mean())
    check(1.5 < ratio < 2.6, f"[dist] 2x2 mesh mean ratio {ratio}")
    check(3.0 < spp_ratio < 5.0, f"[dist] spp mode mean ratio {spp_ratio}")
    log(f"[dist] 2-D mesh: 4x1 and 1x4 bit-equal to the 1-D modes; 2x2 "
        f"mean {ratio:.4f}x the single film, spp mode {spp_ratio:.4f}x; rays "
        f"spp {res['spp'][1]}, 2x2 {res['2x2'][1]}")
    # (c) the Renderer
    stats = {}
    for n in (1, 2, DIST_RANKS):
        first = rend[0][n]
        check(np.array_equal(first["film"], one_film)
              and first["rays"] == one_rays,
              f"[dist] Renderer over {n} ranks: film or rays ({first['rays']}"
              f" against {one_rays}) differ from one device's")
        for rank in range(n):
            res = rend[rank][n]
            check(res["launches"] == {k: 17 for k in K12}
                  and not res["plain"],
                  f"[dist] Renderer over {n} ranks, rank {rank}: launched "
                  f"{res['launches']}, plain calls {res['plain']}")
        step = max(rend[rank][n]["secs"] for rank in range(n)) / DIST_STEPS
        stats[n] = {"ms": round(step * 1e3, 1),
                    "mrays": round(first["steps_rays"] / DIST_STEPS / step
                                   / 1e6, 2),
                    "peak_mib": [round(rend[rank][n]["peak_mib"])
                                 for rank in range(n)]}
        log(f"[dist] Renderer over {n} rank(s) of one card: film bit-equal to "
            f"one device's, rays {first['rays']}, per rank 17 + 17 K1/K2, no "
            f"plain call; {stats[n]['ms']} ms a 4-spp step, "
            f"{stats[n]['mrays']} Mrays/s over the ranks, peak "
            f"{stats[n]['peak_mib']} MiB per rank")
    film_off, rays_off = rend[0]["uncompacted"]
    check(np.array_equal(film_off, one_film) and rays_off == one_rays,
          "[dist] compaction off changes the 4-rank film")
    log("[dist] Renderer over 4 ranks with compaction off: bit-equal")
    # (d) - (f)
    rest0 = rest[0]
    a_stats, a_film = rest0["adaptive"]
    check(a_stats["spp_min"] == a_stats["spp_max"] == 2
          and np.array_equal(a_film, one_adaptive),
          f"[dist] render_adaptive at tol=0 over 4 ranks {a_stats} differs "
          "from one device's")
    log(f"[dist] render_adaptive tol=0 over 4 ranks: bit-equal to one "
        f"device's, {a_stats}")
    pngs = {name: sorted((directory / name).iterdir())
            for name in ("mesh", "one")}
    check(all(len(p) == 1 for p in pngs.values())
          and rest0["mesh"] == rest0["one"] == 1
          and all(res["mesh"] == 1 for res in rest),
          f"[dist] offline: files {pngs}, frames {rest0}")
    check(pngs["mesh"][0].read_bytes() == pngs["one"][0].read_bytes(),
          "[dist] offline PNG under 4 ranks differs from a 1-rank mesh's")
    log(f"[dist] OfflineRenderer over 4 ranks: one PNG "
        f"({pngs['mesh'][0].stat().st_size} bytes), equal to a 1-rank "
        "mesh's")
    mse = float(np.mean((rest0["cross"] - cpu_film) ** 2))
    check(mse < 1e-3, f"[dist] card against CPU at {DIST_CROSS}²: MSE {mse}")
    log(f"[dist] sharded card film against the CPU at {DIST_CROSS}²: MSE "
        f"{mse:.3e}")
    secs = time.perf_counter() - t0
    log(f"[dist] phase 13b in {secs:.1f} s")
    return {"launches_dist": {
        **{k: [res["launches"].get(k, 0) for res in modes] for k in K34},
        **{k: [rend[rank][DIST_RANKS]["launches"].get(k, 0)
               for rank in range(DIST_RANKS)] for k in K12}},
        "steps": stats, "seconds": round(secs, 1)}


def _http(base, path, body=None):
    """GET (body None) or POST `body` as JSON to the viewer: the reply's
    bytes."""
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=30) as reply:
        return reply.read()


def _wait(cond, what, timeout=120.0):
    t_end = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < t_end, f"[view] timed out waiting for "
              f"{what}")
        time.sleep(0.05)


def phase_view():
    """Phase 14 (`[view]` lines): `run_viewer` on a loopback port, in a
    thread, over an `Application` on the card with the Heightfield
    (VIEW_N) at 512², 5 bounces, the kernel backend, and the config's
    samples-per-frame cap at 1, so that every frame renders 1 sample and
    launches the same kernels as every other frame of its scene.
    Through HTTP: GET /frame and /state (the JPEG decoded within a mean
    absolute error of 8 of 255 of the `snapshot()` it was published
    from); POST /input with W held (the camera moves, the film restarts);
    POST /settings (bounce_count 3, exposure 2.0, taken); POST /scene to
    the Animated Heightfield (registered as "Chip Smoke/Animated
    Heightfield": only K3/K4 launch from then on); the H key
    (`reload_shaders`: eleven modules re-imported, frames still come); the
    render trigger (a PNG in `render_dir`). No plain version runs. Logs
    frames a second, JPEG ms and the launches a frame, which must be one
    count on every counted frame of a scene. This phase comes
    last: it re-imports the port's shading modules in this process.
    Returns the launches a frame and the loop's numbers."""
    import threading
    from PIL import Image
    from pt_torch.accel import kernels
    from pt_torch.core.config import Config
    from pt_torch.core.input import Input
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run import viewer
    from pt_torch.run.app import Application
    from pt_torch.scene.manager import CustomSceneLoader
    from pt_torch.scene.textures import decode_png
    t0 = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    shot = OUT_DIR / "view_render.png"
    shot.unlink(missing_ok=True)
    app = Application(Config(max_samples_per_frame=1))
    check(app.renderer.device.type == "cuda", "[view] not on the card")
    app.scene_manager.register(
        "Chip Smoke", "Animated Heightfield", CustomSceneLoader(
            lambda b: fill_animated_scene(b, port_namespace(), VIEW_N)))
    app.renderer.set_settings(PathTracingSettings(sample_count=1,
                                                  bounce_count=5))
    app.init("Test Scenes", "Heightfield", 512, 512)
    app.renderer.wait_for_textures()
    frames, lock, holder = [], threading.Lock(), {}

    class Recorded(viewer.ViewerServer):
        def start(self):
            super().start()
            holder["server"] = self

        def publish(self, img, state=None):
            t1 = time.perf_counter()
            super().publish(img, state)
            with lock:
                frames.append(dict(
                    t=t1, ms=1e3 * (time.perf_counter() - t1),
                    jpeg=self._jpeg, img=np.array(img, copy=True),
                    launches=dict(kernels.launches),
                    scene=app.renderer.scene.name,
                    total=(state or {}).get("total_samples")))
                for f in frames[:-24]:
                    f["img"] = None                 # keep the last 24

    def seen():
        with lock:
            return len(frames)

    orig = viewer.ViewerServer
    viewer.ViewerServer = Recorded
    kernels.reset_launch_counts()
    result = []
    th = threading.Thread(target=lambda: result.append(viewer.run_viewer(
        app, port=0, duration_seconds=900.0, show_hud=False,
        render_dir=str(OUT_DIR))))
    try:
        with _PlainCalls() as plain:
            th.start()
            _wait(lambda: seen() >= 6, "six frames")
            server = holder["server"]
            base = f"http://{server.host}:{server.port}"
            jpeg = _http(base, "/frame")
            state = json.loads(_http(base, "/state"))
            with lock:
                match = [f for f in frames if f["jpeg"] == jpeg
                         and f["img"] is not None]
            check(match, "[view] /frame is no frame published")
            dec = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"),
                             np.float32)
            mae = float(np.mean(np.abs(dec - np.clip(match[-1]["img"], 0, 1)
                                       * 255.0)))
            check(dec.shape == (512, 512, 3) and mae < 8.0,
                  f"[view] /frame {dec.shape} against snapshot(): mean "
                  f"abs error {mae:.2f} of 255")
            check(state["size"] == [512, 512] and state["total_samples"] >= 1,
                  f"[view] /state {state}")
            n_still = seen()
            cam = app.renderer.scene.cameras[0]
            p0 = cam.position.copy()
            with lock:
                total0 = frames[-1]["total"]
            _http(base, "/input", {"events": [
                {"type": "key", "key": "w", "pressed": True}]})
            _wait(lambda: not np.array_equal(cam.position, p0),
                  "the camera to move")
            _http(base, "/input", {"events": [
                {"type": "key", "key": "w", "pressed": False}]})
            n_move = seen()
            _wait(lambda: seen() >= n_move + 2, "frames after the move")
            with lock:
                after = [f["total"] for f in frames[n_move - 1:]]
            check(min(after) < total0 or total0 <= 2,
                  f"[view] the film did not restart: {total0} then {after}")
            moved = float(np.linalg.norm(cam.position - p0))
            _http(base, "/settings", {"bounce_count": 3, "exposure": 2.0})
            _wait(lambda: (app.renderer.settings.bounce_count == 3
                           and app.renderer.post.exposure == 2.0),
                  "the settings")
            scenes = json.loads(_http(base, "/scenes"))["scenes"]
            check("Chip Smoke/Animated Heightfield" in scenes,
                  f"[view] /scenes {scenes}")
            _http(base, "/scene", {"scene": "Chip Smoke/Animated Heightfield"})
            _wait(lambda: app.renderer.scene.name == "Animated Heightfield",
                  "the scene switch")
            n_switch = seen()
            _wait(lambda: seen() >= n_switch + 6, "animated frames")
            _http(base, "/input", {"events": [
                {"type": "key", "key": "h", "pressed": True},
                {"type": "key", "key": "h", "pressed": False}]})
            _wait(lambda: app.tasks.progress("ShaderCompilation") == (11, 11),
                  "the shader reload")
            n_reload = seen()
            _wait(lambda: seen() >= n_reload + 3, "frames after the reload")
            n_trigger = seen()
            _http(base, "/render", {"path": shot.name, "max_samples": 4})
            _wait(shot.exists, "the render trigger's PNG")
            n_shot = seen()
            _wait(lambda: seen() >= n_shot + 2, "frames after the render")
            app.stop()
            th.join(timeout=120)
    finally:
        app.stop()
        viewer.ViewerServer = orig
        for k in ("w", "h"):
            Input.set_key(k, False)
    check(not th.is_alive() and result, "[view] the loop did not end")
    check(not any(plain.calls.values()),
          f"[view] plain versions called: {plain.calls}")
    img = decode_png(shot.read_bytes())
    check(img.shape == (512, 512, 4) and img[..., :3].max() > 0,
          f"[view] the render trigger's PNG {img.shape}")
    # diffs[j]: the launches of frame j+1's render, between publishes j and
    # j+1. Counted: the still frames before the first request (the first
    # render built the tree), and the animated frames from the switch up
    # to the render trigger (whose offline render lands in a frame's diff)
    diffs = [{k: b["launches"][k] - a["launches"].get(k, 0)
              for k in b["launches"]
              if b["launches"][k] - a["launches"].get(k, 0)}
             for a, b in zip(frames, frames[1:])]
    static = diffs[1:n_still - 1]
    anim = [diffs[j] for j in range(n_switch, n_trigger - 1)
            if frames[j]["scene"] == "Animated Heightfield"]
    check(static and all(set(f) == {"closest_bf8", "occluded_bf8"}
                         for f in static),
          f"[view] static frames' launches {static[:4]}")
    check(len(anim) >= 6 and all(
        f and set(f) <= {"closest_v4", "occluded_v4"} for f in anim),
        f"[view] animated frames' launches {anim[:6]}")
    check(all(f.get("closest_v4") and f.get("occluded_v4")
              for f in anim), f"[view] an animated frame without K3/K4 "
          f"{anim}")
    still = frames[1:n_still]
    fps = (len(still) - 1) / (still[-1]["t"] - still[0]["t"])
    jpeg_ms = [f["ms"] for f in frames]

    # one sample a frame: every counted frame of a scene launches the same
    static_counts = {tuple(sorted(f.items())) for f in static}
    anim_counts = {tuple(sorted(f.items())) for f in anim}
    check(len(static_counts) == 1 and len(anim_counts) == 1,
          f"[view] launches differ between frames: still {static_counts}, "
          f"animated {anim_counts}")
    launches_view = {**static[0], **anim[0]}
    log(f"[view] run_viewer on {base}, Heightfield n={VIEW_N} at 512², 5 "
        f"bounces, on the card: /frame within {mae:.2f} of 255 of its "
        f"snapshot(); W held moved the camera {moved:.3f} and restarted the "
        f"film ({total0} spp, then {after}); bounce_count 3 and exposure "
        f"2.0 taken; /scene to the Animated Heightfield: {len(anim)} frames, "
        f"only K3/K4; H: ShaderCompilation (11, 11), frames still came; "
        f"/render wrote {shot.name}; no plain call")
    log(f"[view] live loop {fps:.2f} frames/s over {len(still)} still "
        f"frames; publish (JPEG encode) {np.median(jpeg_ms):.2f} ms median, "
        f"{max(jpeg_ms):.2f} max over {len(frames)} frames; launches a "
        f"frame {launches_view}, the same on each of {len(static)} still "
        f"and {len(anim)} animated frames")
    log(f"[view] phase 14 in {time.perf_counter() - t0:.1f} s")
    return {"launches_view": launches_view, "fps": round(fps, 3),
            "jpeg_ms_median": round(float(np.median(jpeg_ms)), 3),
            "frames": len(frames), "jpeg_mae": round(mae, 3)}


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
    from pt_torch.run.renderer import Renderer

    def fresh(phase, *args):
        # a phase's build seconds and peak memory count its own trees only
        Renderer._accel_cache = None
        return phase(*args)
    errs = fresh(phase_parity)
    counts, times, main_stats = fresh(phase_main)
    loop_stats = fresh(phase_loop)
    a_counts, a_times, anim_stats = fresh(phase_animated)
    fresh(phase_alpha)
    i_counts, i_times, inst_stats = fresh(phase_instanced)
    ar_launches, ar_rows, ar_stats = fresh(phase_archive)
    round_rows = fresh(phase_courtyard)
    fresh(phase_default)
    fresh(phase_cross_device)
    entry = fresh(phase_entry)
    debug = fresh(phase_debug)
    imp = fresh(phase_import)
    b_rows = fresh(phase_budget)
    bvh = fresh(phase_bvh)
    knobs = fresh(phase_knobs)
    ranks = fresh(phase_dist)
    view = fresh(phase_view)        # last: it re-imports shading modules
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
        if k in entry["launches"]:   # the [entry] phase's two callers
            rows[-1]["launches_entry"] = entry["launches"][k]
        if k in debug["launches_hdr"]:       # phase 10c: an HDR10 step
            rows[-1]["launches_hdr"] = debug["launches_hdr"][k]
        if k in debug["launches_debug"]:     # phase 10c: a debug frame
            rows[-1]["launches_debug"] = debug["launches_debug"][k]
        # phase 10d: the imported Courtyard's CLI render (K1/K2, or K5/K6)
        # and a 4-spp step of the animated import (K3/K4)
        imported = {**imp["launches_cli"], **imp["launches_anim"]}
        if k in imported:
            rows[-1]["launches_import"] = imported[k]
        if k == "closest_v4":
            rows[-1]["launches_debug_alpha"] = debug["launches_debug_alpha"]
        if k in view["launches_view"]:       # phase 14: a viewer frame
            rows[-1]["launches_view"] = view["launches_view"][k]
        if k in ranks["launches_dist"]:      # phase 13b: per rank
            rows[-1]["launches_dist"] = ranks["launches_dist"][k]
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
    rows.extend(round_rows.values())
    log(f"[done] {time.perf_counter() - t_start:.1f} s; static main path "
        f"{json.dumps(main_stats)}; render loop against the per-sample "
        f"loop {json.dumps(loop_stats)}; animated main path "
        f"{json.dumps(anim_stats)}; instanced main path "
        f"{json.dumps(inst_stats)}; archive path (b) "
        f"{json.dumps(ar_stats)}; entry points (render_image_stats per "
        f"call, the CLI's 512² render) {json.dumps(entry)}; debug frames "
        f"and HDR10 {json.dumps(debug)}; scene import "
        f"{json.dumps(imp)}; LBVH backend {json.dumps(bvh)}; lane-order "
        f"knobs {json.dumps(knobs)}; ranks on one card {json.dumps(ranks)}; "
        f"viewer {json.dumps(view)}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
