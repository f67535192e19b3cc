"""Frame orchestrator: the progressive wavefront render of a scene.

Port of `pt.run.renderer.Renderer` on one device: it owns the device
scene, textures, acceleration structure and accumulation film.

`_ensure_accel` builds the structure. A static scene gets the native SBVH
at block 32 collapsed to BF8 (kernels K1/K2), with opaque and alpha subset
trees when it has alpha-tested triangles, and the binary SBVH tree (K3/K4)
when the collapse does not fit. A static scene whose `instancing` policy
selects it gets the shared-BLAS structure instead (`BF8Instanced`, kernels
K5/K6); where that build is infeasible the scene is flattened as above.
Static structures live in a class-wide LRU cache of four, keyed by the
device and a hash of the geometry, so a second `set_scene` of the same
scene, or a frame where only a light moved, builds nothing; an instanced
build proved infeasible is cached too and goes straight to flatten. A
scene with animated instances or skinned geometry gets the Morton
`PacketBVH`, rebuilt on the device after every
`update_scene_data(scene_changed=True)` (K3/K4).

`render(samples)` runs `pt`'s loop. Up to `_MAX_GROUP_LANES` lanes of
samples merge into one spp-major wavefront (lane = pixel * g + rep, g a
power of two) that runs raygen and bounce 0; the carry then splits into
one wavefront per sample for bounces 1.., each compacted to a
power-of-two size class of its live lanes (`_trace_tail`). The classes
come from live counts observed once every 16 render steps, read back in
one batched copy; nothing else in a step reads the device. Each lane seeds
its RNG from (pixel, samples before it), so the film equals repeated
`render(1)` calls, with compaction on or off, bit for bit. Lanes are
tile-ordered (`_tile_order`) so each run of neighbouring rays covers a
compact square of pixels.

`render_adaptive` samples each pixel until its tonemapped confidence
interval (or the film's estimated MSE) meets a target, dealing full-film
dispatches to the pixels with the largest deficit. A pixel that holds
several lanes of one dispatch is accumulated in as many ordered passes,
so its film is the same on the card and the CPU from run to run.

With `settings.backend = "brute"` no tree is built: every trace tests
every triangle (`BruteTriangles`), and a static alpha scene gets `pt`'s
brute opaque/alpha split. With `settings.backend = "bvh"` every scene gets
`pt`'s threaded LBVH (`ThreadedTriangles`, leaves of
`settings.bvh_leaf_size`), built on the device once for a static scene and
after every change of an animated one, never cached, and walked in tensor
code: no kernel runs. Where a static scene's opaque or alpha subset tree
fails to build and that subset holds at most 4096 triangles, the split is
kept, as in `pt`, and the subset gets its Morton `PacketBVH`, built on the
device and walked by K3/K4 (`pt` traces it by brute force: the same hits).

Each stage call (raygen, a bounce) goes through the compile watch
(`pt_torch.core.compilewatch.stage_call`, as `pt`'s `_guard`): a transient
error is retried, a stage blocked for long is reported.

`set_scene` streams textures by default: the placeholder pool first, the
real pool from a loader thread, swapped in (and the film restarted) by the
next `render` that finds it ready; `wait_for_textures` blocks for it.

For the offline path and the app: `set_settings` (a change resets the film,
a change of backend or of LBVH leaf size also the accel), `on_update` (the
run loop's samples-per-frame controller), `snapshot(hdr=)` (HDR10 PQ
output) and `save_checkpoint` / `load_checkpoint` in `pt`'s `.npz` keys; a
resumed render continues the exact RNG stream.

With `mesh` (a 1-D `DeviceMesh` of `pt_torch.dist.film_mesh`, one rank
per band of film rows; `pt`'s `Renderer(mesh=)`), each rank holds its band
of the film and renders it with the same loops: its lanes are its band's
pixels, tile-ordered within the band, and its film is the band's rows.
Every method that reads the film, the ray count or the loops' decisions is
then collective, and every rank of the mesh calls the same methods in the
same order: the compaction plans come from the largest live count of any
rank (one all-reduce where a plan is observed), the adaptive film's
statistics from the gathered film (each rank deals the same allocation,
every band's, and traces its own), `max_seconds` from the ranks' agreement,
`rays_traced` is every rank's count, and `snapshot`, `film_mean` and
`save_checkpoint` gather the film (`assemble_film`). Only the mesh's first
rank writes a checkpoint; every rank resumes one, under a mesh of any size
or none. Under a mesh `set_scene` does not stream textures, so every band
is shaded with the scene's own pool from the first sample on. The bands
joined equal the single-device film bit for bit.

`pt`'s timers and stats go to the process-wide board
(`pt_torch.core.stats`): "Mesh Upload", "Texture Upload", "Acceleration
Structure Build" (host seconds), "Render" (on the card the device time of
a step, between two CUDA events, folded in by a later flush once they
have run; host seconds on the CPU), and "Total Samples", "Adaptive Mean
SPP" and "Samples Per Frame".

While the recorder of `pt_torch.core.stats` is on, the loop records its
stages as spans: "Render" (the step), "raygen", "bounce" (with its index),
"compact" (a compaction and its scatter back), "observe" (the plan's
read-back), "accumulate" (the film's add), "Acceleration Structure Build"
(a rebuild), and in `snapshot` "post" and "readback" (the image's copy to
the host); `bounce_once` records its own.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from pt_torch import default_device
from pt_torch.accel.bvh8 import (build_bf8, build_packet_bvh,
                                 build_packet_bvh_sah)
from pt_torch.accel.instanced import (build_instanced_bf8,
                                      build_instanced_split)
from pt_torch.core.cache import LRUCache, fnv1a
from pt_torch.core.compilewatch import stage_call as _guard
from pt_torch.core.stats import Stats, Timer, span
from pt_torch.dist import mesh as dmesh
from pt_torch.post.pipeline import PostProcessSettings, postprocess
from pt_torch.render.integrator import (Accel, AlphaSplit, BounceCarry,
                                        BruteTriangles, PathTracingSettings,
                                        _finite_or_zero, bounce_once,
                                        init_rng_state,
                                        make_alpha_split_brute,
                                        prepare_accel, prepare_attribs,
                                        raygen, resolve_backend, start_carry)
from pt_torch.render.textures import DeviceTextures, default_texture_pool
from pt_torch.run.adaptive import AdaptiveSampleController
from pt_torch.scene.builder import Scene
from pt_torch.scene.flatten import (DeviceScene, flatten_scene,
                                    shared_dup_ratio, shared_mesh_layout,
                                    update_seg_transforms)
from pt_torch.scene.textures import build_scene_textures

_MASK32 = 0xFFFFFFFF

# spp-major group cap: the largest merged wavefront dispatched as one unit
# (a 512² film merges 4 spp exactly, 1080p stays per sample)
_MAX_GROUP_LANES = 1 << 20

# the largest opaque or alpha subset that keeps the split when its tree
# fails to build (`pt`'s rule); a larger one drops the split
_FAILED_SUBSET_MAX = 4096

_LUM = np.array([0.2126, 0.7152, 0.0722], np.float32)


def _tile_order(width: int, height: int, tile: int = 32) -> np.ndarray:
    """Pixel visit order grouping 32x32 tiles: each run of 1024 lanes then
    covers a compact square tile instead of a thin scanline strip."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    lin = (ys * width + xs)
    ty, iy = np.divmod(ys, tile)
    tx, ix = np.divmod(xs, tile)
    tiles_x = (width + tile - 1) // tile
    key = ((ty * tiles_x + tx) * tile + iy) * tile + ix
    return lin.reshape(-1)[np.argsort(key.reshape(-1), kind="stable")]


def _carry_map(fn, *carries):
    """`fn` applied field by field across carries (BounceCarry and its
    DiffRays), as a tree map. It recurses by name, not through a closure
    of its own: a closure that calls itself is a reference cycle, which
    would keep `fn` (and the permutation a compaction's `fn` holds) on the
    device until the cyclic garbage collector next runs."""
    if isinstance(carries[0], tuple):
        return type(carries[0])(*(_carry_map(fn, *f)
                                  for f in zip(*carries)))
    return fn(*carries)


def _compact(carry: BounceCarry, k: int):
    """Gather the live lanes of `carry` into a k-lane sub-batch (k a power
    of two, in practice >= the live count): a stable partition, live lanes
    first in their order, then dead lanes as padding. Dead lanes neither
    draw random numbers nor add radiance, so the film is unchanged. The 0-d
    ray counter passes through. Returns (sub_carry, perm), perm mapping
    sub-lane → lane."""
    order = torch.argsort((~carry.alive).to(torch.int32), stable=True)
    perm = order[:k]
    return _carry_map(lambda a: a[perm] if a.ndim else a, carry), perm


def _scatter(full: BounceCarry, sub: BounceCarry, perm) -> BounceCarry:
    """Write a compacted sub-batch back into the full carry."""
    return _carry_map(lambda f, s: f.index_copy(0, perm, s) if f.ndim else s,
                      full, sub)


def _size_class(n_alive: int, minimum: int = 1024) -> int:
    return max(minimum, 1 << max(0, (n_alive - 1).bit_length()))


def _plan_of(counts) -> list:
    """Size classes from observed live counts, with 1.35x headroom (live
    counts drift only by noise between steps)."""
    return [_size_class(int(1.35 * c)) if c > 0 else 1024 for c in counts]


def _split_group(carry: BounceCarry, g: int) -> BounceCarry:
    """De-interleave a g-sample spp-major group (lane = pixel * g + rep)
    into rep-major (g, n, ...) stacks, one transpose per field. The ray
    counter becomes zeros: the caller books the grouped count once."""
    def de(a):
        if not a.ndim:
            return torch.zeros((g,), dtype=a.dtype, device=a.device)
        return a.reshape(-1, g, *a.shape[1:]).transpose(0, 1).contiguous()
    return _carry_map(de, carry)


def _take_rep(stacked: BounceCarry, rep: int) -> BounceCarry:
    """One sample's contiguous wavefront of a de-interleaved group."""
    return _carry_map(lambda a: a[rep], stacked)


def _largest_remainder_alloc(deficit: np.ndarray,
                             budget: int) -> np.ndarray:
    """Proportional integer allocation: sum(alloc) == budget,
    alloc <= deficit elementwise (largest-remainder rounding).
    Requires 0 < budget <= deficit.sum()."""
    total = int(deficit.sum())
    alloc = (deficit * budget) // total
    rem = budget - int(alloc.sum())
    while rem > 0:
        frac = deficit * budget - alloc * total
        frac[alloc >= deficit] = -1
        bump = np.argsort(-frac, kind="stable")[:rem]
        bump = bump[frac[bump] >= 0]
        if len(bump) == 0:
            break
        alloc[bump] += 1
        rem -= len(bump)
    return alloc


def _rep_major_stream(alloc: np.ndarray, base_counts: np.ndarray):
    """(pixel, frame) dispatch stream, repetition-major: every pixel's
    rep-0 sample first (film order), then rep-1, ...: a chunk of the stream
    covers mostly distinct pixels in film order, and a pixel's duplicates
    carry consecutive frame counters. An empty allocation gives empty
    streams."""
    empty = np.zeros(0, np.int64)
    parts_p, parts_f = [empty], [empty]
    for rep in range(int(alloc.max())):
        sel = np.flatnonzero(alloc > rep)
        parts_p.append(sel)
        parts_f.append(base_counts[sel] + rep)
    return np.concatenate(parts_p), np.concatenate(parts_f)


def _occurrence_passes(lanes: np.ndarray, real: np.ndarray):
    """Split a dispatch's real lanes (sorted by `lanes`, so one pixel's
    lanes are adjacent and in stream order) into passes in which each pixel
    appears once: pass o holds each pixel's o-th lane. Adding pass by pass
    gives every pixel its samples in frame order, with no two adds to one
    pixel in one scatter."""
    idx = np.flatnonzero(real)
    if not len(idx):
        return []
    ln = lanes[idx]
    start = np.r_[True, ln[1:] != ln[:-1]]
    first = np.flatnonzero(start)
    occ = np.arange(len(ln)) - first[np.cumsum(start) - 1]
    return [idx[occ == o] for o in range(int(occ.max()) + 1)]


def _geo_key(a: np.ndarray):
    """A content key of `a`: FNV-1a over a strided sample of rows plus exact
    global reductions, so that any change of a vertex changes the key."""
    step = max(1, len(a) // 1024)
    return (a.shape, fnv1a(np.ascontiguousarray(a[::step]).tobytes()),
            float(a.astype(np.float64).sum()), float(a.min()),
            float(a.max()))


class Renderer:
    """Progressive wavefront renderer for one scene."""

    # static-scene accel LRU shared across Renderer instances (≙ the
    # reference's LRU-cached pipeline variants, Core/Cache.h): the SBVH
    # build and BF8 collapse run on the host and take seconds
    _accel_cache: Optional[LRUCache] = None
    # negative-cache sentinel: a scene key whose instanced build proved
    # infeasible skips straight to flatten on every later rebuild
    _INFEASIBLE = "instanced-infeasible"

    def __init__(self, settings: Optional[PathTracingSettings] = None,
                 post: Optional[PostProcessSettings] = None,
                 device=None, mesh=None, instancing: str = "auto",
                 min_refresh_rate: float = 60.0,
                 max_samples_per_frame: int = 64):
        """`device`: None → `cuda:0` (raises without a card), or the rank's
        device under a mesh (`rank_device`); "cpu" runs the kernels' plain
        versions. `mesh`: a 1-D `DeviceMesh` of film-row bands that holds
        this rank (see the module's docstring), or None for one device.
        `instancing`: the shared-BLAS policy
        for static scenes: "auto" switches to the instanced structure when
        geometry reuse is heavy (see `_want_instanced`), "shared" forces it
        where it is feasible, "flatten" disables it.
        `min_refresh_rate` / `max_samples_per_frame`: the limits of the
        samples-per-frame controller that `on_update` feeds."""
        self.mesh = mesh
        # this rank's band of film rows (0 of 1 on one device)
        if mesh is None:
            self.device = default_device(device)
            self.band, self._bands, self._group = 0, 1, None
        else:
            if mesh.ndim != 1:
                raise ValueError("Renderer shards film rows over a 1-D mesh, "
                                 f"not {mesh}")
            self.device = dmesh.rank_device(device)
            (self.band,) = dmesh.coordinate(mesh)
            self._bands = mesh.size()
            self._group = mesh.get_group(0)
        self.instancing = instancing
        self.settings = settings or PathTracingSettings()
        self.post = post or PostProcessSettings()
        self.width = 0
        self.height = 0
        self._rows = 0          # this rank's film rows (all of them alone)
        self.ds: Optional[DeviceScene] = None
        self.tex: Optional[DeviceTextures] = None
        self.accel: Optional[Accel] = None
        self.scene: Optional[Scene] = None
        # (H, W, 3) f32 film; this rank's (H / bands, W, 3) rows on a mesh
        self.accum: Optional[torch.Tensor] = None
        self.total_samples = 0
        # ray counter: per-sample 0-d device tensors plus a folded host
        # int; `_fold_rays` bounds the list, `rays_traced` reads both
        self._rays_chunks: list = []
        self._rays_host = 0
        self._rays_lock = threading.Lock()
        self.camera_index = 0
        self._px = self._py = self._film_perm = None
        self._order_np = None
        # adaptive film: per-pixel sample counts (film order, host, the
        # whole film on every rank) and luminance second moments (film
        # order, device, this rank's band)
        self._spp_map: Optional[np.ndarray] = None
        self._accum_sq: Optional[torch.Tensor] = None
        self._accel_dirty = True
        # compaction plans keyed by (kind, lanes): "tail" plans for the
        # per-sample tails of render(), "full" plans for render_adaptive
        self._plans: dict = {}
        self._plan_ages: dict = {}
        # spp-major group lane arrays keyed by group size
        self._group_cache: dict = {}
        # texture streaming: generation tag, finished pool, loader thread
        self._tex_gen = 0
        self._pending_tex = None
        self._tex_thread: Optional[threading.Thread] = None
        self.adaptive = AdaptiveSampleController(min_refresh_rate,
                                                 max_samples_per_frame)

    # -- scene management --------------------------------------------------
    def set_scene(self, scene: Scene, tex: Optional[DeviceTextures] = None,
                  stream_textures: bool = True) -> None:
        """Upload a new scene (≙ Renderer::UpdateSceneData). Without `tex`
        the pool is built from the scene's textures: with
        `stream_textures`, rendering starts at once on the placeholder
        pool while a loader thread builds the real one, which the next
        render swaps in (restarting the film; ≙ the TextureUploader's
        placeholder-then-swap table, TextureUploader.cpp:272-383). Under
        a mesh the pool is built before this returns: every band is shaded
        with the same pool."""
        self.scene = scene
        with Timer("Mesh Upload"):
            self.ds = flatten_scene(scene, device=self.device)
        # a loader of an earlier scene that finishes after this call must
        # not install its pool: its generation no longer matches
        self._tex_gen += 1
        self._pending_tex = None
        self._tex_thread = None
        if tex is not None:
            self.tex = tex
        elif scene.textures and stream_textures and self.mesh is None:
            self.tex = default_texture_pool(device=self.device)
            gen, device = self._tex_gen, self.device

            def load() -> None:
                try:
                    self._pending_tex = (gen, build_scene_textures(
                        scene, device=device))
                except Exception as exc:    # handed to the render thread
                    self._pending_tex = (gen, exc)

            self._tex_thread = threading.Thread(target=load, daemon=True)
            self._tex_thread.start()
        elif scene.textures:
            with Timer("Texture Upload"):
                self.tex = build_scene_textures(scene, device=self.device)
        else:
            self.tex = default_texture_pool(device=self.device)
        self._accel_dirty = True
        self.reset_accumulation()

    def _poll_textures(self) -> None:
        """Swap in the streamed pool once the loader finished, and restart
        the film (≙ Renderer::UpdateTexture, Renderer.cpp:441-470). A pool
        of an earlier scene is dropped; a loader's error is raised here."""
        pending = self._pending_tex
        if pending is None:
            return
        gen, pool = pending
        self._pending_tex = None
        if gen != self._tex_gen:
            return
        if isinstance(pool, Exception):
            raise RuntimeError("the texture loader failed") from pool
        self.tex = pool
        self.reset_accumulation()

    def wait_for_textures(self) -> None:
        """Block until the streamed pool is built, then swap it in."""
        t = self._tex_thread
        if t is not None and t.is_alive():
            t.join()
        self._poll_textures()

    def update_scene_data(self, scene_changed: bool = False) -> None:
        """Per frame: after `scene.update(dt)` moved something, refresh the
        animated transforms, mark the accel for its rebuild and reset the
        accumulation."""
        if self.scene is None:
            raise RuntimeError("no scene set")
        if scene_changed:
            self.ds = update_seg_transforms(self.ds, self.scene)
            self._accel_dirty = True
            self.reset_accumulation()

    def on_resize(self, width: int, height: int) -> None:
        """A new film size. Under a mesh the height must be divisible by the
        mesh's size, and this rank's lanes are its band's pixels, in
        `_tile_order` within the band."""
        if (self.width, self.height) == (width, height):
            return
        if height % self._bands:
            raise ValueError(f"film height {height} not divisible by mesh "
                             f"{self._bands}")
        self.width, self.height = width, height
        self._rows = height // self._bands
        self._group_cache = {}
        row0 = self.band * self._rows
        ys, xs = np.meshgrid(np.arange(row0, row0 + self._rows,
                                       dtype=np.int64),
                             np.arange(width, dtype=np.int64), indexing="ij")
        order = _tile_order(width, self._rows)
        self._order_np = order
        self._px = torch.as_tensor(xs.reshape(-1)[order], device=self.device)
        self._py = torch.as_tensor(ys.reshape(-1)[order], device=self.device)
        self._film_perm = torch.as_tensor(order.astype(np.int64),
                                          device=self.device)
        self.reset_accumulation()

    def set_settings(self, settings: Optional[PathTracingSettings] = None,
                     post: Optional[PostProcessSettings] = None) -> None:
        """≙ Renderer::SetSettings (Renderer.cpp:825-852): a change of the
        path-tracing settings resets the accumulation, and a change of
        backend or of the LBVH leaf size also rebuilds the accel."""
        if settings is not None and settings != self.settings:
            resolve_backend(settings)            # an unknown backend raises
            if (settings.backend != self.settings.backend
                    or settings.bvh_leaf_size != self.settings.bvh_leaf_size):
                self._accel_dirty = True
            self.settings = settings
            self.reset_accumulation()
        if post is not None:
            self.post = post

    def reset_accumulation(self) -> None:
        """≙ ResetAccumulationImage (Renderer.cpp:801-808): the film, the
        counters, the compaction plans and the adaptive statistics."""
        if self.width and self.height:
            self.accum = torch.zeros((self._rows, self.width, 3),
                                     dtype=torch.float32, device=self.device)
        self.total_samples = 0
        with self._rays_lock:
            self._rays_chunks = []
            self._rays_host = 0
        self._plans = {}
        self._plan_ages = {}
        self._spp_map = None
        self._accum_sq = None

    def on_update(self, dt: float) -> None:
        """Feed one frame time to the samples-per-frame controller (≙
        Renderer::OnUpdate): its answer becomes `settings.sample_count`,
        the samples of the next `render()`. No reset: the film keeps
        accumulating."""
        spf = self.adaptive.on_update(dt)
        if spf != self.settings.sample_count:
            self.settings = dataclasses.replace(self.settings,
                                                sample_count=spf)
        Stats.add_stat("Samples Per Frame", spf)

    @staticmethod
    def _want_instanced(mode: str, dup_ratio: float, n_tris: int) -> bool:
        """pt's shared-BLAS selection policy: "auto" switches at heavy
        reuse (>= 4x) of at least 200k flattened triangles."""
        if mode == "flatten":
            return False
        if mode == "shared":
            return True
        return dup_ratio >= 4.0 and n_tris >= 200_000

    def _build_instanced(self, key, tri_np, opq_np, build_static, base):
        """Shared-BLAS Accel for the current scene, or None → flatten. The
        trees, or the verdict that none is feasible, are cached under
        (key, "instanced")."""
        ikey = (key, "instanced")
        hit = Renderer._accel_cache.get(ikey)
        if hit is None:
            hit = self._instanced_trees(tri_np, opq_np, build_static,
                                        base.wpos)
            Renderer._accel_cache.put(ikey, hit)
        if hit == Renderer._INFEASIBLE:
            return None
        bvh, split = hit
        return base._replace(bvh=bvh, alpha_split=split)

    def _instanced_trees(self, tri_np, opq_np, build_static, wpos):
        """(tree, AlphaSplit or None) of the shared-BLAS structure, or
        `_INFEASIBLE`.

        Opaque scenes: one BF8Instanced with the global-id remap. Alpha
        scenes: `build_instanced_split` gives the full tree (root bounds)
        plus instanced opaque/alpha subset trees for the AlphaSplit scheme;
        a subset whose instanced build is infeasible gets a flat subset
        tree from `build_static` (hybrid: the duplicated bytes of a small
        subset are acceptable), and one with no tree at all the Morton tree
        where `_subset_split` allows it. Wholly opaque or wholly alpha
        content has no split: the single-tree loops walk the full instanced
        tree."""
        layout = shared_mesh_layout(self.scene)
        if layout is None:
            return Renderer._INFEASIBLE
        meshes, seg_mesh, seg_base, _dup = layout
        st = self.ds.seg_transform.cpu().numpy().astype(np.float64)
        if not self.ds.has_alpha:
            inst = build_instanced_bf8(meshes, seg_mesh, st,
                                       seg_tri_base=seg_base,
                                       device=self.device)
            return Renderer._INFEASIBLE if inst is None else (inst, None)
        out = build_instanced_split(meshes, seg_mesh, st, seg_base,
                                    device=self.device)
        if out is None:
            return Renderer._INFEASIBLE
        full, (tree_o, sel_o), (tree_a, sel_a) = out
        split = None
        if len(sel_o) and len(sel_a):
            if tree_o is None:
                tree_o = build_static(tri_np[sel_o], opq_np[sel_o])
            if tree_a is None:
                tree_a = build_static(tri_np[sel_a], opq_np[sel_a])
            split = self._subset_split(wpos, tree_o, sel_o, tree_a, sel_a)
        return full, split

    def _subset_split(self, wpos, tree_o, sel_o, tree_a, sel_a):
        """The AlphaSplit of two subset trees (None where a build failed)
        over the world positions `wpos`, or None. A subset without a tree
        keeps the split where it holds at most `_FAILED_SUBSET_MAX`
        triangles (`pt`'s rule) and is traced through its Morton
        `PacketBVH`, built on the device (K3/K4; `pt` traces it by brute
        force, which finds the same hits); past that the scene keeps the
        single-tree loops."""
        if any(tree is None and len(sel) > _FAILED_SUBSET_MAX
               for tree, sel in ((tree_o, sel_o), (tree_a, sel_a))):
            return None
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731

        def subset(tree, sel):
            if tree is not None:
                return tree
            rows = t(sel).long()
            return build_packet_bvh(wpos, self.ds.tri_idx[rows],
                                    tri_opaque=self.ds.tri_opaque[rows])
        return AlphaSplit(subset(tree_o, sel_o), t(sel_o),
                          subset(tree_a, sel_a), t(sel_a))

    def _ensure_accel(self) -> None:
        """Build the acceleration structure when the scene changed
        (≙ pt's `_ensure_accel`), under the "Acceleration Structure Build"
        timer."""
        if not (self._accel_dirty or self.accel is None):
            return
        with Timer("Acceleration Structure Build"):
            self._build_accel()
        self._accel_dirty = False

    def _build_accel(self) -> None:
        """Animated scenes, and every scene with the LBVH backend:
        `prepare_accel` for the backend (the Morton tree or the threaded
        LBVH, on the device, or brute force). Static scenes with the brute
        backend: no tree, and on an alpha scene `pt`'s brute opaque/alpha
        split. Static scenes with the kernels: the shared-BLAS structure
        when the instancing policy selects it and it is feasible, else the
        host SBVH build, BF8 where it fits; either with opaque/alpha split
        trees on an alpha scene (a subset whose tree fails gets its Morton
        tree where `_subset_split` allows). Kernel-backend accels come
        from the cache when this device built them for the same geometry
        before; brute and LBVH accels are never cached (as in `pt`)."""
        if (self.scene.has_animated_instances
                or self.scene.has_skinned_geometry
                or resolve_backend(self.settings) == "bvh"):
            self.accel = prepare_accel(self.ds, self.settings)
            return
        base = prepare_attribs(self.ds)
        if resolve_backend(self.settings) == "brute":
            self.accel = base._replace(
                bvh=BruteTriangles(base.wpos, self.ds.tri_idx),
                alpha_split=make_alpha_split_brute(self.ds, base.wpos))
            return
        tri_np = self.ds.tri_idx.cpu().numpy()
        wpos_np = base.wpos.cpu().numpy()
        opq_np = self.ds.tri_opaque.cpu().numpy()
        if Renderer._accel_cache is None:
            Renderer._accel_cache = LRUCache(4)
        # pt's key (the opaque flags by content, not by count: two material
        # variants can swap which triangles are alpha-tested), led by the
        # device: renderers on two devices share this process's cache
        key = (str(self.device), _geo_key(wpos_np), _geo_key(tri_np),
               fnv1a(np.packbits(opq_np.astype(bool)).tobytes()),
               opq_np.shape)

        def build_static(rows, opq_rows):
            """SBVH at block 32 collapsed to BF8; when the collapse gives
            None (a single leaf, or over pt's budget), the binary SBVH tree
            at the default block, walked by K3/K4."""
            fine = build_packet_bvh_sah(wpos_np, rows, block=32,
                                        max_leaves=8192,
                                        tri_opaque_np=opq_rows, spatial=True,
                                        device=self.device)
            bvh = build_bf8(fine) if fine is not None else None
            if bvh is None:
                bvh = build_packet_bvh_sah(wpos_np, rows,
                                           tri_opaque_np=opq_rows,
                                           spatial=True, device=self.device)
            return bvh

        # shared-BLAS arm: the policy gates on counts first, so a scene it
        # rejects never pays for the layout's copies
        if self.instancing != "flatten":
            dup = shared_dup_ratio(self.scene)
            if dup is not None and self._want_instanced(
                    self.instancing, dup[0], int(tri_np.shape[0])):
                inst_accel = self._build_instanced(key, tri_np, opq_np,
                                                   build_static, base)
                if inst_accel is not None:
                    self.accel = inst_accel
                    return
                # infeasible (capacity or singular transform): flatten

        cached = Renderer._accel_cache.get(key)
        if cached is None:
            bvh = build_static(tri_np, opq_np)
            split = None
            if bvh is not None and opq_np.any() and (~opq_np).any():
                # opaque/alpha partition for the any-hit emulation loops:
                # the re-trace rounds walk a tree over the non-opaque subset
                sel_o = np.nonzero(opq_np)[0].astype(np.int32)
                sel_a = np.nonzero(~opq_np)[0].astype(np.int32)
                split = self._subset_split(
                    base.wpos,
                    build_static(tri_np[sel_o], opq_np[sel_o]), sel_o,
                    build_static(tri_np[sel_a], opq_np[sel_a]), sel_a)
            if bvh is not None:
                Renderer._accel_cache.put(key, (bvh, split))
            cached = (bvh, split)
        bvh, split = cached
        if bvh is None:
            # no static tree fits pt's node budget: the Morton tree
            self.accel = prepare_accel(self.ds, self.settings)
        else:
            self.accel = base._replace(bvh=bvh, alpha_split=split)

    # -- rendering ---------------------------------------------------------
    def render(self, samples: Optional[int] = None) -> int:
        """One progressive accumulation step: trace `samples` (default
        settings.sample_count) full paths per pixel and add them to the
        film, in spp-major groups of a power-of-two size. Returns the new
        total sample count."""
        if self.ds is None or not self.width:
            raise RuntimeError("scene or film not initialized")
        if self._spp_map is not None:
            # uniform stepping cannot continue a per-pixel-count film
            self.reset_accumulation()
        self._fold_rays()
        self._poll_textures()
        self._ensure_accel()
        inv_view, inv_proj = self._camera_mats()
        samples = samples if samples is not None else self.settings.sample_count
        n_full = self._lanes
        cap = (_MAX_GROUP_LANES // n_full if n_full <= _MAX_GROUP_LANES
               else 1)
        with Timer("Render", self.device, step=True):
            done = 0
            while done < samples:
                g = min(cap, samples - done)
                g = 1 << (g.bit_length() - 1)       # a power of two
                # only the first group of a step may observe or age the plan
                self._render_group(g, done, inv_view, inv_proj,
                                   observe_ok=(done == 0))
                done += g
        self.total_samples += samples
        Stats.add_stat("Total Samples", self.total_samples)
        return self.total_samples

    def _group_arrays(self, g: int):
        """Lane arrays of a g-sample spp-major group: lane = (tile-order
        pixel) * g + rep, so each pixel's g samples sit side by side."""
        cached = self._group_cache.get(g)
        if cached is None:
            rep = torch.arange(g, dtype=torch.int64,
                               device=self.device).repeat(self._px.shape[0])
            cached = (self._px.repeat_interleave(g),
                      self._py.repeat_interleave(g), rep)
            self._group_cache[g] = cached
        return cached

    def _render_group(self, g: int, rep0: int, inv_view, inv_proj,
                      observe_ok: bool = True) -> None:
        """Trace one g-sample group (samples rep0 .. rep0+g-1 of this step)
        and fold it into the film: raygen and bounce 0 (never compacted:
        every lane is live) as one g-merged wavefront, then each sample's
        tail as a wavefront of its own. Each lane seeds its RNG from
        (pixel, total_samples + rep0 + rep), as repeated render(1) calls
        would."""
        n_full = self._lanes
        if g == 1:
            px, py = self._px, self._py
            frames = (self.total_samples + rep0) & _MASK32
        else:
            px, py, rep = self._group_arrays(g)
            frames = (rep + (self.total_samples + rep0)) & _MASK32
        with span("raygen"):
            state = init_rng_state(px, py, self.width, frames)
            state, o, d, diff = _guard(raygen, px, py, self.width,
                                       self.height, inv_view, inv_proj, state,
                                       self.settings, what="raygen")
        with span("bounce", 0):
            carry = _guard(bounce_once, self.ds, self.tex, self.accel,
                           start_carry(state, o, d, diff), self.settings, 0,
                           what="bounce 0")
        flat = self.accum.view(-1, 3)
        if g == 1:
            subs = [carry]
        else:
            self._rays_chunks.append(carry.rays)   # grouped bounce-0 rays
            stacked = _split_group(carry, g)       # counters zeroed
            del carry                              # the merged carry's memory
            subs = [_take_rep(stacked, r) for r in range(g)]
        for r, sub in enumerate(subs):
            full = self._trace_tail(sub, n_full,
                                    observe_ok=observe_ok and r == 0)
            with span("accumulate"):
                flat.index_add_(0, self._film_perm,
                                _finite_or_zero(full.radiance))
            self._rays_chunks.append(full.rays)

    def _trace_tail(self, carry: BounceCarry, n_lanes: int,
                    observe_ok: bool = True) -> BounceCarry:
        """Bounces 1..B-1 of one sample's n_lanes-wide wavefront, with
        compaction. The plan (a size class per bounce, 1.35x the observed
        live count) is keyed ("tail", n_lanes), with plan[j] the class for
        bounce j+1. It is observed when there is none or it is 16 steps
        old; no plan is applied while observing, since an undersized class
        would truncate live paths and clamp the counts meant to correct
        it."""
        key = ("tail", n_lanes)
        plan = self._plans.get(key)
        observe = observe_ok and (plan is None
                                  or self._plan_ages.get(key, 0) >= 16)
        full, counts = self._bounces(carry, 1, None if observe else plan,
                                     observe)
        if counts:
            self._plans[key] = _plan_of(counts)
            self._plan_ages[key] = 0
        elif observe_ok:
            # age once per render step: render() passes observe_ok only
            # for the first sample of its first group
            self._plan_ages[key] = self._plan_ages.get(key, 0) + 1
        return full

    def _bounces(self, carry: BounceCarry, first: int, plan, observe: bool):
        """Bounces first..B-1 of one wavefront. After each bounce but the
        last, the live lanes are compacted to plan[bounce - first]'s size
        class where that halves the wavefront. With `observe`, also the
        live count after each bounce, read back in one copy at the end
        (under a mesh, the largest of any rank's: one all-reduce). Returns
        (the full carry, the counts or None)."""
        full, perm, cur_n = carry, None, carry.alive.shape[0]
        alive = [] if observe else None
        last = self.settings.bounce_count - 1
        for bounce in range(first, last + 1):
            with span("bounce", bounce):
                carry = _guard(bounce_once, self.ds, self.tex, self.accel,
                               carry, self.settings, bounce,
                               what=f"bounce {bounce}")
            if alive is not None:
                alive.append(torch.sum(carry.alive))
            j = bounce - first
            k = plan[j] if plan and j < len(plan) else None
            if k is not None and k <= cur_n // 2 and bounce < last:
                with span("compact"):
                    full = (carry if perm is None
                            else _scatter(full, carry, perm))
                    carry, perm = _compact(full, k)
                cur_n = k
        if perm is None:
            full = carry
        else:
            with span("compact"):
                full = _scatter(full, carry, perm)
        if alive:
            with span("observe"):
                counts = torch.stack(alive)
                if self.mesh is not None:   # each rank compacts by the largest
                    counts = dmesh.all_reduce(counts, self._group,
                                              dist.ReduceOp.MAX)
                alive = counts.cpu().tolist()
        return full, alive

    @property
    def _lanes(self) -> int:
        """Pixels of this rank's film: its band's under a mesh."""
        return self._rows * self.width

    def _camera_mats(self):
        cams = self.scene.cameras
        cam = cams[self.camera_index if 0 <= self.camera_index < len(cams)
                   else 0]
        cam.on_resize(self.width, self.height)
        t = lambda m: torch.as_tensor(np.asarray(m, np.float32),  # noqa: E731
                                      device=self.device)
        return t(cam.inv_view), t(cam.inv_proj)

    # -- the adaptive film -------------------------------------------------
    def _adaptive_deficit(self, tol, target_mse, pool, min_spp, max_spp,
                          expo):
        """One host fetch of the film's luminance moments → per-pixel sample
        deficit (film order), or None when the stopping rule is met. Under a
        mesh the moments of every band are gathered, so every rank computes
        the whole film's deficit, the same."""
        n_full = self.width * self.height
        counts = np.maximum(self._spp_map, 1)
        lum = torch.as_tensor(_LUM, device=self.device)
        s1, sq = self._whole_film(torch.stack(
            [torch.sum(self.accum.view(-1, 3) * lum, dim=-1),
             self._accum_sq], dim=1)).T
        mean_lum = s1 / counts
        if (pool > 1 and self.height % pool == 0
                and self.width % pool == 0):
            # tile-pooled per-sample variance (the film is row-major)
            within = np.maximum(sq - s1 * mean_lum, 0.0)
            hh, ww = self.height // pool, self.width // pool
            w4 = within.reshape(hh, pool, ww, pool).sum((1, 3))
            n4 = self._spp_map.reshape(hh, pool, ww, pool).sum((1, 3))
            dof = np.maximum(n4 - pool * pool, 1)
            var = np.broadcast_to(
                (w4 / dof)[:, None, :, None],
                (hh, pool, ww, pool)).reshape(-1)
        else:
            var = np.maximum(sq / counts - mean_lum * mean_lum, 0.0)
        # tonemap-space stddev: d(1-exp(-e*c))/dc = e*exp(-e*c)
        sd_tm = np.sqrt(var) * expo * np.exp(-expo * mean_lum)
        if target_mse is not None:
            var_tm = sd_tm * sd_tm
            warm = (self._spp_map >= min_spp).all()
            if warm and float(np.mean(var_tm / counts)) < target_mse:
                return None
            # MSE-optimal allocation: n_p ~ sigma_p scaled so that
            # mean(var_p/n_p) == target_mse at completion
            need = np.ceil(sd_tm * sd_tm.sum() / (target_mse * n_full))
        elif tol > 0:
            need = np.ceil((1.96 * sd_tm / tol) ** 2)
        else:
            need = np.full(n_full, float(max_spp))
        need = np.maximum(need, float(min_spp))
        return np.clip(need - self._spp_map, 0,
                       max_spp - self._spp_map).astype(np.int64)

    def render_adaptive(self, tol: float = 5e-3, max_spp: int = 1024,
                        min_spp: int = 32, check_every: int = 8,
                        target_mse: Optional[float] = None,
                        pool: int = 4,
                        max_seconds: Optional[float] = None) -> dict:
        """Noise-driven per-pixel refinement (`pt`'s render_adaptive): each
        pixel samples until the 95% confidence interval of its tonemapped
        luminance is below `tol`, or, with `target_mse`, until the film's
        estimated tonemapped MSE mean(var_p/n_p) is below it (lanes then go
        to pixels in proportion to sigma_p, not sigma_p^2). The noise is
        pooled over `pool` x `pool` tiles (1 disables), and at most
        `max_spp` samples go to a pixel.

        Every dispatch is a full-film wavefront whose lanes are dealt to
        the pixels with the largest deficit (largest-remainder rounding,
        repetition-major); a pixel's duplicates take consecutive frame
        counters, so each sample continues the RNG stream repeated
        render(1) calls would, and tol=0 gives the uniform film bit for
        bit. Tails compact by "full" plans, observed on every allocation
        round's first dispatch. `check_every` caps the dispatches of a
        round (one moment fetch each); `max_seconds` bounds the wall time
        at round granularity.

        Under a mesh each band is dealt its own lanes (`pt`'s per-band
        redistribution): every round, every rank allocates each band's
        deficit to that band's stream of n_disp dispatches (n_disp from
        the band with the largest deficit), pads a shorter stream with
        weight-0 lanes, and traces its own band's stream. One band is the
        single-device loop, and tol=0 gives its film bit for bit.

        Returns {"spp_min", "spp_max", "spp_mean", "steps"}, steps counting
        dispatches."""
        if self.ds is None or not self.width:
            raise RuntimeError("scene or film not initialized")
        self._fold_rays()
        self._poll_textures()
        self._ensure_accel()
        inv_view, inv_proj = self._camera_mats()
        n_full = self._lanes                 # pixels of this rank's band
        if self._spp_map is None:
            if self.total_samples:
                # adaptive statistics cannot be rebuilt for a uniform film
                self.reset_accumulation()
            self._spp_map = np.zeros(self.width * self.height, np.int64)
            self._accum_sq = torch.zeros((n_full,), dtype=torch.float32,
                                         device=self.device)
        mine = slice(self.band * n_full, (self.band + 1) * n_full)
        lane_of_film = np.argsort(self._order_np)
        px_np = self._px.cpu().numpy()
        py_np = self._py.cpu().numpy()
        steps = 0
        expo = float(self.post.exposure)
        deadline = (time.perf_counter() + max_seconds
                    if max_seconds is not None else None)
        with Timer("Render", self.device, step=True):
            while deadline is None or not self.any_rank(
                    time.perf_counter() >= deadline)[0]:
                deficit = self._adaptive_deficit(tol, target_mse, pool,
                                                 min_spp, max_spp, expo)
                if deficit is None or int(deficit.sum()) == 0:
                    break
                bands = deficit.reshape(self._bands, n_full)
                n_disp = int(min(check_every, max(
                    1, -(-int(bands.sum(1).max()) // n_full))))
                alloc = np.zeros_like(deficit)
                for b, band in enumerate(bands):
                    total_b = int(band.sum())
                    if total_b:
                        alloc[b * n_full:(b + 1) * n_full] = (
                            _largest_remainder_alloc(
                                band, min(total_b, n_disp * n_full)))
                pix, frm = _rep_major_stream(alloc[mine], self._spp_map[mine])
                for off in range(0, n_disp * n_full, n_full):
                    cp = pix[off:off + n_full]
                    cf = frm[off:off + n_full]
                    real = np.arange(n_full) < len(cp)
                    padn = n_full - len(cp)
                    if padn:
                        cp = np.concatenate([cp, np.zeros(padn, np.int64)])
                        cf = np.concatenate([cf, np.zeros(padn, np.int64)])
                    lanes = lane_of_film[cp]
                    # lane order keeps 32x32 film tiles contiguous
                    order = np.argsort(lanes, kind="stable")
                    lanes, cp, cf, real = (lanes[order], cp[order], cf[order],
                                           real[order])
                    # re-observe on every round's first dispatch: rounds
                    # concentrate the noisiest pixels, whose paths live longer
                    self._adaptive_dispatch(
                        px_np[lanes], py_np[lanes], cf, inv_view, inv_proj,
                        observe=off == 0,
                        passes=_occurrence_passes(lanes, real), pixels=cp)
                    steps += 1
                self._spp_map += alloc
        self.total_samples = int(self._spp_map.max())
        Stats.add_stat("Total Samples", self.total_samples)
        Stats.add_stat("Adaptive Mean SPP", float(self._spp_map.mean()))
        return {"spp_min": int(self._spp_map.min()),
                "spp_max": int(self._spp_map.max()),
                "spp_mean": float(self._spp_map.mean()),
                "steps": steps}

    def _adaptive_dispatch(self, px_np, py_np, frames_np, inv_view, inv_proj,
                           observe, passes, pixels):
        """One full-film dispatch of the adaptive film: lanes at (px, py)
        with their own frame counters, all bounces with the ("full", n)
        plan (bounce-0-based), then the film and its luminance second
        moments, pass by pass (`_occurrence_passes`): no scatter adds
        twice to one pixel, so the film is the same on every run."""
        dev = self.device
        n = len(px_np)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        px, py = t(px_np), t(py_np)
        with span("raygen"):
            state = init_rng_state(px, py, self.width,
                                   t(frames_np.astype(np.int64) & _MASK32))
            state, o, d, diff = _guard(raygen, px, py, self.width,
                                       self.height, inv_view, inv_proj, state,
                                       self.settings, what="raygen")
        key = ("full", n)
        plan = self._plans.get(key)
        full, obs = self._bounces(start_carry(state, o, d, diff), 0, plan,
                                  plan is None or observe)
        rad = _finite_or_zero(full.radiance)
        lum = torch.sum(rad * torch.as_tensor(_LUM, device=dev), dim=-1)
        flat = self.accum.view(-1, 3)
        with span("accumulate"):
            for sel in passes:
                lanes, pix = t(sel), t(pixels[sel])
                flat.index_add_(0, pix, rad[lanes])
                self._accum_sq.index_add_(0, pix, lum[lanes] * lum[lanes])
        self._rays_chunks.append(full.rays)
        if obs:
            new_plan = _plan_of(obs)
            if plan is not None:
                # counts are observed after compaction, so a bounce whose
                # true count exceeded its class shows it directly; deeper
                # bounces were depressed by that truncation: their classes
                # do not shrink on this observation
                for b in range(len(new_plan)):
                    if b < len(plan) and obs[b] > plan[b]:
                        for j in range(b + 1, len(new_plan)):
                            if j < len(plan):
                                new_plan[j] = max(new_plan[j], plan[j])
                        break
            self._plans[key] = new_plan
            self._plan_ages[key] = 0

    # -- film --------------------------------------------------------------
    def any_rank(self, *flags) -> list:
        """`flags` as bools, each OR-ed over the mesh's ranks (one
        collective), so that every rank takes the same branch."""
        if self.mesh is None:
            return [bool(f) for f in flags]
        return dmesh.any_rank(flags, self._group)

    def _whole_film(self, t: torch.Tensor) -> np.ndarray:
        """`t`, this rank's rows of a film-shaped tensor (film rows or
        film-order pixels on dim 0), as the whole film's host array: under
        a mesh every band's, gathered (`assemble_film`)."""
        if self.mesh is None:
            return t.cpu().numpy()
        return dmesh.assemble_film(t, self.mesh)

    def _counts_image(self) -> np.ndarray:
        """The adaptive film's per-pixel sample counts, (H, W, 1) f32."""
        return np.maximum(self._spp_map, 1).astype(np.float32).reshape(
            self.height, self.width, 1)

    def film_mean(self) -> np.ndarray:
        """Linear per-pixel mean radiance (host), over per-pixel counts on
        an adaptive film; the whole film under a mesh too."""
        film = self._whole_film(self.accum)
        if self._spp_map is not None:
            return film / self._counts_image()
        return film / max(self.total_samples, 1)

    def snapshot(self, hdr: bool = False) -> np.ndarray:
        """Resolve the film through the post stack → float image (host):
        SDR in [0, 1], or with `hdr` the HDR10 PQ encoding. Under a mesh
        the film is gathered first, and every rank gets the whole image."""
        accum = (self.accum if self.mesh is None else torch.as_tensor(
            self._whole_film(self.accum), device=self.device))
        with span("post"):
            if self._spp_map is not None:
                mean = accum / torch.as_tensor(self._counts_image(),
                                               device=self.device)
                out = postprocess(mean, 1.0, self.post, hdr)
            else:
                out = postprocess(accum, float(max(self.total_samples, 1)),
                                  self.post, hdr)
        with span("readback"):
            return out.cpu().numpy()

    def _fold_rays(self, keep: int = 64, limit: int = 512) -> None:
        """Bound the ray-chunk list: fold the chunks older than the last
        `keep` into the host total once there are more than `limit` (their
        work finished long ago, so reading them does not stall)."""
        if len(self._rays_chunks) <= limit:
            return
        with self._rays_lock:
            old, self._rays_chunks = (self._rays_chunks[:-keep],
                                      self._rays_chunks[-keep:])
            self._rays_host += int(torch.stack(old).sum())

    @property
    def rays_traced(self) -> int:
        """Useful rays traced since the last reset (`pt`'s count: live
        lanes of every closest trace plus every traced shadow ray); under a
        mesh, of every rank (a collective)."""
        with self._rays_lock:
            chunks = list(self._rays_chunks)
            host = self._rays_host
        mine = torch.tensor(host, dtype=torch.int64)
        if chunks:
            mine = mine + torch.stack(chunks).sum().cpu()
        if self.mesh is not None:
            mine = dmesh.all_reduce(mine, self._group)
        return int(mine)

    # -- checkpoint / resume ------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Persist the film and counters in `pt`'s keys (an adaptive film
        adds its per-pixel counts and moments); a resumed render continues
        the exact RNG stream. Under a mesh every rank calls it, the film is
        gathered, and the mesh's first rank writes the file before any rank
        returns."""
        extra = {}
        if self._spp_map is not None:
            extra = dict(spp_map=self._spp_map,
                         accum_sq=self._whole_film(self._accum_sq))
        film, rays = self._whole_film(self.accum), self.rays_traced
        if self.band == 0:
            np.savez(path, accum=film, total_samples=self.total_samples,
                     rays_total=rays, width=self.width, height=self.height,
                     **extra)
        if self.mesh is not None:
            dist.barrier(self._group)

    def load_checkpoint(self, path: str) -> None:
        """Resume from `save_checkpoint`'s file, taken under a mesh of any
        size or none: under a mesh each rank takes its band. The ray count
        goes to the mesh's first rank."""
        with np.load(path) as data:
            self.on_resize(int(data["width"]), int(data["height"]))
            rows = slice(self.band * self._rows,
                         (self.band + 1) * self._rows)
            lanes = slice(rows.start * self.width, rows.stop * self.width)
            self.accum = torch.as_tensor(data["accum"][rows],
                                         device=self.device)
            self.total_samples = int(data["total_samples"])
            with self._rays_lock:
                self._rays_chunks = []
                self._rays_host = (int(data["rays_total"])
                                   if self.band == 0 else 0)
            if "spp_map" in data:
                self._spp_map = data["spp_map"].astype(np.int64)
                self._accum_sq = torch.as_tensor(data["accum_sq"][lanes],
                                                 device=self.device)
            else:
                self._spp_map = None
                self._accum_sq = None
