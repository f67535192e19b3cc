"""Shared-BLAS instancing (TLAS semantics): the structure and its host build.

Port of the build half of `pt.accel.instanced`. The flatten layout
(`pt_torch.scene.flatten`) duplicates object-space vertices and Woop pages
per (instance, mesh) segment. This module keeps one object-space page set
per unique mesh and instances it at traversal time:

* **Build** (`build_instanced_bf8`): per unique mesh, the native SAH build
  partitions the object-space triangles into leaf blocks once (tight object
  AABBs and Woop pages with mesh-local triangle ids). The top structure is
  built over every (segment, mesh-leaf) pair's world AABB (8-corner
  transform) with singleton leaves, then collapsed to BF8 by `build_bf8`.
  Two side tables map leaf id → page id and leaf id → segment; an (S, 12)
  table holds each segment's inverse transform rows [A | b] (A = M⁻¹ linear
  3x3 row-major, b = translation).

* **Traversal** (kernels K5/K6, `pt_torch.accel.kernels.closest_bf8i` /
  `occluded_bf8i`): the BF8 walk over world-space boxes; at a leaf the ray
  is mapped into the instance's object space (o' = A o + b, d' = A d; the
  hit parameter t is invariant under an affine map applied to o and d alike,
  so tmin, tmax and the best hit stay in world parameterisation), and the
  winning page id gets the segment id OR-ed into bits
  [SEG_SHIFT, SEG_SHIFT + 10).

Capacity contract, kept exactly as `pt`'s so that both packages build
array-equal structures: mesh-local triangle ids < 2^SEG_SHIFT, segments
<= MAX_SEGS, ALPHA_TRI_BIT (bit 30) preserved, and the TPU kernels' SMEM
budget rules (`MAX_INST_LEAVES`, `MAX_INST_BLOCK`, the 600/640 KiB gates
that also set `leaf_retest`). Lifting them on Hopper is later work.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pt_torch import default_device
from pt_torch.accel.bvh8 import (ALPHA_TRI_BIT, PacketBVH, _woop_pages,
                                 build_bf8)

SEG_SHIFT = 20                      # seg id lives in bits 20..29
SEG_MASK = 0x3FF << SEG_SHIFT
TRI_MASK = (1 << SEG_SHIFT) - 1
MAX_SEGS = 1 << 10
# instanced top trees get singleton leaves (one page per leaf), so the leaf
# and page/segment tables all scale with the leaf count; a loose sanity cap,
# the byte-accurate budget check is at the end of build_instanced_bf8
MAX_INST_LEAVES = 12288
# pt's TPU kernels cannot be compiled above this block size; the build
# returns None instead of a structure they could not trace
MAX_INST_BLOCK = 256


@dataclasses.dataclass
class BF8Instanced:
    """BF8 top tree whose leaves reference shared object-space pages through
    (page, segment) indirection. Carries the integrator's `closest` /
    `occluded` / `root_bounds` protocol."""
    c_lo: torch.Tensor          # (n8*8, 3) f32 world child bounds
    c_hi: torch.Tensor          # (n8*8, 3) f32
    c_ent: torch.Tensor         # (n8*8,) i32
    l_lo: torch.Tensor          # (n_leaves, 3) f32 world leaf bounds
    l_hi: torch.Tensor          # (n_leaves, 3) f32
    leaf_page: torch.Tensor     # (n_leaves,) i32 shared-page index
    leaf_seg: torch.Tensor      # (n_leaves,) i32 owning segment
    seg_inv: torch.Tensor       # (S * 12,) f32 flat [A row-major 9 | b 3]
    pages: torch.Tensor         # (n_pages, 8, cols) f32 object-space pages
    n8: int = 0
    n_leaves: int = 0
    n_segs: int = 0
    block: int = 32
    # pt's flag for whether the leaf-bounds tables fit the TPU's SMEM; kept
    # for parity of the structure, the CUDA kernels always retest
    leaf_retest: bool = True
    root_lo: Optional[torch.Tensor] = None
    root_hi: Optional[torch.Tensor] = None
    # when set ((S,) i32: segment s's first triangle id in the flattened
    # global numbering, `shared_mesh_layout`), closest() remaps (segment,
    # mesh-local) winning ids to global flattened ids, so the integrator's
    # shading runs unchanged on instanced hits
    seg_tri_base: Optional[torch.Tensor] = None
    # BF8 tree depth D8 (as BF8BVH.depth): a traversal stack never holds
    # more than 7*D8 + 1 entries
    depth: int = 0

    @property
    def device(self) -> torch.device:
        return self.pages.device

    @property
    def stack_bound(self) -> int:
        return 7 * self.depth + 1

    def closest(self, origins, dirs, tmax, tmin):
        from pt_torch.accel.kernels import closest_bf8i
        hit = closest_bf8i(self, origins, dirs, tmax, tmin)
        if self.seg_tri_base is not None:
            hit = hit._replace(tri=remap_global_tri(hit.tri,
                                                    self.seg_tri_base))
        return hit

    def occluded(self, origins, dirs, dist, tmin):
        from pt_torch.accel.kernels import occluded_bf8i
        return occluded_bf8i(self, origins, dirs, dist, tmin)

    def root_bounds(self):
        return self.root_lo, self.root_hi


def decode_instanced_tri(tri: torch.Tensor):
    """Split a closest-hit id from the instanced kernel into (mesh-local
    triangle id, segment id); misses stay (-1, 0)."""
    seg = torch.where(tri >= 0, (tri & SEG_MASK) >> SEG_SHIFT, 0)
    mesh_tri = torch.where(tri >= 0, tri & TRI_MASK, tri)
    return mesh_tri, seg


def remap_global_tri(tri: torch.Tensor, seg_tri_base: torch.Tensor):
    """(segment, mesh-local) winning ids → flattened global triangle ids
    (seg_tri_base[seg] + local), preserving the miss sentinel (-1) and
    ALPHA_TRI_BIT (bit 30)."""
    alpha = tri & ALPHA_TRI_BIT
    mesh_tri, seg = decode_instanced_tri(tri)
    glob = seg_tri_base.to(torch.int32)[seg.long()] + mesh_tri
    return torch.where(tri >= 0, glob | alpha, tri)


def _mesh_leaves(positions: np.ndarray, tri_idx: np.ndarray, block: int,
                 max_leaves: int, tri_opaque: Optional[np.ndarray],
                 id_base: int):
    """Partition one mesh's object-space triangles into leaf blocks of at
    most `block` with the native SAH build; returns (pages, leaf_lo,
    leaf_hi) with mesh-local triangle ids offset by `id_base`, or None."""
    from pt_torch.accel.native import OVERFLOW, build_sah

    positions = np.asarray(positions, np.float32)
    tri_idx = np.asarray(tri_idx, np.int64)
    v0 = positions[tri_idx[:, 0]]
    v1 = positions[tri_idx[:, 1]]
    v2 = positions[tri_idx[:, 2]]
    tri_lo = np.minimum(np.minimum(v0, v1), v2)
    tri_hi = np.maximum(np.maximum(v0, v1), v2)
    centroids = (v0 + v1 + v2) / 3.0
    result = build_sah(tri_lo, tri_hi, centroids, block,
                       max_nodes=2 * max_leaves - 1)
    if result is OVERFLOW:
        return None
    order, node_lo, node_hi, miss, leaf_start, leaf_count = result
    if leaf_count.max(initial=0) > block:
        return None
    leaf_nodes = np.nonzero(leaf_start >= 0)[0]
    n_leaves = len(leaf_nodes)

    t_pad = n_leaves * block
    sv0 = np.zeros((t_pad, 3), np.float32)
    se1 = np.zeros((t_pad, 3), np.float32)
    se2 = np.zeros((t_pad, 3), np.float32)
    ids = np.full(t_pad, -1, np.int32)
    page_alpha = np.zeros(t_pad, bool)
    counts = leaf_count[leaf_nodes].astype(np.int64)
    starts = leaf_start[leaf_nodes].astype(np.int64)
    total = int(counts.sum())
    if total:
        leaf_of_ref = np.repeat(np.arange(n_leaves, dtype=np.int64), counts)
        within = (np.arange(total, dtype=np.int64)
                  - np.repeat(np.cumsum(counts) - counts, counts))
        slot = leaf_of_ref * block + within
        tris = order[np.repeat(starts, counts) + within]
        sv0[slot] = v0[tris]
        se1[slot] = v1[tris] - v0[tris]
        se2[slot] = v2[tris] - v0[tris]
        ids[slot] = tris + id_base
        if tri_opaque is not None:
            page_alpha[slot] = ~np.asarray(tri_opaque, bool)[tris]
    pages = _woop_pages(sv0, se1, se2, ids, n_leaves, block,
                        tri_alpha=page_alpha if tri_opaque is not None
                        else None)
    return pages, node_lo[leaf_nodes], node_hi[leaf_nodes]


def _transform_boxes(lo: np.ndarray, hi: np.ndarray, m: np.ndarray):
    """World AABBs of object AABBs under a 4x4 transform (8 corners)."""
    corners = np.stack([np.where(np.array([(i >> a) & 1 for a in range(3)],
                                          bool), hi, lo)
                        for i in range(8)], axis=1)        # (L, 8, 3)
    w = corners @ m[:3, :3].T + m[:3, 3]
    return w.min(axis=1).astype(np.float32), w.max(axis=1).astype(np.float32)


def build_instanced_bf8(meshes: Sequence[Tuple[np.ndarray, np.ndarray,
                                               Optional[np.ndarray]]],
                        seg_mesh: Sequence[int],
                        seg_transform: np.ndarray,
                        block: int = 32,
                        seg_tri_base=None,
                        device=None) -> Optional[BF8Instanced]:
    """Build the shared-page instanced structure.

    meshes: per unique mesh (positions (Vm,3), tri_idx (Tm,3), tri_opaque
    (Tm,) bool or None) in object space. seg_mesh: mesh index per segment.
    seg_transform: (S, 4, 4) world transforms. seg_tri_base ((S,) global
    triangle offsets, optional): when given, closest() remaps hit ids to the
    flattened global numbering (the integrator's mode). Returns None when a
    transform is singular or the capacity contract cannot be met (callers
    fall back to flatten)."""
    from pt_torch.accel.native import OVERFLOW, build_sah

    dev = default_device(device)
    seg_mesh = np.asarray(seg_mesh, np.int64)
    if len(seg_mesh) and not (0 <= seg_mesh.min()
                              and seg_mesh.max() < len(meshes)):
        raise ValueError("seg_mesh references a mesh index out of range")
    seg_transform = np.asarray(seg_transform, np.float64)
    n_segs = len(seg_mesh)
    if n_segs > MAX_SEGS:
        return None
    if any(np.asarray(m[1]).shape[0] > TRI_MASK for m in meshes):
        return None
    dets = np.linalg.det(seg_transform[:, :3, :3])
    if (np.abs(dets) < 1e-30).any():
        return None                      # singular instance transform

    # Grow the common block until the whole structure fits every budget.
    # ceil(T/block) is only a lower bound on a mesh's leaf count (SAH leaves
    # are rarely full), and the BF8 collapse has its own gate that only
    # shows once the top tree exists, so feasibility is decided by
    # attempting the full build per block and retrying coarser.
    uses = np.bincount(seg_mesh, minlength=len(meshes))
    inv = np.linalg.inv(seg_transform)                     # (S, 4, 4)
    seg_inv = np.concatenate([inv[:, :3, :3].reshape(n_segs, 9),
                              inv[:, :3, 3]], axis=1).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def _attempt(block: int) -> Optional[BF8Instanced]:
        worst = sum(int(uses[mi]) * -(-np.asarray(m[1]).shape[0] // block)
                    for mi, m in enumerate(meshes))
        if worst > MAX_INST_LEAVES:
            return None
        built = [_mesh_leaves(positions, tri_idx, block,
                              max_leaves=MAX_INST_LEAVES,
                              tri_opaque=tri_opaque, id_base=0)
                 for positions, tri_idx, tri_opaque in meshes]
        if not all(b is not None for b in built):
            return None
        if sum(int(uses[mi]) * len(b[1])
               for mi, b in enumerate(built)) > MAX_INST_LEAVES:
            return None

        mesh_pages, mesh_lo, mesh_hi, page_base = [], [], [], []
        base = 0
        for pages, llo, lhi in built:
            mesh_pages.append(pages)
            mesh_lo.append(llo)
            mesh_hi.append(lhi)
            page_base.append(base)
            base += pages.shape[0]
        page_table = np.concatenate(mesh_pages, axis=0)

        # (segment, mesh-leaf) pairs -> world boxes + (page, seg) tables
        prim_lo, prim_hi, prim_page, prim_seg = [], [], [], []
        for s in range(n_segs):
            mi = int(seg_mesh[s])
            wlo, whi = _transform_boxes(mesh_lo[mi], mesh_hi[mi],
                                        seg_transform[s])
            n = len(wlo)
            prim_lo.append(wlo)
            prim_hi.append(whi)
            prim_page.append(np.arange(page_base[mi], page_base[mi] + n,
                                       dtype=np.int32))
            prim_seg.append(np.full(n, s, np.int32))
        prim_lo = np.concatenate(prim_lo)
        prim_hi = np.concatenate(prim_hi)
        prim_page = np.concatenate(prim_page)
        prim_seg = np.concatenate(prim_seg)
        n_prim = len(prim_lo)
        if n_prim > MAX_INST_LEAVES:
            return None
        if n_prim < 2:
            return None                  # single-leaf scene: use flatten

        # top tree over the pair boxes, singleton leaves
        result = build_sah(prim_lo, prim_hi, (prim_lo + prim_hi) * 0.5,
                           max_leaf=1, max_nodes=2 * n_prim - 1 + 8)
        if result is OVERFLOW:
            return None
        order, node_lo, node_hi, miss, leaf_start, leaf_count = result
        n_top = len(miss)
        leaf_nodes = np.nonzero(leaf_start >= 0)[0]
        n_leaves = len(leaf_nodes)
        top_leaf = np.full(n_top, -1, np.int32)
        top_leaf[leaf_nodes] = np.arange(n_leaves, dtype=np.int32)

        # the collapse reads the tree back as numpy: keep it on the host and
        # move only the finished structure to the device
        cpu = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        pbvh = PacketBVH(top_lo=cpu(node_lo), top_hi=cpu(node_hi),
                         top_miss=cpu(miss), top_leaf=cpu(top_leaf),
                         pages=cpu(page_table), n_top=int(n_top),
                         block=block)
        b8 = build_bf8(pbvh)
        if b8 is None:
            return None

        # leaf id (build_bf8 numbering == top_leaf numbering) -> prim
        prim_of_leaf = order[leaf_start[leaf_nodes]]
        leaf_page = prim_page[prim_of_leaf]
        leaf_seg = prim_seg[prim_of_leaf]

        # pt's SMEM budget incl. the instancing tables sets the leaf retest
        n8 = b8.n8
        base_kb = (7 * n8 * 8 + 2 * n_leaves + 12 * n_segs) * 4 / 1024
        leaf_kb = 6 * n_leaves * 4 / 1024
        if base_kb > 600:
            return None
        leaf_retest = base_kb + leaf_kb <= 640

        return BF8Instanced(
            c_lo=b8.c_lo.to(dev), c_hi=b8.c_hi.to(dev),
            c_ent=b8.c_ent.to(dev), l_lo=b8.l_lo.to(dev),
            l_hi=b8.l_hi.to(dev), leaf_page=t(leaf_page),
            leaf_seg=t(leaf_seg), seg_inv=t(seg_inv.reshape(-1)),
            pages=b8.pages.to(dev),
            n8=n8, n_leaves=n_leaves, n_segs=n_segs, block=block,
            leaf_retest=leaf_retest,
            root_lo=b8.root_lo.to(dev), root_hi=b8.root_hi.to(dev),
            seg_tri_base=(None if seg_tri_base is None
                          else t(np.asarray(seg_tri_base, np.int32))),
            depth=b8.depth)

    block = max(32, -(-block // 32) * 32)
    while block <= MAX_INST_BLOCK:
        out = _attempt(block)
        if out is not None:
            return out
        block *= 2
    return None


def build_instanced_split(meshes: Sequence[Tuple[np.ndarray, np.ndarray,
                                                 Optional[np.ndarray]]],
                          seg_mesh: Sequence[int],
                          seg_transform: np.ndarray,
                          seg_tri_base: np.ndarray,
                          block: int = 32,
                          device=None):
    """Instanced acceleration for alpha-tested scenes.

    The integrator's any-hit emulation wants the AlphaSplit scheme: a
    closest/occlusion tree over the opaque subset plus closest trees over
    the (small) alpha subset. Opacity is per geometry, so the split falls on
    whole meshes and each subset is itself a shared-BLAS instancing problem
    over its own (segment, mesh-leaf) pairs.

    Returns `(full, (tree_o, sel_o), (tree_a, sel_a))`, or None when the
    full structure is infeasible (callers fall back to flatten):

    * `full`: BF8Instanced over every segment (global-id remap via
      `seg_tri_base`); it stays `accel.bvh` for the root-bounds clamps.
    * `tree_o` / `tree_a`: BF8Instanced over only that subset's segments,
      returning subset-rank ids (its seg_tri_base counts within the subset),
      the contract of `_remap_subset_tri(sel, ...)`; None when that subset's
      instanced build is infeasible (a single-leaf subset, say): the
      renderer then builds a flat subset tree instead (hybrid).
    * `sel_o` / `sel_a`: (K,) int32 global flattened triangle ids of the
      subset in subset-rank order.

    Needs homogeneous per-mesh opacity (always true for
    `shared_mesh_layout` inputs); returns None otherwise."""
    seg_mesh = np.asarray(seg_mesh, np.int64)
    seg_transform = np.asarray(seg_transform, np.float64)
    seg_tri_base = np.asarray(seg_tri_base, np.int64)
    n_segs = len(seg_mesh)
    mesh_opaque = []
    for _, tris, opq in meshes:
        if opq is None:
            mesh_opaque.append(True)
            continue
        opq = np.asarray(opq, bool)
        if opq.any() and (~opq).any():
            return None                    # mixed-opacity mesh: flatten
        mesh_opaque.append(bool(opq.all()))
    counts = np.asarray([np.asarray(m[1]).shape[0] for m in meshes],
                        np.int64)

    full = build_instanced_bf8(meshes, seg_mesh, seg_transform, block,
                               seg_tri_base=seg_tri_base, device=device)
    if full is None:
        return None

    def subset(keep_opaque: bool):
        idx = [s for s in range(n_segs)
               if mesh_opaque[int(seg_mesh[s])] == keep_opaque]
        if not idx:
            return None, np.zeros((0,), np.int32)
        sub_gis: List[int] = []
        remap: dict = {}
        for s in idx:
            mi = int(seg_mesh[s])
            if mi not in remap:
                remap[mi] = len(sub_gis)
                sub_gis.append(mi)
        sub_counts = counts[seg_mesh[idx]]
        sub_base = np.concatenate([[0], np.cumsum(sub_counts)[:-1]]) \
            .astype(np.int32)
        sel = np.concatenate(
            [seg_tri_base[s] + np.arange(counts[seg_mesh[s]])
             for s in idx]).astype(np.int32)
        tree = build_instanced_bf8(
            [meshes[mi] for mi in sub_gis],
            np.asarray([remap[int(seg_mesh[s])] for s in idx], np.int64),
            seg_transform[idx], block, seg_tri_base=sub_base, device=device)
        return tree, sel

    return full, subset(True), subset(False)
