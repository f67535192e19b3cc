"""Builds of the acceleration structures.

Port of the build half of `pt.accel.pallas_bvh`. For static scenes, on the
host: the native SAH/SBVH build into a binary `PacketBVH` with Woop leaf
pages (`build_packet_bvh_sah`, `_woop_pages`) and its collapse into the
branching-factor-8 `BF8BVH` (`build_bf8`). For animated scenes, on the
scene's device and once per frame: the Morton-ordered `PacketBVH`
(`build_packet_bvh`, `_woop_pages_device`, `_finish_build`), which reads no
device value back to the host.

The caps stay exactly `pt`'s, so that both packages build array-equal
structures from the same input: `MAX_TOP_LEAVES`, the block doubling and
`build_bf8`'s budget (returning None when the collapse is over it). They
are TPU limits (SMEM); lifting them on Hopper is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pt_torch import default_device

TRIS_PER_BLOCK = 64
MAX_TOP_LEAVES = 8192

# page column layout: six (8, B) operand groups then one id group
#   [o'x | o'y | o'z | d'x | d'y | d'z | ids]  -> width 7B
_PAGE_GROUPS = 7

LEAF_BIT = 1 << 24           # BF8 child-entry tag (leaf id in low bits)
ALPHA_TRI_BIT = 1 << 30      # page-id tag: triangle is not opaque


def _page_cols(block: int) -> int:
    """Page width: 7*block rounded up to a 128 multiple (pt's layout)."""
    cols = _PAGE_GROUPS * block
    return cols + (-cols) % 128


@dataclasses.dataclass
class PacketBVH:
    """Binary top tree in threaded preorder over Woop leaf pages."""
    top_lo: torch.Tensor        # (n_top, 3) f32
    top_hi: torch.Tensor        # (n_top, 3) f32
    top_miss: torch.Tensor      # (n_top,) i32 preorder skip links
    top_leaf: torch.Tensor      # (n_top,) i32 leaf-block id or -1
    pages: torch.Tensor         # (n_leaves, 8, _page_cols(block)) f32
    n_top: int = 0
    block: int = TRIS_PER_BLOCK

    @property
    def device(self) -> torch.device:
        return self.pages.device

    @property
    def root_lo(self) -> torch.Tensor:
        """Scene root AABB: the bounds of the preorder root."""
        return self.top_lo[0]

    @property
    def root_hi(self) -> torch.Tensor:
        return self.top_hi[0]

    @property
    def depth(self) -> int:
        """Levels on the deepest root-to-leaf path (the root is level 1),
        worked out on the host once and kept on the structure: for a tree on
        the card, one device→host copy of the links. An ordered stack walk
        pops one node and pushes at most two, so its stack never holds more
        than `depth` entries."""
        depth = self.__dict__.get("_depth")
        if depth is None:
            depth = binary_depth(self.top_miss.cpu().numpy(),
                                 self.top_leaf.cpu().numpy())
            self._depth = depth
        return depth


def binary_depth(top_miss: np.ndarray, top_leaf: np.ndarray) -> int:
    """Levels of a preorder binary tree (the root is level 1): the children
    of an internal node i are i + 1 and top_miss[i + 1], both after i."""
    level = np.ones(len(top_leaf), np.int64)
    for i in np.flatnonzero(np.asarray(top_leaf) < 0):
        level[i + 1] = level[top_miss[i + 1]] = level[i] + 1
    return int(level.max())


@dataclasses.dataclass
class BF8BVH:
    """Branching-factor-8 top tree: the binary tree collapsed 3 levels at a
    time, so one visit slab-tests up to 8 (grand)children. Child entries
    encode leaves as (LEAF_BIT | leaf_id), empty slots as -1."""
    c_lo: torch.Tensor          # (n8*8, 3) f32 child bounds (1e30 pt = empty)
    c_hi: torch.Tensor          # (n8*8, 3) f32
    c_ent: torch.Tensor         # (n8*8,) i32 child entry (-1 empty)
    l_lo: torch.Tensor          # (n_leaves, 3) f32 leaf-block bounds
    l_hi: torch.Tensor          # (n_leaves, 3) f32
    pages: torch.Tensor         # as PacketBVH.pages
    n8: int = 0
    n_leaves: int = 0
    block: int = TRIS_PER_BLOCK
    # pt's flag for whether the leaf-bounds tables fit the TPU's SMEM;
    # kept for parity of the structure, the CUDA kernels always retest
    leaf_retest: bool = True
    root_lo: Optional[torch.Tensor] = None     # (3,) f32 scene root AABB
    root_hi: Optional[torch.Tensor] = None
    # BF8 tree depth D8: internal-node levels on the deepest path (the root
    # is level 1). A visit pops 1 entry and pushes at most 8, so a
    # traversal stack never holds more than 7*D8 + 1 entries.
    depth: int = 0

    @property
    def device(self) -> torch.device:
        return self.pages.device

    @property
    def stack_bound(self) -> int:
        return 7 * self.depth + 1


def build_bf8(pbvh: PacketBVH) -> Optional[BF8BVH]:
    """Collapse a PacketBVH binary top tree into a BF8BVH. Returns None if
    the result would blow pt's SMEM budget (or the root is a leaf).

    Binary children in the preorder/miss representation: left = i+1,
    right = miss[i+1] (both exist for every internal node)."""
    lo = pbvh.top_lo.cpu().numpy()
    hi = pbvh.top_hi.cpu().numpy()
    miss = pbvh.top_miss.cpu().numpy()
    leaf = pbvh.top_leaf.cpu().numpy()
    n = pbvh.n_top
    n_leaves = int((leaf >= 0).sum())

    # leaf-block bounds table (indexed by leaf id)
    l_lo = np.full((n_leaves, 3), 1e30, np.float32)
    l_hi = np.full((n_leaves, 3), 1e30, np.float32)
    is_leaf = leaf[:n] >= 0
    l_lo[leaf[:n][is_leaf]] = lo[:n][is_leaf]
    l_hi[leaf[:n][is_leaf]] = hi[:n][is_leaf]

    def expand(i, depth):
        """Children of binary node i, collapsed to depth 3."""
        if leaf[i] >= 0 or depth == 3:
            return [i]
        left = i + 1
        right = miss[left]
        return expand(left, depth + 1) + expand(right, depth + 1)

    if leaf[0] >= 0:
        return None                          # single-leaf scene
    bf8_of_binary = {0: 0}
    order = [0]
    children: list[list[tuple]] = []
    for bi in order:
        kids = expand(bi, 0)
        row = []
        for k in kids:
            if leaf[k] >= 0:
                row.append(("leaf", int(leaf[k]), k))
            else:
                if k not in bf8_of_binary:
                    bf8_of_binary[k] = len(order)
                    order.append(k)
                row.append(("node", bf8_of_binary[k], k))
        children.append(row)

    n8 = len(order)
    # pt's SMEM budget (KiB) of the TPU kernels, kept for parity
    base_kb = 7 * n8 * 8 * 4 / 1024
    leaf_kb = 6 * n_leaves * 4 / 1024
    if base_kb > 600:
        return None
    leaf_retest = base_kb + leaf_kb <= 640

    # empty slots: a degenerate far-away box (lo == hi == 1e30), not an
    # inverted inf box, which the slab arithmetic would read as a hit
    c_lo = np.full((n8 * 8, 3), 1e30, np.float32)
    c_hi = np.full((n8 * 8, 3), 1e30, np.float32)
    c_ent = np.full((n8 * 8,), -1, np.int32)
    for i8, row in enumerate(children):
        for c, (kind, idx, bi) in enumerate(row):
            c_lo[i8 * 8 + c] = lo[bi]
            c_hi[i8 * 8 + c] = hi[bi]
            c_ent[i8 * 8 + c] = (LEAF_BIT | idx) if kind == "leaf" else idx
    dev = pbvh.pages.device
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return BF8BVH(c_lo=t(c_lo), c_hi=t(c_hi), c_ent=t(c_ent),
                  l_lo=t(l_lo), l_hi=t(l_hi), pages=pbvh.pages, n8=n8,
                  n_leaves=n_leaves, block=pbvh.block,
                  leaf_retest=leaf_retest,
                  root_lo=t(np.ascontiguousarray(lo[0])),
                  root_hi=t(np.ascontiguousarray(hi[0])),
                  depth=bf8_depth(c_ent))


def bf8_depth(c_ent: np.ndarray) -> int:
    """Internal-node levels on the deepest root-to-leaf path of a BF8 tree
    given its (n8*8,) child entries (the root, node 0, is level 1)."""
    ents = np.asarray(c_ent).reshape(-1, 8)
    depth, level = 0, [0]
    while level:
        depth += 1
        kids = ents[level].reshape(-1)
        level = kids[(kids >= 0) & (kids < LEAF_BIT)].tolist()
    return depth


def _woop_pages(v0, e1, e2, tri_ids, n_leaves, block, tri_alpha=None):
    """Pack per-leaf Woop pages from (T_pad, 3) triangle data in leaf
    order (pt's host f64 path). tri_ids: (T_pad,) int32 with -1 padding;
    `tri_alpha` (T_pad,) bool marks non-opaque triangles (ALPHA_TRI_BIT is
    OR-ed into their ids). Returns (n_leaves, 8, _page_cols(block)) f32.

    Per triangle: W = inv([e1 e2 n]) (rows Wx, Wy, Wz), b = -W v0. A ray
    (o, d) maps to o' = W o + b, d' = W d; hit iff t = -o'z/d'z in
    (tmin, tmax), u = o'x + t d'x >= 0, v = o'y + t d'y >= 0, u + v <= 1.
    Degenerate (padding) triangles get W = 0 and b = (0, 0, 1e30), so
    t = -o'z/d'z is infinite and the test rejects it.
    """
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    v0 = np.asarray(v0, np.float64)
    n = np.cross(e1, e2)
    # closed-form inverse of M = [e1 e2 n] (columns): det = |n|²; rows of
    # M⁻¹ are (e2×n)/det, (n×e1)/det, n/det
    det = np.sum(n * n, axis=-1)
    ok = np.abs(det) > 1e-30
    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)[:, None]
    w = np.stack([np.cross(e2, n) * inv_det,
                  np.cross(n, e1) * inv_det,
                  n * inv_det], axis=1)                  # (T, 3, 3) rows
    b = -np.einsum("tij,tj->ti", w, v0)
    b = np.where(ok[:, None], b, np.asarray([0.0, 0.0, 1e30])[None])
    w = np.where(ok[:, None, None], w, 0.0)
    w = w.astype(np.float32)
    b = b.astype(np.float32)

    ids32 = tri_ids.astype(np.int32)
    if tri_alpha is not None:
        mark = (ids32 >= 0) & np.asarray(tri_alpha, bool)
        ids32 = np.where(mark, ids32 | ALPHA_TRI_BIT, ids32)

    id_bits = np.ascontiguousarray(ids32).view(np.float32)
    pages = np.zeros((n_leaves, 8, _page_cols(block)), np.float32)
    wl = w.reshape(n_leaves, block, 3, 3)
    bl = b.reshape(n_leaves, block, 3)
    for k in range(3):       # o'_k operand: rows [Wk(3), bk, 0...]
        col = slice(k * block, (k + 1) * block)
        for j in range(3):
            pages[:, j, col] = wl[:, :, k, j]
        pages[:, 3, col] = bl[:, :, k]
    for k in range(3):       # d'_k operand: rows [0,0,0,0, Wk(3), 0]
        col = slice((3 + k) * block, (4 + k) * block)
        for j in range(3):
            pages[:, 4 + j, col] = wl[:, :, k, j]
    pages[:, 0, 6 * block:7 * block] = id_bits.reshape(n_leaves, block)
    return pages


def _woop_pages_device(v0, e1, e2, tri_ids, n_leaves: int, block: int,
                       tri_alpha=None) -> torch.Tensor:
    """`_woop_pages` as f32 tensor code on the triangles' device (pt's
    traced `xp=jnp` arm): the same W, b and degenerate-row rules, packed
    into (n_leaves, 8, _page_cols(block)) f32 pages. v0/e1/e2 (T_pad, 3)
    f32 in leaf order, tri_ids (T_pad,) int32 with -1 padding, tri_alpha
    (T_pad,) bool or None."""
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)  # noqa: E731
    n = cross(e1, e2)
    det = torch.sum(n * n, dim=-1)
    ok = torch.abs(det) > 1e-30
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)[:, None]
    w = torch.stack([cross(e2, n) * inv_det, cross(n, e1) * inv_det,
                     n * inv_det], dim=1)                  # (T, 3, 3) rows
    b = -torch.sum(w * v0[:, None, :], dim=-1)
    far = torch.zeros_like(b)
    far[:, 2] = 1e30
    b = torch.where(ok[:, None], b, far)
    w = torch.where(ok[:, None, None], w, 0.0)

    ids32 = tri_ids.to(torch.int32)
    if tri_alpha is not None:
        mark = (ids32 >= 0) & tri_alpha
        ids32 = torch.where(mark, ids32 | ALPHA_TRI_BIT, ids32)

    pages = torch.zeros((n_leaves, 8, _page_cols(block)),
                        dtype=torch.float32, device=v0.device)
    wl = w.reshape(n_leaves, block, 3, 3)
    bl = b.reshape(n_leaves, block, 3)
    for k in range(3):       # o'_k operand: rows [Wk(3), bk, 0...]
        col = slice(k * block, (k + 1) * block)
        pages[:, 0:3, col] = wl[:, :, k, :].transpose(1, 2)
        pages[:, 3, col] = bl[:, :, k]
    for k in range(3):       # d'_k operand: rows [0,0,0,0, Wk(3), 0]
        col = slice((3 + k) * block, (4 + k) * block)
        pages[:, 4:7, col] = wl[:, :, k, :].transpose(1, 2)
    pages[:, 0, 6 * block:7 * block] = \
        ids32.view(torch.float32).reshape(n_leaves, block)
    return pages


def _finish_build(blo, bhi, n_leaves: int, pages, block: int) -> PacketBVH:
    """Leaf bounds (n_leaves, 3) → the preorder top tree: pairwise unions
    level by level, then the gather into preorder. Subtrees that hold only
    padding carry inverted ±inf boxes out of the unions; a slab test reads
    an inverted box as a hit, so they become the far point box
    lo = hi = 1e30, which every ray misses."""
    from pt_torch.accel.lbvh import topology_tensors
    levels_lo, levels_hi = [blo], [bhi]
    while levels_lo[-1].shape[0] > 1:
        levels_lo.append(levels_lo[-1].reshape(-1, 2, 3).amin(dim=1))
        levels_hi.append(levels_hi[-1].reshape(-1, 2, 3).amax(dim=1))
    heap_lo = torch.cat(levels_lo[::-1], dim=0)
    heap_hi = torch.cat(levels_hi[::-1], dim=0)
    empty = heap_lo[:, :1] > heap_hi[:, :1]
    heap_lo = torch.where(empty, 1e30, heap_lo)
    heap_hi = torch.where(empty, 1e30, heap_hi)
    heap_of_preorder, miss_next, leaf_id = topology_tensors(n_leaves,
                                                            pages.device)
    return PacketBVH(top_lo=heap_lo[heap_of_preorder],
                     top_hi=heap_hi[heap_of_preorder], top_miss=miss_next,
                     top_leaf=leaf_id, pages=pages, n_top=2 * n_leaves - 1,
                     block=block)


def morton_leaf_shape(t_count: int, block: int = TRIS_PER_BLOCK):
    """(n_leaves, block) of the Morton build over `t_count` triangles: the
    leaf count is the next power of two of ceil(T / block), and the block
    doubles until it is within MAX_TOP_LEAVES. Static: it follows from the
    triangle count alone."""
    block = max(32, -(-block // 32) * 32)   # page-group granularity

    def leaves(blk):
        return 1 << max(0, (max(1, -(-t_count // blk)) - 1).bit_length())
    while leaves(block) > MAX_TOP_LEAVES:
        block *= 2
    return leaves(block), block


def build_packet_bvh(positions: torch.Tensor, tri_idx: torch.Tensor,
                     block: int = TRIS_PER_BLOCK,
                     tri_opaque=None) -> PacketBVH:
    """Morton-block build on the positions' device, the per-frame rebuild of
    animated scenes: triangles sorted by the Morton code of their centroid
    (stable, as `pt`'s argsort), cut into leaf blocks, Woop pages packed and
    the implicit tree's bounds reduced. positions (V, 3) f32, tri_idx (T, 3)
    integer, tri_opaque (T,) bool or None. Nothing here reads a device value
    back: the leaf count and block size follow from T."""
    from pt_torch.accel.lbvh import morton_codes
    t_count = tri_idx.shape[0]
    n_leaves, block = morton_leaf_shape(t_count, block)
    idx = tri_idx.long()
    v0 = positions[idx[:, 0]]
    v1 = positions[idx[:, 1]]
    v2 = positions[idx[:, 2]]
    centroids = (v0 + v1 + v2) / 3.0
    scene_lo = torch.minimum(torch.minimum(v0, v1), v2).amin(dim=0)
    scene_hi = torch.maximum(torch.maximum(v0, v1), v2).amax(dim=0)
    order = torch.sort(morton_codes(centroids, scene_lo, scene_hi),
                       stable=True).indices

    t_pad = n_leaves * block
    dev = positions.device
    order_p = torch.cat([order.to(torch.int32),
                         torch.full((t_pad - t_count,), -1,
                                    dtype=torch.int32, device=dev)])
    safe = torch.clamp(order_p, min=0).long()
    valid = (order_p >= 0)[:, None]
    sv0 = torch.where(valid, v0[safe], 0.0)
    se1 = torch.where(valid, (v1 - v0)[safe], 0.0)
    se2 = torch.where(valid, (v2 - v0)[safe], 0.0)

    bv0 = sv0.reshape(n_leaves, block, 3)
    bv1 = (sv0 + se1).reshape(n_leaves, block, 3)
    bv2 = (sv0 + se2).reshape(n_leaves, block, 3)
    bvalid = valid.reshape(n_leaves, block, 1)
    inf = float("inf")
    blo = torch.where(bvalid, torch.minimum(torch.minimum(bv0, bv1), bv2),
                      inf).amin(dim=1)
    bhi = torch.where(bvalid, torch.maximum(torch.maximum(bv0, bv1), bv2),
                      -inf).amax(dim=1)

    tri_alpha = None
    if tri_opaque is not None:
        tri_alpha = valid[:, 0] & ~tri_opaque.bool()[safe]
    pages = _woop_pages_device(sv0, se1, se2, order_p, n_leaves, block,
                               tri_alpha=tri_alpha)
    return _finish_build(blo, bhi, n_leaves, pages, block)


def build_packet_bvh_sah(positions_np, tri_idx_np,
                         block: int = TRIS_PER_BLOCK,
                         max_leaves: int = None,
                         tri_opaque_np=None,
                         spatial: bool = False,
                         ref_budget: float = 1.75,
                         alpha: float = 1e-5,
                         presplit_mult: float = 0.0,
                         spatial_min_count: int = 0,
                         device=None) -> Optional[PacketBVH]:
    """Host build with the native binned-SAH builder (csrc/sah_bvh.cpp);
    `spatial=True` uses its SBVH variant (spatial splits: triangles may be
    referenced by several leaves). The block size doubles until the tree
    fits pt's node budget; None when no block up to 1024 fits."""
    from pt_torch.accel.native import OVERFLOW, build_sah, build_sbvh

    dev = default_device(device)
    max_nodes = 2 * (max_leaves or MAX_TOP_LEAVES) - 1
    block = max(32, -(-block // 32) * 32)   # page-group granularity
    positions_np = np.asarray(positions_np, np.float32)
    tri_idx_np = np.asarray(tri_idx_np, np.int64)
    v0 = positions_np[tri_idx_np[:, 0]]
    v1 = positions_np[tri_idx_np[:, 1]]
    v2 = positions_np[tri_idx_np[:, 2]]
    tri_lo = np.minimum(np.minimum(v0, v1), v2)
    tri_hi = np.maximum(np.maximum(v0, v1), v2)
    centroids = (v0 + v1 + v2) / 3.0

    # any block < T/max_leaves cannot fit the node budget: start the
    # doubling loop at the first feasible size
    max_leaf_budget = max_leaves or MAX_TOP_LEAVES
    min_feasible = -(-len(tri_idx_np) // max_leaf_budget)
    while block < min_feasible:
        block *= 2

    result = None
    while block <= 1024:
        if spatial:
            result = build_sbvh(v0, v1, v2, block, ref_budget,
                                alpha=alpha, max_nodes=max_nodes,
                                presplit_mult=presplit_mult,
                                spatial_min_count=spatial_min_count)
        else:
            result = build_sah(tri_lo, tri_hi, centroids, block,
                               max_nodes=max_nodes)
        if result is not OVERFLOW and len(result[3]) <= max_nodes:
            break
        block *= 2
        result = None
    if result is None:
        return None
    order, node_lo, node_hi, miss, leaf_start, leaf_count = result
    if leaf_count.max(initial=0) > block:
        return None

    n_top = len(miss)
    is_leaf = leaf_start >= 0
    leaf_nodes = np.nonzero(is_leaf)[0]
    n_leaves = len(leaf_nodes)
    top_leaf = np.full(n_top, -1, np.int32)
    top_leaf[leaf_nodes] = np.arange(n_leaves, dtype=np.int32)

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
        ids[slot] = tris
        if tri_opaque_np is not None:
            page_alpha[slot] = ~np.asarray(tri_opaque_np, bool)[tris]

    pages = _woop_pages(sv0, se1, se2, ids, n_leaves, block,
                        tri_alpha=page_alpha if tri_opaque_np is not None
                        else None)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return PacketBVH(top_lo=t(node_lo), top_hi=t(node_hi), top_miss=t(miss),
                     top_leaf=t(top_leaf), pages=t(pages), n_top=int(n_top),
                     block=block)
