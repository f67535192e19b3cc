"""LBVH build: a Morton-ordered implicit binary tree with threaded links.

Port of `pt.accel.lbvh`: `_topology` (host numpy, worked out once per leaf
count), `_expand_bits_10` and `morton_codes`, which the Morton `PacketBVH`
build shares, and the threaded LBVH of `backend="bvh"`: `ThreadedBVH`,
`build_bvh` and `refit_bvh`, tensor code on the positions' device, walked
by `pt_torch.accel.traverse`.

The tree is a complete binary tree over Morton-sorted leaves of
`leaf_size` triangles, stored in preorder with a `miss` skip link per node:
the left child of an internal node `p` is `p + 1`, and `miss[p]` is the next
node once `p`'s subtree is skipped or done. The topology depends on the leaf
count alone, so the device part of a build is one stable sort and a few
min/max reductions, and a refit only the reductions. Every array equals
`pt`'s bit for bit: the Morton codes are `pt`'s uint32 values (carried in
int64), the sort is stable as `jnp.argsort` is, and the boxes are min/max
of the same floats.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _topology(n_leaves: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Preorder arrays of a complete binary tree with `n_leaves` leaves (a
    power of two). Returns (heap_of_preorder, miss_next, leaf_id), int32:

    - heap_of_preorder[p]: heap index of the node at preorder position p;
    - miss_next[p]: preorder position to go to when the node is missed
      (p + subtree size); equal to the node count when the walk is over;
    - leaf_id[p]: Morton-order leaf index, or -1 for an internal node.

    The arrays are shared by every caller and must not be written to.
    """
    n_nodes = 2 * n_leaves - 1
    heap_of_preorder = np.zeros(n_nodes, np.int32)
    miss_next = np.zeros(n_nodes, np.int32)
    leaf_id = np.full(n_nodes, -1, np.int32)
    p = 0
    stack = [(0, n_leaves)]
    while stack:
        heap, leaves = stack.pop()
        heap_of_preorder[p] = heap
        miss_next[p] = p + (2 * leaves - 1)
        if leaves == 1:
            leaf_id[p] = heap - (n_leaves - 1)
        else:
            # right first, so that the left child is visited next
            stack.append((2 * heap + 2, leaves // 2))
            stack.append((2 * heap + 1, leaves // 2))
        p += 1
    for a in (heap_of_preorder, miss_next, leaf_id):
        a.setflags(write=False)
    return heap_of_preorder, miss_next, leaf_id


@functools.lru_cache(maxsize=16)
def topology_tensors(n_leaves: int, device: torch.device):
    """`_topology(n_leaves)` on `device` (heap_of_preorder as int64 for
    indexing), uploaded once per leaf count and device. The tensors are
    shared between frames and never written to."""
    heap, miss, leaf = _topology(n_leaves)
    return (torch.as_tensor(heap.astype(np.int64), device=device),
            torch.as_tensor(miss.copy(), device=device),
            torch.as_tensor(leaf.copy(), device=device))


def _expand_bits_10(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so that two zero bits lie between each
    (the usual Morton magic numbers). int64 in and out: every intermediate
    stays below 2^32, so the values are those of `pt`'s uint32 code."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(centroids: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) of points quantised to a 1024³ grid over
    [lo, hi]."""
    extent = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((centroids - lo) / extent * 1024.0, 0.0, 1023.0)
    q = q.to(torch.int64)
    return (_expand_bits_10(q[:, 0]) << 2 | _expand_bits_10(q[:, 1]) << 1
            | _expand_bits_10(q[:, 2]))


@dataclasses.dataclass
class ThreadedBVH:
    """The threaded LBVH in preorder (`pt.accel.lbvh.ThreadedBVH`)."""
    aabb_lo: torch.Tensor        # (n_nodes, 3) f32, preorder
    aabb_hi: torch.Tensor        # (n_nodes, 3) f32
    miss_next: torch.Tensor      # (n_nodes,) i32 preorder skip links
    leaf_id: torch.Tensor        # (n_nodes,) i32 leaf index or -1
    leaf_tris: torch.Tensor      # (n_leaves, K) i32 triangle ids, -1 padding
    leaf_count: int = 0
    leaf_size: int = 4

    @property
    def n_nodes(self) -> int:
        return self.aabb_lo.shape[0]


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _preorder_boxes(positions, tri_idx, leaf_tris, n_leaves: int):
    """Node boxes in preorder: each leaf's box over its triangles (padding
    slots give +inf/-inf, so an empty slot never widens a box and an empty
    leaf is never hit), then the pyramid of pairwise min/max reductions in
    heap order [root | level 1 | ... | leaves], gathered into preorder."""
    safe = torch.clamp(leaf_tris, min=0).long()
    idx = tri_idx.long()
    a = positions[idx[safe, 0]]
    b = positions[idx[safe, 1]]
    c = positions[idx[safe, 2]]
    valid = (leaf_tris >= 0)[..., None]
    lo = torch.where(valid, torch.minimum(torch.minimum(a, b), c),
                     float("inf")).amin(dim=-2)
    hi = torch.where(valid, torch.maximum(torch.maximum(a, b), c),
                     float("-inf")).amax(dim=-2)
    levels_lo, levels_hi = [lo], [hi]
    while levels_lo[-1].shape[0] > 1:
        levels_lo.append(levels_lo[-1].reshape(-1, 2, 3).amin(dim=1))
        levels_hi.append(levels_hi[-1].reshape(-1, 2, 3).amax(dim=1))
    heap_lo = torch.cat(levels_lo[::-1], dim=0)             # (2L-1, 3)
    heap_hi = torch.cat(levels_hi[::-1], dim=0)
    heap, _, _ = topology_tensors(n_leaves, positions.device)
    return heap_lo[heap], heap_hi[heap]


def build_bvh(positions: torch.Tensor, tri_idx: torch.Tensor,
              leaf_size: int = 4) -> ThreadedBVH:
    """Build the threaded LBVH over world-space triangles on the positions'
    device (`pt.accel.lbvh.build_bvh`): triangles sorted stably by the
    Morton code of their centroid and cut into leaves of `leaf_size`, the
    last padded with -1. positions (V, 3) f32, tri_idx (T, 3) integer.
    Nothing reads a device value back: the leaf count follows from T."""
    t_count = tri_idx.shape[0]
    idx = tri_idx.long()
    v0 = positions[idx[:, 0]]
    v1 = positions[idx[:, 1]]
    v2 = positions[idx[:, 2]]
    centroids = (v0 + v1 + v2) / 3.0
    scene_lo = torch.minimum(torch.minimum(v0, v1), v2).amin(dim=0)
    scene_hi = torch.maximum(torch.maximum(v0, v1), v2).amax(dim=0)
    order = torch.sort(morton_codes(centroids, scene_lo, scene_hi),
                       stable=True).indices.to(torch.int32)
    n_leaves = _next_pow2(max(1, -(-t_count // leaf_size)))
    pad = n_leaves * leaf_size - t_count
    leaf_tris = torch.cat([order, torch.full((pad,), -1, dtype=torch.int32,
                                             device=positions.device)])
    leaf_tris = leaf_tris.reshape(n_leaves, leaf_size)
    lo, hi = _preorder_boxes(positions, tri_idx, leaf_tris, n_leaves)
    _, miss, leaf = topology_tensors(n_leaves, positions.device)
    return ThreadedBVH(aabb_lo=lo, aabb_hi=hi, miss_next=miss, leaf_id=leaf,
                       leaf_tris=leaf_tris, leaf_count=n_leaves,
                       leaf_size=leaf_size)


def refit_bvh(bvh: ThreadedBVH, positions: torch.Tensor,
              tri_idx: torch.Tensor) -> ThreadedBVH:
    """Recompute the boxes for an unchanged topology and leaf order (the
    cheap per-frame update when motion is small; `pt.accel.lbvh.
    refit_bvh`)."""
    lo, hi = _preorder_boxes(positions, tri_idx, bvh.leaf_tris,
                             bvh.leaf_count)
    return dataclasses.replace(bvh, aabb_lo=lo, aabb_hi=hi)
