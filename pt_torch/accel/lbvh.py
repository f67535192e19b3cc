"""Morton codes and the implicit-tree topology of the per-frame rebuild.

Port of the parts of `pt.accel.lbvh` that the Morton `PacketBVH` build
needs: `_topology` (host numpy, worked out once per leaf count),
`_expand_bits_10` and `morton_codes` (tensor code on the scene's device).
`pt`'s `build_bvh`/`refit_bvh`/`ThreadedBVH` are its XLA fallback off the
TPU and have no counterpart here.

The tree is a complete binary tree over Morton-sorted leaf blocks, stored in
preorder with a `miss` skip link per node: the left child of an internal
node `p` is `p + 1`, and `miss[p]` is the next node once `p`'s subtree is
skipped or done. The topology depends on the leaf count alone, so the device
part of a rebuild is one sort and a few reductions.
"""

from __future__ import annotations

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
