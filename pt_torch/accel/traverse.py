"""Stackless threaded-BVH traversal, the walk of `backend="bvh"`.

Port of `pt.accel.traverse` as tensor code (`pt` writes it in XLA, not
Pallas, so it has no hand-written kernel here). All rays advance one
preorder cursor in lockstep: a box hit goes to cursor + 1 (the left child),
a miss to the node's skip link. Per ray the state is (cursor, parked, best
t/tri/u/v); there is no stack.

Two nested loops, as in `pt`:

* inner, `_walk_to_leaves`: every live ray tests its node's box (one gather
  and a slab test a step) until it parks at a leaf whose box it hit, or
  finishes;
* outer, a leaf round: the parked rays test their leaf's K triangles
  (Möller–Trumbore, in `pt`'s float order) and move past it.

`pt`'s `while_loop` conditions (`jnp.any(...)`) become host syncs in eager
PyTorch, one per lockstep step of each loop. Both loop bodies leave a
finished or parked ray unchanged, so running a body on a state where the
condition is already false changes nothing. The walks therefore test their
condition only every `check_every` steps (`CHECK_EVERY` by default), which
gives the same hits bit for bit as testing it every step, with a k-th of
the syncs. `stats` counts the traces, lockstep steps and host syncs since
`reset_stats()`.
"""

from __future__ import annotations

import torch

from pt_torch.accel.intersect import Hit
from pt_torch.accel.lbvh import ThreadedBVH

# lockstep steps between two tests of a loop's condition (one host sync)
CHECK_EVERY = 8

# traces (closest and occluded calls), leaf rounds, inner walk steps and
# host syncs since reset_stats()
stats = {"traces": 0, "rounds": 0, "steps": 0, "syncs": 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def _any(mask: torch.Tensor) -> bool:
    """`mask.any()` read back to the host: one sync, counted."""
    stats["syncs"] += 1
    return bool(torch.any(mask))


def _inv_dirs(dirs):
    return 1.0 / torch.where(torch.abs(dirs) < 1e-12,
                             torch.where(dirs < 0, -1e-12, 1e-12), dirs)


def _slab_test(lo, hi, o, inv_d, t_best):
    """Ray-AABB slab test: a hit given the current best t."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return (t_near <= t_far) & (t_far > 0.0) & (t_near < t_best)


def _leaf_test(positions, tri_idx, leaf_tris_row, o, d, tmin, t_best,
               tri_best, u_best, v_best):
    """Möller–Trumbore over one leaf's K triangles for each ray, in `pt`'s
    order: the cross products, then the sums over the last axis; a
    |det| < 1e-12 triangle is skipped; among equal t the first slot wins."""
    ts = leaf_tris_row                                    # (N, K)
    safe = torch.clamp(ts, min=0).long()
    idx = tri_idx.long()
    v0 = positions[idx[safe, 0]]                          # (N, K, 3)
    e1 = positions[idx[safe, 1]] - v0
    e2 = positions[idx[safe, 2]] - v0
    ox = o[:, None, :].expand_as(v0)
    dx = d[:, None, :].expand_as(v0)
    pvec = torch.linalg.cross(dx, e2, dim=-1)
    det = torch.sum(e1 * pvec, dim=-1)
    inv_det = torch.where(torch.abs(det) < 1e-12, 0.0,
                          1.0 / torch.where(det == 0, 1.0, det))
    tvec = ox - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    v = torch.sum(dx * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    ok = ((ts >= 0) & (torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > tmin) & (t < t_best[:, None]))
    t = torch.where(ok, t, float("inf"))
    k = torch.argmin(t, dim=-1, keepdim=True)

    def pick(a):
        return torch.gather(a, -1, k)[:, 0]
    t_k = pick(t)
    better = torch.isfinite(t_k)
    return (torch.where(better, t_k, t_best),
            torch.where(better, pick(ts), tri_best),
            torch.where(better, pick(u), u_best),
            torch.where(better, pick(v), v_best))


class _Tables:
    """The per-node tables of the walk over one tree, in the form a step
    gathers: box corners lo, hi (n_nodes + 1, 3) and (skip link, leaf id)
    pairs (n_nodes + 1, 2) int64, indexed by the cursor.

    Node n_nodes, where a finished ray's cursor points, is a sentinel that
    every ray misses and whose skip link is itself, so a finished ray stays
    finished without a mask. A parked ray stays parked too: its leaf's box
    passes again against the same limit. So a step needs no live mask; the
    loop's condition reads one every `check_every` steps.

    An empty box (a padding leaf, or a node over padding leaves only:
    lo = +inf, hi = -inf) passes `pt`'s slab test for every ray, since each
    axis gives t0, t1 = ∓inf, so `pt`'s walk enters every padding subtree
    and tests every padding leaf (7,903 of the 32,768 leaves of the
    Heightfield n=224). Here such a box, like the sentinel's, is
    lo = hi = +inf, which every ray misses: a +inf slab entry or a -inf
    exit. It holds no triangle, so the hits are `pt`'s all the same, in far
    fewer steps."""

    def __init__(self, bvh: ThreadedBVH):
        n = self.n_nodes = bvh.n_nodes
        empty = (bvh.aabb_lo > bvh.aabb_hi).any(dim=-1, keepdim=True)
        self.lo, self.hi = (
            torch.cat([torch.where(empty, float("inf"), a),
                       torch.full_like(a[:1], float("inf"))])
            for a in (bvh.aabb_lo, bvh.aabb_hi))
        meta = torch.stack([bvh.miss_next.long(), bvh.leaf_id.long()], dim=1)
        self.meta = torch.cat([meta, torch.as_tensor([[n, -1]],
                                                     device=meta.device)])
        self.leaf_tris = bvh.leaf_tris


def _tables(bvh: ThreadedBVH) -> _Tables:
    """The tree's walk tables, made at its first walk and kept with it."""
    tb = bvh.__dict__.get("_walk_tables")
    if tb is None:
        tb = bvh.__dict__["_walk_tables"] = _Tables(bvh)
    return tb


def _walk_to_leaves(tb: _Tables, origins, inv_d, cursor, t_limit,
                    check_every: int):
    """Advance every live ray until it parks at a leaf whose box it hit or
    finishes. Returns (cursor, parked)."""
    parked = torch.zeros(cursor.shape, dtype=torch.bool,
                         device=cursor.device)
    step = 0
    while not (step % check_every == 0
               and not _any((cursor < tb.n_nodes) & ~parked)):
        hit_box = _slab_test(tb.lo[cursor], tb.hi[cursor], origins, inv_d,
                             t_limit)
        meta = tb.meta[cursor]
        is_leaf = meta[:, 1] >= 0
        parked = hit_box & is_leaf
        # a box hit descends to cursor + 1 (or stays, parked, at a leaf);
        # a miss takes the skip link
        cursor = torch.where(hit_box, torch.where(is_leaf, cursor,
                                                  cursor + 1), meta[:, 0])
        step += 1
        stats["steps"] += 1
    return cursor, parked


def _leaf_round(tb: _Tables, cursor, parked):
    """The parked rays' leaf rows, and every ray's cursor after the round
    (a parked ray moves past its leaf)."""
    meta = tb.meta[cursor]
    row = tb.leaf_tris[torch.clamp(meta[:, 1], min=0)]
    return row, torch.where(parked, meta[:, 0], cursor)


def bvh_closest(bvh: ThreadedBVH, positions: torch.Tensor,
                tri_idx: torch.Tensor, origins: torch.Tensor,
                dirs: torch.Tensor, tmin: float = 1e-5, tmax=1e4,
                check_every: int = CHECK_EVERY) -> Hit:
    """Closest hit by the two-phase threaded walk. origins/dirs (N, 3),
    tmax a scalar or (N,). `check_every` (>= 1): lockstep steps between two
    tests of a loop's condition; every value gives the same hits."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    stats["traces"] += 1
    n = origins.shape[0]
    dev = origins.device
    tb = _tables(bvh)
    inv_d = _inv_dirs(dirs)
    t_best = torch.as_tensor(tmax, dtype=torch.float32,
                             device=dev).expand(n).clone()
    cursor = torch.zeros((n,), dtype=torch.int64, device=dev)
    tri_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((n,), dtype=torch.float32, device=dev)
    v_best = torch.zeros((n,), dtype=torch.float32, device=dev)
    rnd = 0
    while not (rnd % check_every == 0 and not _any(cursor < tb.n_nodes)):
        cursor, parked = _walk_to_leaves(tb, origins, inv_d, cursor, t_best,
                                         check_every)
        row, cursor = _leaf_round(tb, cursor, parked)
        t2, tri2, u2, v2 = _leaf_test(positions, tri_idx, row, origins,
                                      dirs, tmin, t_best, tri_best, u_best,
                                      v_best)
        t_best = torch.where(parked, t2, t_best)
        tri_best = torch.where(parked, tri2, tri_best)
        u_best = torch.where(parked, u2, u_best)
        v_best = torch.where(parked, v2, v_best)
        rnd += 1
        stats["rounds"] += 1
    return Hit(t_best, tri_best, u_best, v_best)


def bvh_occluded(bvh: ThreadedBVH, positions: torch.Tensor,
                 tri_idx: torch.Tensor, origins: torch.Tensor,
                 dirs: torch.Tensor, dist, tmin: float = 1e-5,
                 check_every: int = CHECK_EVERY) -> torch.Tensor:
    """Any hit within `dist` (a scalar or (N,)), each ray done at its first
    blocker (≙ the occlusion traceRay with TerminateOnFirstHit)."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    stats["traces"] += 1
    n = origins.shape[0]
    dev = origins.device
    tb = _tables(bvh)
    dist = torch.as_tensor(dist, dtype=torch.float32, device=dev).expand(n)
    inv_d = _inv_dirs(dirs)
    sentinel_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    cursor = torch.zeros((n,), dtype=torch.int64, device=dev)
    occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
    rnd = 0
    while not (rnd % check_every == 0
               and not _any((cursor < tb.n_nodes) & ~occluded)):
        # occluded rays are done: their cursor goes to the end
        cursor = torch.where(occluded, tb.n_nodes, cursor)
        cursor, parked = _walk_to_leaves(tb, origins, inv_d, cursor, dist,
                                         check_every)
        row, cursor = _leaf_round(tb, cursor, parked)
        _, tri2, _, _ = _leaf_test(positions, tri_idx, row, origins, dirs,
                                   tmin, dist, sentinel_tri, zeros, zeros)
        occluded = occluded | (parked & (tri2 >= 0))
        rnd += 1
        stats["rounds"] += 1
    return occluded
