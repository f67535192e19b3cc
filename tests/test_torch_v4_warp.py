"""The warp schedule of the redesigned K3/K4 (`csrc/v4_warp_kernels.cu`)
on the CPU, through its plain PyTorch version
(`kernels.closest_v4_warp_plain` / `occluded_v4_warp_plain`).

* The reduction key: `t_order_key` orders like the floats and folds -0.0
  into +0.0, and the kernels' chunk reduction (least key, then least id at
  that key, u/v from the winner) merged chunk by chunk gives what the
  sequential loop of `v4_traverse.cuh` (closest<>, the leaf loop) gives, on
  exact t ties with different ids, alpha-tagged ids, misses and +-0.0.
* The schedule (lanes pause at pending leaves, are grouped by warp and
  leaf, tested chunk by chunk, resume) is bit-equal to the per-ray walk,
  the g++ build of `v4_traverse.cuh`, at blocks 32, 64 and 128, on an
  alpha-tagged tree and on a static SAH tree; its node visits are the
  per-ray walk's counted ones.
* Against `pt`'s Pallas kernels in interpret mode it stays within the
  existing near-edge budget (at most 1% of rays differ, bf16 leaf product).

The CUDA kernels themselves are tested in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pt.accel import pallas_bvh as jbvh
from pt_torch import convert
from pt_torch.accel import bvh8 as tbvh
from pt_torch.accel import kernels

from test_torch_accel import (T, _fields, _heightfield_soup, _random_rays,
                              _random_tris, pallas_interpret)  # noqa: F401
from test_torch_accel_v4 import _host_closest, host_traversal  # noqa: F401

ALPHA = tbvh.ALPHA_TRI_BIT


# ------------------------------------------------------ the reduction key

def test_t_order_key_orders_like_the_floats():
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        rng.normal(0, 10, 2000), rng.uniform(-1e-38, 1e-38, 200),
        [0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38, np.inf, -np.inf, 1e-5,
         1.0, -1.0]]).astype(np.float32)
    key = kernels.t_order_key(torch.as_tensor(vals)).numpy()
    assert key.min() >= 0 and key.max() < 2 ** 32
    a, b = np.meshgrid(np.arange(vals.size), np.arange(vals.size),
                       indexing="ij")
    sel = rng.choice(a.size, 200_000, replace=False)
    x, y = vals[a.flat[sel]], vals[b.flat[sel]]
    kx, ky = key[a.flat[sel]], key[b.flat[sel]]
    np.testing.assert_array_equal(kx < ky, x < y)
    np.testing.assert_array_equal(kx == ky, x == y)
    zeros = kernels.t_order_key(torch.tensor([0.0, -0.0]))
    assert zeros[0] == zeros[1] == 0x80000000


def _sequential(t, u, v, acc, ids, tmax):
    """v4_traverse.cuh:119-127, the per-ray leaf loop, one column after the
    other (a padding column, id -1, is never accepted)."""
    best_t, best_tri, best_u, best_v = np.float32(tmax), -1, 0.0, 0.0
    for j in range(t.size):
        if ids[j] < 0 or not acc[j]:
            continue
        idc = int(ids[j]) & ~ALPHA
        if t[j] < best_t or (t[j] == best_t and best_tri >= 0
                             and idc < best_tri):
            best_t, best_tri, best_u, best_v = t[j], idc, u[j], v[j]
    return best_t, best_tri, best_u, best_v


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chunk_reduction_matches_sequential_rule(seed):
    """Rows of 4 chunks of 32 columns. A column is a triangle: t, u and v
    follow from its id (a triangle referenced twice, as an SBVH leaf may,
    gives the same bits), and t is drawn from a few values, +-0.0 among
    them, so exact ties between different ids are common. Ids with and
    without ALPHA_TRI_BIT, padding, rows with no accepted column; u and v
    differ per id, so a wrong winner shows."""
    rng = np.random.default_rng(seed)
    rows, nc = 512, 4
    cols = nc * 32
    pool = np.array([-2.5, -0.0, 0.0, 0.5, 1.0, 1.0000001, 7.0],
                    np.float32)
    ids = rng.integers(0, 300, (rows, cols)).astype(np.int32)
    tri_t = rng.choice(pool, 300).astype(np.float32)
    tri_u = rng.random(300).astype(np.float32)
    tri_v = rng.random(300).astype(np.float32)
    t, u, v = tri_t[ids], tri_u[ids], tri_v[ids]
    ids |= np.where(ids % 5 == 0, ALPHA, 0).astype(np.int32)
    ids[rng.random((rows, cols)) < 0.1] = -1
    acc = rng.random((rows, cols)) < np.where(
        np.arange(rows)[:, None] % 7 == 0, 0.0, 0.2)   # some rows all miss
    tmax = np.float32(9.0)
    acc &= (ids >= 0) & (t < tmax)

    tt, ut, vt = T(t), T(u), T(v)
    at = torch.as_tensor(acc)
    idc = torch.as_tensor(ids).to(torch.int64) & ~ALPHA
    best = (torch.full((rows,), tmax), torch.full((rows,), -1,
                                                  dtype=torch.int64),
            torch.zeros(rows), torch.zeros(rows))
    for c in rng.permutation(nc):      # the merge does not depend on order
        cs = slice(c * 32, (c + 1) * 32)
        best = kernels._merge_best(best, *kernels._chunk_winner(
            tt[:, cs], ut[:, cs], vt[:, cs], at[:, cs], idc[:, cs]))
    got_t, got_id, got_u, got_v = (b.numpy() for b in best)
    n_ties = 0
    for r in range(rows):
        want = _sequential(t[r], u[r], v[r], acc[r], ids[r], tmax)
        got = (got_t[r], int(got_id[r]), got_u[r], got_v[r])
        assert np.float32(got[0]).tobytes() == np.float32(want[0]).tobytes()
        assert got[1:] == want[1:], (r, got, want)
        at_min = acc[r] & (t[r] == want[0])
        n_ties += int(at_min.sum() > 1)
    assert n_ties > 50                  # exact ties were exercised
    assert (got_id == -1).sum() >= rows // 7


# --------------------------------------------- schedule vs per-ray walk

def _tree(kind):
    if kind == "sah":
        verts, tri = _random_tris(700, seed=14)
        opaque = (np.arange(700) % 3) != 0
        return tbvh.build_packet_bvh_sah(verts, tri, tri_opaque_np=opaque,
                                         spatial=True, device="cpu"), None
    if kind == "heightfield":
        verts, tri = _heightfield_soup(32)
        return tbvh.build_packet_bvh(T(verts), T(tri)), "down"
    blk = {"block32": 32, "block64": 64, "block128": 128,
           "alpha64": 64}[kind]
    verts, tri = _random_tris(1100, seed=5)
    opaque = ((np.arange(1100) % 2) == 0 if kind == "alpha64" else None)
    return tbvh.build_packet_bvh(
        T(verts), T(tri), block=blk,
        tri_opaque=None if opaque is None else T(opaque)), None


def _rays(kind, n, seed):
    if kind != "down":
        return _random_rays(n, seed=seed)
    rng = np.random.default_rng(seed)
    o = rng.uniform(-11, 11, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(1.5, 6, n)
    d = rng.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1])
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["block32", "block64", "block128",
                                  "alpha64", "heightfield", "sah"])
def test_warp_schedule_matches_per_ray_walk(host_traversal, kind):
    pb, rays = _tree(kind)
    if kind.startswith("block"):
        assert pb.block == int(kind[5:])
    ids = pb.pages[:, 0, 6 * pb.block:7 * pb.block].contiguous() \
        .view(torch.int32)
    if kind in ("alpha64", "sah"):
        assert bool(((ids >= 0) & (ids & ALPHA != 0)).any())
    n = 2000                           # not a multiple of 32
    o, d = (T(a) for a in _rays(rays, n, seed=40))
    tmax = T(np.random.default_rng(41).uniform(5, 40, n).astype(np.float32))
    (t, tri, u, v), counts = _host_closest(host_traversal, pb, o, d, tmax)
    hit, sched = kernels.closest_v4_warp_plain(pb, o, d, tmax)
    assert torch.equal(hit.tri, tri)
    for a, b in ((hit.t, t), (hit.u, u), (hit.v, v)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int((tri >= 0).sum()) > n // 20
    # the same walk: node visits as the per-ray counted variant's
    assert sched.node_visits == int(counts.totals[0])
    nc = pb.block // 32
    assert sched.ray_chunk_tests == sched.leaf_visits * nc
    assert sched.chunk_loads == sched.groups * nc
    assert sum(sched.lanes_per_group) == sched.groups
    assert sched.groups <= sched.leaf_visits
    assert sched.warps == (n + 31) // 32 or kind == "sah"
    dist = T(np.random.default_rng(42).uniform(0.5, 20, n).astype(np.float32))
    out = torch.empty(n, dtype=torch.uint8)
    host_traversal.host_occluded(*kernels._tree_args_v4(pb), o.data_ptr(),
                                 d.data_ptr(), dist.data_ptr(), 1e-5, n,
                                 out.data_ptr())
    occ, osched = kernels.occluded_v4_warp_plain(pb, o, d, dist)
    assert torch.equal(occ, out.bool())
    assert 0 < int(occ.sum()) < n
    assert osched.chunk_loads <= osched.groups * nc
    assert osched.ray_chunk_tests <= osched.leaf_visits * nc


def test_warp_schedule_on_dead_and_tail_lanes(host_traversal):
    """Lanes killed as the integrator kills them end at the root in the
    schedule too; 33 lanes leave a warp of one."""
    from pt_torch.render.integrator import _degenerate_masked
    verts, tri = _random_tris(1100, seed=5)
    pb = tbvh.build_packet_bvh(T(verts), T(tri))
    o, d = (T(a) for a in _random_rays(33, seed=31))
    live = torch.arange(33) % 2 == 0
    od, dd, td = (a.contiguous() for a in
                  _degenerate_masked(pb, o, d, 1e4, live))
    hit, sched = kernels.closest_v4_warp_plain(pb, od, dd, td)
    (t, tri_out, u, v), counts = _host_closest(host_traversal, pb, od, dd,
                                               td)
    assert torch.equal(hit.tri, tri_out) and torch.equal(hit.t, t)
    assert sched.node_visits == int(counts.totals[0])
    assert (hit.tri[~live] == -1).all() and torch.equal(hit.t[~live],
                                                        td[~live])


# ---------------------------------------------- against the Pallas kernels

def test_warp_schedule_matches_pallas_kernels_within_budget(
        pallas_interpret):
    verts, tri = _random_tris(200, seed=11, spread=4.0)
    opaque = (np.arange(200) % 4) != 0
    jp = jbvh.build_packet_bvh(jnp.asarray(verts), jnp.asarray(tri),
                               tri_opaque=jnp.asarray(opaque))
    pb = convert.packet_bvh(_fields(jp), device="cpu")
    o, d = _random_rays(1024, seed=12, spread=6.0)
    tmax = np.full(1024, 1e4, np.float32)
    dist = np.random.default_rng(13).uniform(1, 25, 1024).astype(np.float32)
    jh = jbvh.packet_closest_v4(jp, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tmax), 1e-5)
    th, _ = kernels.closest_v4_warp_plain(pb, T(o), T(d), T(tmax))
    differ = th.tri.numpy() != np.asarray(jh.tri)
    assert differ.mean() <= 0.01, differ.mean()
    assert (th.tri.numpy() >= 0).sum() > 50
    same = ~differ & (th.tri.numpy() >= 0)
    # Pallas' o', d' carry ~2^-16 relative error from the bf16 split
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                               rtol=1e-2)
    jo = jbvh.packet_occluded_v4(jp, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(dist), 1e-5)
    to, _ = kernels.occluded_v4_warp_plain(pb, T(o), T(d), T(dist))
    assert (to.numpy() != np.asarray(jo)).mean() <= 0.01
