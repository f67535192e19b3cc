"""The warp schedule of the redesigned closest_v6k2 (A4) and closest_v7 (A5)
(`csrc/v6_warp_kernels.cu`) on the CPU, through its plain PyTorch versions
(`kernels.closest_v6k2_warp_plain` / `closest_v7_warp_plain`).

* The schedule (lanes run rounds of their own walks, v6k2 two pops a round
  and v7 up to `window` pops against the best t as the round starts,
  listing the leaves whose boxes pass; after a round that lists a leaf a
  lane waits; the warp drains the lists, each distinct leaf once, grouped
  by leaf and tested chunk by chunk with the kernels' reduction; the lanes
  resume) is bit-equal to the per-ray walk, the g++ build of
  `v6_traverse.cuh`'s `closest_two_pops` / `closest_leaf_queue`, at blocks
  32, 64 and 128: t, u, v and ids; its node visits, leaf-box retests and
  triangle tests are the counted per-ray walk's.
* v7 at windows 1, 2 and 8, and at a window of 64 over a tree of stacked
  layers whose first round meets the 48-leaf cap of a round.
* Sparse leaves (8 triangles padded out to 32 columns) under groups larger
  than their columns.
* An exact t tie across two leaves: the smaller id wins, as in the per-ray
  walk.
* Dead lanes (as the integrator kills them) and a warp of one lane.
* Against `pt`'s Pallas kernels in interpret mode (`packet_closest_v6k2`,
  `packet_closest_v7`) it stays within the near-edge budget (at most 1% of
  rays differ, bf16 leaf product).

The CUDA kernels themselves are tested in tests/test_torch_gpu.py.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pt.accel import pallas_bvh as jbvh
from pt.accel import pallas_bvh_archive as jarch
from pt_torch import convert
from pt_torch.accel import archive, kernels
from pt_torch.accel import bvh8 as tbvh

from test_torch_accel import (CSRC, T, _fields, _random_rays, _random_tris,
                              pallas_interpret)  # noqa: F401
from test_torch_bf8_warp import _assert_bits_equal, _soup_rays, _trees
from test_torch_gpu import leaf_tree, sparse_leaf_rays, sparse_leaf_trees

WALKS = ("v6k2", "v7")

_HOST_SRC = r"""
#include "v6_traverse.cuh"
extern "C" {
// walk 0: closest_two_pops, 1: closest_leaf_queue at `window`
void host_walk(const float* u_lo, const float* u_hi, const int32_t* c_ent,
               const int32_t* c_order, const float* pages, int n8,
               int block, int cols, const float* o, const float* d,
               const float* tmax, float tmin, int walk, int window, int n,
               float* t, int32_t* tri, float* u, float* v,
               unsigned long long* stats, uint8_t* node_seen,
               uint8_t* tri_seen) {
    v6::Tree tree{u_lo, u_hi, c_ent, c_order, pages, n8, block, cols};
    for (int i = 0; i < n; ++i) {
        bf8::Counts c{0, 0, 0, node_seen, tri_seen};
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        if (walk == 0)
            v6::closest_two_pops<true>(tree, r, tmin, tmax[i], t + i,
                                       tri + i, u + i, v + i, &c);
        else
            v6::closest_leaf_queue<true>(tree, r, tmin, tmax[i], window,
                                         t + i, tri + i, u + i, v + i, &c);
        stats[0] += c.nodes; stats[1] += c.leaf_boxes; stats[2] += c.tris;
    }
}
}
"""


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    """The counted per-ray walks `closest_two_pops` and
    `closest_leaf_queue` of v6_traverse.cuh, built for the host by g++ (no
    torch headers), with -ffp-contract=off so that they round as the
    -fmad=false CUDA build does."""
    tmp = tmp_path_factory.mktemp("v6_warp_host")
    src = tmp / "walks.cpp"
    src.write_text(_HOST_SRC)
    lib = tmp / "libwalks.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{CSRC}", str(src), "-o",
                    str(lib)], check=True, capture_output=True, timeout=120)
    h = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.host_walk.argtypes = ([p] * 5 + [i, i, i, p, p, p, f, i, i, i]
                            + [p] * 7)
    return h


def _host_closest(host, walk, tree, o, d, tmax, window):
    """The g++ per-ray walk `walk`, counted: (t, tri, u, v), [node visits,
    leaf-box retests, triangle tests]."""
    n = o.shape[0]
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    tri = torch.empty(n, dtype=torch.int32)
    wc = kernels.work_counts(tree)
    host.host_walk(*kernels._tree_args_v6(tree), o.data_ptr(), d.data_ptr(),
                   tmax.data_ptr(), 1e-5, WALKS.index(walk), window, n,
                   t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                   *(a.data_ptr() for a in wc))
    return (t, tri, u, v), wc.totals.tolist()


def _schedule(walk, tree, o, d, tmax, window):
    if walk == "v6k2":
        return kernels.closest_v6k2_warp_plain(tree, o, d, tmax)
    return kernels.closest_v7_warp_plain(tree, o, d, tmax, window=window)


def _check_against_host(host, walk, tree, o, d, tmax, window=8):
    """The schedule bit-equal to the host walk, with its work; what holds of
    these schedules: a group is one leaf's page, staged once, every member
    is tested against every chunk, and a warp tests each distinct leaf of
    its lists once a drain. Returns (hit, sched)."""
    want, totals = _host_closest(host, walk, tree, o, d, tmax, window)
    hit, sched = _schedule(walk, tree, o, d, tmax, window)
    _assert_bits_equal(hit, want)
    assert [sched.node_visits, sched.leaf_boxes, sched.tri_tests] == totals
    nc = tree.block // 32
    assert sum(sched.lanes_per_group) == sched.groups == sched.leaves
    assert sched.groups <= sched.leaf_visits <= sched.leaf_boxes
    assert sched.ray_chunk_tests == sched.leaf_visits * nc
    assert sched.chunk_loads == sched.groups * nc
    assert 0 < sched.warp_tests <= sched.ray_chunk_tests
    assert sched.warps <= -(-o.shape[0] // 32)
    return hit, sched


@pytest.mark.parametrize("walk", WALKS)
@pytest.mark.parametrize("soup,block", [("random", 32), ("random", 64),
                                        ("random", 128), ("heightfield", 32)])
def test_warp_schedule_matches_per_ray_walk(host_walks, walk, soup, block):
    """A seeded soup (SBVH at leaves of `block`) and the Heightfield's SBVH
    at block 32, 2,000 rays (no multiple of 32): the schedule's hits
    against the per-ray walk's, with the same node visits, leaf-box
    retests and triangle tests."""
    tree = _trees(soup, block)["v6"]
    n = 2000
    o, d = _soup_rays(soup, n)
    tmax = T(np.random.default_rng(94).uniform(5, 40, n).astype(np.float32))
    hit, sched = _check_against_host(host_walks, walk, tree, o, d, tmax)
    assert sched.warps == -(-n // 32)
    assert int((hit.tri >= 0).sum()) > n // 10
    assert int(((hit.tri >= 0) & (tmax < 1e4)).sum()) > 0
    # leaves hold more than one lane now and then
    assert sched.leaf_visits > sched.groups


@pytest.mark.parametrize("window", [1, 2, 8])
def test_leaf_queue_schedule_at_windows(host_walks, window):
    """v7 at windows 1, 2 and 8 over the random soup: bit-equal to the
    per-ray walk with its work; at window 1 it does closest_v6's work,
    as the per-ray walks do, and the same hits."""
    tree = _trees("random", 32)["v6"]
    n = 1000
    o, d = _soup_rays("random", n)
    tmax = torch.full((n,), 1e4)
    hit, sched = _check_against_host(host_walks, "v7", tree, o, d, tmax,
                                     window)
    one, one_sched = kernels.closest_v6_warp_plain(tree, o, d, tmax)
    assert torch.equal(hit.tri, one.tri)
    work = [sched.node_visits, sched.leaf_boxes, sched.tri_tests]
    v6_work = [one_sched.node_visits, one_sched.leaf_boxes,
               one_sched.tri_tests]
    if window == 1:
        assert work == v6_work
        assert sched.rounds == one_sched.rounds
    else:
        assert sched.tri_tests >= one_sched.tri_tests


def _layer_tree():
    """A BF8V6 of two levels, a root over 8 wide nodes over 8 leaves each:
    leaf k holds a 2 x 2 square (2 triangles, ids 2k and 2k + 1, padded out
    to 32 columns) at height 0.1 k, so a ray straight down through the
    squares hits all 64 leaves' boxes."""
    sq = np.asarray([[[-1, 0, -1], [1, 0, -1], [-1, 0, 1]],
                     [[1, 0, -1], [1, 0, 1], [-1, 0, 1]]], np.float32)
    blk, n_leaves = 32, 64
    v0 = np.zeros((n_leaves * blk, 3), np.float32)
    e1, e2 = np.zeros_like(v0), np.zeros_like(v0)
    ids = np.full(n_leaves * blk, -1, np.int32)
    for k in range(n_leaves):
        corners = sq + [0, 0.1 * k, 0]
        v0[k * blk:k * blk + 2] = corners[:, 0]
        e1[k * blk:k * blk + 2] = corners[:, 1] - corners[:, 0]
        e2[k * blk:k * blk + 2] = corners[:, 2] - corners[:, 0]
        ids[k * blk:k * blk + 2] = [2 * k, 2 * k + 1]
    l_lo = np.asarray([[-1, 0.1 * k, -1] for k in range(n_leaves)],
                      np.float32)
    l_hi = np.asarray([[1, 0.1 * k, 1] for k in range(n_leaves)], np.float32)
    n_lo = l_lo.reshape(8, 8, 3).min(axis=1)
    n_hi = l_hi.reshape(8, 8, 3).max(axis=1)
    c_ent = np.concatenate([np.arange(1, 9), tbvh.LEAF_BIT
                            + np.arange(n_leaves)]).astype(np.int32)
    b8 = tbvh.BF8BVH(
        c_lo=T(np.concatenate([n_lo, l_lo])),
        c_hi=T(np.concatenate([n_hi, l_hi])), c_ent=T(c_ent),
        l_lo=T(l_lo), l_hi=T(l_hi),
        pages=T(tbvh._woop_pages(v0, e1, e2, ids, n_leaves, blk)),
        n8=9, n_leaves=n_leaves, block=blk, root_lo=T(l_lo.min(axis=0)),
        root_hi=T(l_hi.max(axis=0)), depth=2)
    return archive.bf8_v6_of(b8)


def test_leaf_queue_schedule_meets_the_queue_cap(host_walks):
    """A window of 64 over 64 stacked leaves: the first round of a lane
    straight down pops the root, 6 of its nodes and their 48 leaves, and
    stops there (kQueueCap), 9 pops short of its window; the schedule's node
    visits, leaf-box retests and triangle tests are the per-ray walk's,
    which stops at the cap too."""
    tree = _layer_tree()
    n = 64
    rng = np.random.default_rng(98)
    o = np.stack([rng.uniform(-0.6, 0.6, n), np.full(n, 20.0),
                  rng.uniform(-0.6, 0.6, n)], -1).astype(np.float32)
    d = np.tile(np.asarray([[0.001, -1.0, 0.002]], np.float32), (n, 1))
    tmax = torch.full((n,), 1e4)
    hit, sched = _check_against_host(host_walks, "v7", tree, T(o), T(d),
                                     tmax, window=64)
    assert bool((hit.tri >= 0).all())
    # every lane tests at least the cap's 48 leaves in its first drain
    assert sched.leaf_visits >= 48 * n
    # and no more than the cap a drain: a longer window changes nothing
    _, wide = kernels.closest_v7_warp_plain(tree, T(o), T(d), tmax,
                                            window=1 << 20)
    assert wide == sched


@pytest.mark.parametrize("walk", WALKS)
def test_warp_schedule_on_sparse_leaves(host_walks, walk):
    """Leaves of 8 triangles padded out to 32 columns under coherent rays:
    leaf groups hold more rays than columns, so the warp steps through the
    columns (`warp_tests` below `ray_chunk_tests`); the hits stay the
    per-ray walk's."""
    tree = sparse_leaf_trees("cpu")[1]
    n = 4096
    o, d = sparse_leaf_rays(n, "cpu")
    tmax = torch.full((n,), 1e4)
    hit, sched = _check_against_host(host_walks, walk, tree, o, d, tmax)
    # a group steps through at most its leaf's 8 columns
    assert sched.warp_tests <= 8 * sched.groups
    assert sched.warp_tests < sched.ray_chunk_tests // 2
    assert int((hit.tri >= 0).sum()) > n // 4
    assert bool(((hit.tri[hit.tri >= 0] & tbvh.ALPHA_TRI_BIT) == 0).all())


@pytest.mark.parametrize("walk", WALKS)
def test_warp_schedule_tie_across_leaves(host_walks, walk):
    """The same 8 triangles in two leaves, under ids 8-15 in leaf 0 and 0-7
    in leaf 1 (boxes widened so that neither retest culls), and an unshared
    grid in a third leaf: every hit on the pair ties exactly across leaves,
    lists and drain steps, and the smaller id must win, bit-equal to the
    per-ray walk."""
    import chip_smoke
    pos, _, _, tris = chip_smoke._wavy_grid(3)
    k = len(tris)
    corners = pos[tris]
    none = np.zeros(k, bool)
    tree = leaf_tree("cpu", [(corners, np.arange(k) + k, none),
                             (corners, np.arange(k), none),
                             (corners + [2.5, 0, 0], np.arange(k) + 2 * k,
                              none)], pad=0.5)[1]
    n = 1024
    side = 32
    gx, gz = np.meshgrid(np.linspace(-0.9, 3.4, side),
                         np.linspace(-0.9, 0.9, side), indexing="ij")
    o = T(np.stack([gx.ravel(), np.full(n, 3.0), gz.ravel()], -1)
          .astype(np.float32))
    d = T(np.tile(np.asarray([[0.01, -1.0, 0.02]], np.float32), (n, 1)))
    tmax = torch.full((n,), 1e4)
    hit, _ = _check_against_host(host_walks, walk, tree, o, d, tmax)
    on_pair = (hit.tri >= 0) & (hit.tri < 2 * k)
    assert int(on_pair.sum()) > n // 4
    assert int(hit.tri[on_pair].max()) < k           # the tie: ids 0-7
    assert int(((hit.tri >= 2 * k)).sum()) > n // 4


@pytest.mark.parametrize("walk", WALKS)
def test_warp_schedule_on_dead_and_tail_lanes(host_walks, walk):
    """Lanes killed as the integrator kills them end at the root in the
    schedule too; 33 lanes leave a warp of one."""
    from pt_torch.render.integrator import _degenerate_masked
    tree = _trees("random", 32)["v6"]
    o, d = _soup_rays("random", 33)
    live = torch.arange(33) % 2 == 0
    od, dd, td = (a.contiguous() for a in
                  _degenerate_masked(tree, o, d, 1e4, live))
    hit, sched = _check_against_host(host_walks, walk, tree, od, dd, td)
    assert sched.warps == 2
    assert (hit.tri[~live] == -1).all() and torch.equal(hit.t[~live],
                                                        td[~live])
    assert int((hit.tri[live] >= 0).sum()) > 0


@pytest.mark.parametrize("walk", WALKS)
def test_warp_schedule_matches_pallas_kernels_within_budget(
        pallas_interpret, walk):
    """`pt`'s v6k2 (`packet_closest_v6k2`) and v7 (`packet_closest_v7`, its
    window 8) on the BF8V6 `pt` built, carried across by `convert`, against
    the warp schedule."""
    verts, tri = _random_tris(1000, seed=95)
    opaque = (np.arange(1000) % 4) != 0
    jp = jbvh.build_packet_bvh_sah(verts, tri, block=32, max_leaves=8192,
                                   tri_opaque_np=opaque, spatial=True)
    j = jarch.build_bf8_v6(jp)
    tree = convert.bf8_v6(_fields(j), device="cpu")
    packet = (jarch.packet_closest_v6k2 if walk == "v6k2"
              else jarch.packet_closest_v7)
    n = 1024
    o, d = _random_rays(n, seed=96)
    tmax = np.full(n, 1e4, np.float32)
    jh = packet(j, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), 1e-5)
    th, _ = _schedule(walk, tree, T(o), T(d), T(tmax), 8)
    differ = th.tri.numpy() != np.asarray(jh.tri)
    assert differ.mean() <= 0.01, differ.mean()
    same = ~differ & (th.tri.numpy() >= 0)
    assert same.sum() > 100
    # Pallas' o', d' carry ~2^-16 relative error from the bf16 split, which
    # t = -o'z/d'z amplifies on grazing rays
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                               rtol=1e-2)
