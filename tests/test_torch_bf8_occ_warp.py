"""The warp schedule of the redesigned K2 and occluded_v6
(`csrc/bf8_occluded_warp_kernels.cu`) on the CPU, through its plain PyTorch
versions (`kernels.occluded_bf8_warp_plain` / `occluded_v6_warp_plain`).

* The schedule (lanes walk their own stacks, pushing hit children in child
  order, K2 sending a popped leaf to its page with no retest and v6
  retesting its leaf row against `dist`; they pause at pending leaves, are
  grouped by warp and leaf, tested chunk by chunk, and an occluded lane
  leaves its group and is done) gives the per-ray walk's bools, the g++
  build of `bf8_traverse.cuh` / `v6_traverse.cuh`, at blocks 32, 64 and
  128, K2 with `opaque_only` off and on over a tree with every other
  triangle alpha-tagged; its node visits, leaf-box retests (none for K2)
  and triangle tests up to the first that occludes are the counted per-ray
  walk's.
* Sparse leaves (8 triangles padded out to 32 columns) under groups of more
  rays than columns that can accept: the warp steps through the columns.
* A group whose members are all occluded in their first chunk stops
  staging: one chunk in flight after it, not the leaf's four.
* Dead lanes (as the integrator kills them), tail lanes and a warp of one
  lane.
* Against `pt`'s Pallas kernels in interpret mode (`packet_occluded_bf8`
  with both flags, `packet_occluded_v6`) it stays within the existing
  near-edge budget (at most 1% of rays differ, bf16 leaf product).

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

from test_torch_accel import (CSRC, T, _fields, _heightfield_soup,
                              _random_tris, pallas_interpret)  # noqa: F401
from test_torch_bf8_warp import _soup_rays
from test_torch_gpu import (first_chunk_rays, first_chunk_trees,
                            sparse_leaf_rays, sparse_leaf_trees)

WALKS = {"bf8": "occluded_bf8", "v6": "occluded_v6"}
# (walk, opaque_only): K2 with the flag off and on; pt's v6 has no flag
CASES = [("bf8", False), ("bf8", True), ("v6", False)]
CASE_IDS = ["bf8", "bf8-opaque_only", "v6"]

_HOST_SRC = r"""
#include "v6_traverse.cuh"
extern "C" {
void host_bf8(const float* c_lo, const float* c_hi, const int32_t* c_ent,
              const float* l_lo, const float* l_hi, const float* pages,
              int block, int cols, const float* o, const float* d,
              const float* dist, float tmin, int opaque_only, int n,
              uint8_t* out, unsigned long long* stats, uint8_t* node_seen,
              uint8_t* tri_seen) {
    bf8::Tree tree{c_lo, c_hi, c_ent, l_lo, l_hi, pages, block, cols};
    for (int i = 0; i < n; ++i) {
        bf8::Counts c{0, 0, 0, node_seen, tri_seen};
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        out[i] = bf8::occluded<true>(tree, r, tmin, dist[i],
                                     opaque_only != 0, &c);
        stats[0] += c.nodes; stats[1] += c.leaf_boxes; stats[2] += c.tris;
    }
}
void host_v6(const float* u_lo, const float* u_hi, const int32_t* c_ent,
             const int32_t* c_order, const float* pages, int n8, int block,
             int cols, const float* o, const float* d, const float* dist,
             float tmin, int n, uint8_t* out, unsigned long long* stats,
             uint8_t* node_seen, uint8_t* tri_seen) {
    v6::Tree tree{u_lo, u_hi, c_ent, c_order, pages, n8, block, cols};
    for (int i = 0; i < n; ++i) {
        bf8::Counts c{0, 0, 0, node_seen, tri_seen};
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        out[i] = v6::occluded<true>(tree, r, tmin, dist[i], &c);
        stats[0] += c.nodes; stats[1] += c.leaf_boxes; stats[2] += c.tris;
    }
}
}
"""


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    """The counted per-ray occlusion walks of bf8_traverse.cuh (K2) and
    v6_traverse.cuh (occluded_v6), built for the host by g++ (no torch
    headers), with -ffp-contract=off so that they round as the -fmad=false
    CUDA build does."""
    tmp = tmp_path_factory.mktemp("bf8_occ_warp_host")
    src = tmp / "walks.cpp"
    src.write_text(_HOST_SRC)
    lib = tmp / "libwalks.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{CSRC}", str(src), "-o",
                    str(lib)], check=True, capture_output=True, timeout=120)
    h = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.host_bf8.argtypes = [p] * 6 + [i, i, p, p, p, f, i, i] + [p] * 4
    h.host_v6.argtypes = [p] * 5 + [i, i, i, p, p, p, f, i] + [p] * 4
    return h


def _host_occluded(host, walk, tree, o, d, dist, opaque_only=False):
    """The g++ per-ray walk `walk`, counted: bool (N,), [node visits,
    leaf-box retests, triangle tests]."""
    n = o.shape[0]
    out = torch.empty(n, dtype=torch.uint8)
    wc = kernels.work_counts(tree)
    if walk == "bf8":
        fn, args = host.host_bf8, kernels._tree_args(tree)
        flags = (int(opaque_only),)
    else:
        fn, args, flags = host.host_v6, kernels._tree_args_v6(tree), ()
    fn(*args, o.data_ptr(), d.data_ptr(), dist.data_ptr(), 1e-5, *flags, n,
       out.data_ptr(), *(a.data_ptr() for a in wc))
    return out.bool(), wc.totals.tolist()


def _schedule(walk, tree, o, d, dist, opaque_only=False):
    fn = getattr(kernels, WALKS[walk] + "_warp_plain")
    if walk == "bf8":
        return fn(tree, o, d, dist, opaque_only=opaque_only)
    return fn(tree, o, d, dist)


def _check_against_host(host, walk, tree, o, d, dist, opaque_only=False):
    """The schedule's bools and work equal to the host walk's; what holds of
    any occlusion schedule: a group is one leaf's page, an occluded member
    is tested no further, and a group stages at most its leaf's chunks.
    Returns (occluded, sched)."""
    want, totals = _host_occluded(host, walk, tree, o, d, dist, opaque_only)
    occ, sched = _schedule(walk, tree, o, d, dist, opaque_only)
    assert occ.dtype == torch.bool and torch.equal(occ, want)
    assert [sched.node_visits, sched.leaf_boxes, sched.tri_tests] == totals
    nc = tree.block // 32
    assert sum(sched.lanes_per_group) == sched.groups == sched.leaves
    assert sched.groups <= sched.leaf_visits
    if walk == "bf8":
        assert sched.leaf_boxes == 0                  # K2 retests no leaf
    else:
        assert sched.leaf_visits <= sched.leaf_boxes
    assert sched.leaf_visits <= sched.ray_chunk_tests \
        <= sched.leaf_visits * nc
    assert sched.groups <= sched.chunk_loads <= sched.groups * nc
    assert sched.warp_tests <= sched.ray_chunk_tests
    assert sched.warps <= -(-o.shape[0] // 32)
    return occ, sched


def _trees(soup, block):
    """An SBVH BF8 tree of `soup` at leaves of `block`, every other
    triangle alpha-tagged, and its BF8V6."""
    verts, tri = (_random_tris(700 * block // 32, seed=101)
                  if soup == "random" else _heightfield_soup(32))
    opaque = (np.arange(tri.shape[0]) % 2) == 0
    b8 = tbvh.build_bf8(tbvh.build_packet_bvh_sah(
        verts, tri, block=block, max_leaves=8192, tri_opaque_np=opaque,
        spatial=True, device="cpu"))
    assert b8.block == block
    return {"bf8": b8, "v6": archive.bf8_v6_of(b8)}


@pytest.mark.parametrize("walk,opaque_only", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("soup,block", [("random", 32), ("random", 64),
                                        ("random", 128), ("heightfield", 32)])
def test_occ_warp_schedule_matches_per_ray_walk(host_walks, walk,
                                                opaque_only, soup, block):
    """A seeded soup (SBVH at leaves of `block`) and the Heightfield's SBVH
    at block 32, 2,000 rays (no multiple of 32) with seeded distances: the
    schedule's bools against the per-ray walk's, with the same node
    visits, leaf-box retests and triangle tests. Under opaque_only fewer
    rays are occluded, never more."""
    tree = _trees(soup, block)[walk]
    n = 2000
    o, d = _soup_rays(soup, n)
    dist = T(np.random.default_rng(102).uniform(1, 25, n)
             .astype(np.float32))
    occ, sched = _check_against_host(host_walks, walk, tree, o, d, dist,
                                     opaque_only)
    assert n // 20 < int(occ.sum()) < n - n // 20
    # occluded members leave their groups: fewer tests than every member
    # against every chunk where a leaf has more than one
    if block > 32:
        assert sched.ray_chunk_tests < sched.leaf_visits * (block // 32)
    # leaves hold more than one lane now and then
    assert sched.leaf_visits > sched.groups
    if opaque_only:
        every, _ = _host_occluded(host_walks, walk, tree, o, d, dist)
        assert not bool((occ & ~every).any())
        assert bool((every & ~occ).any())


@pytest.mark.parametrize("walk,opaque_only", CASES, ids=CASE_IDS)
def test_occ_warp_schedule_on_sparse_leaves(host_walks, walk, opaque_only):
    """Leaves of 8 triangles (every other alpha-tagged) padded out to 32
    columns under coherent rays: leaf groups hold more rays than columns
    that can accept, so the warp steps through the columns (`warp_tests`
    below `ray_chunk_tests`); the bools stay the per-ray walk's."""
    tree = sparse_leaf_trees("cpu")[0 if walk == "bf8" else 1]
    n = 4096
    o, d = sparse_leaf_rays(n, "cpu")
    dist = torch.full((n,), 1e4)
    occ, sched = _check_against_host(host_walks, walk, tree, o, d, dist,
                                     opaque_only)
    # a group steps through at most its leaf's 8 columns (4 opaque)
    assert sched.warp_tests <= (4 if opaque_only else 8) * sched.groups
    assert sched.warp_tests < sched.ray_chunk_tests // 2
    assert n // 4 < int(occ.sum()) < n


@pytest.mark.parametrize("walk", list(WALKS))
def test_occ_warp_group_occluded_in_its_first_chunk_stops_staging(
        host_walks, walk):
    """Leaves of 128 columns whose first chunk occludes every ray that
    enters them: each group stages its first chunk and has its second in
    flight, not its four, and each member is tested against one chunk."""
    tree = first_chunk_trees("cpu")[0 if walk == "bf8" else 1]
    n = 2048
    o, d = first_chunk_rays(n, "cpu")
    dist = torch.full((n,), 1e4)
    occ, sched = _check_against_host(host_walks, walk, tree, o, d, dist)
    assert bool(occ.all())
    assert sched.leaf_visits == n                 # one leaf each
    assert sched.ray_chunk_tests == n
    assert sched.chunk_loads == 2 * sched.groups
    assert sched.lanes_per_group[-1] > 0          # whole warps in one leaf


@pytest.mark.parametrize("walk,opaque_only", CASES, ids=CASE_IDS)
def test_occ_warp_schedule_on_dead_and_tail_lanes(host_walks, walk,
                                                  opaque_only):
    """Lanes killed as the integrator kills them end at the root in the
    schedule too and are never occluded; 33 lanes leave a warp of one, and
    one lane alone is a warp."""
    from pt_torch.render.integrator import _degenerate_masked
    tree = _trees("random", 32)[walk]
    o, d = _soup_rays("random", 33)
    live = torch.arange(33) % 2 == 0
    od, dd, td = (a.contiguous() for a in
                  _degenerate_masked(tree, o, d, 30.0, live))
    occ, sched = _check_against_host(host_walks, walk, tree, od, dd, td,
                                     opaque_only)
    assert sched.warps <= 2
    assert not bool(occ[~live].any())
    assert int(occ[live].sum()) > 0
    one = _check_against_host(host_walks, walk, tree, od[32:], dd[32:],
                              td[32:], opaque_only)[1]
    assert one.warps <= 1 and one.groups == one.leaf_visits


@pytest.mark.parametrize("walk,opaque_only", CASES, ids=CASE_IDS)
def test_occ_warp_schedule_matches_pallas_kernels_within_budget(
        pallas_interpret, walk, opaque_only):
    """`pt`'s K2 (`packet_occluded_bf8`, both flags) and v6 occlusion
    (`packet_occluded_v6`) on the structures `pt` built, carried across by
    `convert`, against the warp schedule."""
    verts, tri = _random_tris(1000, seed=103)
    opaque = (np.arange(1000) % 2) == 0
    jp = jbvh.build_packet_bvh_sah(verts, tri, block=32, max_leaves=8192,
                                   tri_opaque_np=opaque, spatial=True)
    n = 1024
    o, d = (a.numpy() for a in _soup_rays("random", n))
    dist = np.random.default_rng(105).uniform(1, 40, n).astype(np.float32)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist), 1e-5)
    if walk == "bf8":
        j = jbvh.build_bf8(jp)
        tree = convert.bf8_bvh(_fields(j), device="cpu")
        jo = jbvh.packet_occluded_bf8(j, *args, opaque_only=opaque_only)
    else:
        j = jarch.build_bf8_v6(jp)
        tree = convert.bf8_v6(_fields(j), device="cpu")
        jo = jarch.packet_occluded_v6(j, *args)
    occ, _ = _schedule(walk, tree, T(o), T(d), T(dist), opaque_only)
    differ = occ.numpy() != np.asarray(jo)
    assert differ.mean() <= 0.01, differ.mean()
    assert 100 < int(occ.sum()) < n - 100
