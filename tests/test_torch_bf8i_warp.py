"""The warp schedule of the redesigned K5/K6 (`csrc/bf8i_warp_kernels.cu`)
on the CPU, through its plain PyTorch version
(`kernels.closest_bf8i_warp_plain` / `occluded_bf8i_warp_plain`).

* The schedule (lanes walk their own stacks, pause at pending leaves with
  their rays in the leaf's instance space, are grouped by warp and shared
  page, tested chunk by chunk with the kernels' reduction and branded on
  their own lane, resume) is bit-equal to the per-ray walk, the g++ build
  of `bf8i_traverse.cuh`, at blocks 32, 64 and 128: t, u, v and ids, with
  `raw_ids` and with `opaque_only`; its node and leaf visits are the
  counted per-ray walk's, for closest and for occlusion.
* Page groups that hold lanes of several instances (different brands),
  with an exact t tie across instances: two coincident instances of one
  alpha-tagged mesh and a third beside them, hit by coherent rays.
* A sparse shared page (8 triangles padded out to 32 columns) under
  groups of more rays than columns: the warp steps through the columns.
* Dead lanes (as the integrator kills them) and a warp of one lane.
* Against `pt`'s Pallas kernels in interpret mode it stays within the
  existing near-edge budget (at most 1% of rays differ, bf16 leaf product).

The CUDA kernels themselves are tested in tests/test_torch_gpu.py.
"""

import ctypes
import dataclasses
import subprocess

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pt.accel import instanced as jinst
from pt_torch import convert
from pt_torch.accel import bvh8 as tbvh
from pt_torch.accel import instanced as tinst
from pt_torch.accel import kernels

from test_torch_gpu import sparse_page_rays, sparse_page_structure
from test_torch_instanced import (CSRC, T, _fields, _grid_mesh, _inputs,
                                  _rays_at, host_traversal,  # noqa: F401
                                  pallas_interpret)  # noqa: F401

ALPHA = tbvh.ALPHA_TRI_BIT

_OCC_SRC = r"""
#include "bf8i_traverse.cuh"
extern "C" void host_occluded_counted(
        const float* c_lo, const float* c_hi, const int32_t* c_ent,
        const float* l_lo, const float* l_hi, const int32_t* leaf_page,
        const int32_t* leaf_seg, const float* seg_inv, const float* pages,
        int block, int cols, const float* o, const float* d,
        const float* dist, float tmin, int opaque_only, int n, uint8_t* out,
        unsigned long long* stats, uint8_t* node_seen, uint8_t* leaf_seen,
        uint8_t* tri_seen) {
    bf8i::Tree tree;
    tree.top = bf8::Tree{c_lo, c_hi, c_ent, l_lo, l_hi, pages, block, cols};
    tree.leaf_page = leaf_page; tree.leaf_seg = leaf_seg;
    tree.seg_inv = seg_inv;
    for (int i = 0; i < n; ++i) {
        bf8i::Counts c{0, 0, 0, 0, node_seen, leaf_seen, tri_seen};
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        out[i] = bf8i::occluded<true>(tree, r, tmin, dist[i],
                                      opaque_only != 0, &c);
        stats[0] += c.nodes; stats[2] += c.leaf_visits;
        stats[3] += c.tris;
    }
}
"""


@pytest.fixture(scope="module")
def host_occluded_counted(tmp_path_factory):
    """The counted per-ray occlusion walk of bf8i_traverse.cuh, built for
    the host by g++ as the `host_traversal` fixture is."""
    tmp = tmp_path_factory.mktemp("bf8i_occ_host")
    src = tmp / "occ.cpp"
    src.write_text(_OCC_SRC)
    lib = tmp / "libocc.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{CSRC}", str(src), "-o",
                    str(lib)], check=True, capture_output=True, timeout=120)
    h = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.host_occluded_counted.argtypes = ([p] * 9 + [i, i, p, p, p, f, i, i]
                                        + [p] * 5)
    return h


def _host_closest(host, b, o, d, tmax, raw):
    """The g++ per-ray closest walk, counted: (t, tri, u, v), totals."""
    n = o.shape[0]
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    tri = torch.empty(n, dtype=torch.int32)
    wc = kernels.work_counts(b)
    host.host_closest(*kernels._tree_args_bf8i(b), o.data_ptr(), d.data_ptr(),
                      tmax.data_ptr(), 1e-5, int(raw), n, t.data_ptr(),
                      tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                      wc.totals.data_ptr(), wc.node_seen.data_ptr(),
                      wc.leaf_seen.data_ptr(), wc.tri_seen.data_ptr())
    return (t, tri, u, v), wc.totals.tolist()


def _host_occluded(host, b, o, d, dist, opaque_only):
    n = o.shape[0]
    out = torch.empty(n, dtype=torch.uint8)
    wc = kernels.work_counts(b)
    host.host_occluded_counted(
        *kernels._tree_args_bf8i(b), o.data_ptr(), d.data_ptr(),
        dist.data_ptr(), 1e-5, int(opaque_only), n, out.data_ptr(),
        wc.totals.data_ptr(), wc.node_seen.data_ptr(),
        wc.leaf_seen.data_ptr(), wc.tri_seen.data_ptr())
    return out.bool(), wc.totals.tolist()


def _assert_bits_equal(hit, want):
    t, tri, u, v = want
    assert torch.equal(hit.tri, tri)
    for a, b in ((hit.t, t), (hit.u, u), (hit.v, v)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _check_schedule(sched, b, closest: bool):
    """What holds of any schedule: a group is one page staging, a lane one
    (ray, leaf) test; every lane of a group shares its page; the warp takes
    at most one step per ray and chunk."""
    nc = b.block // 32
    assert sum(sched.lanes_per_group) == sched.groups
    assert sched.groups <= sched.leaves <= sched.leaf_visits
    assert 0 < sched.warp_tests <= sched.ray_chunk_tests
    if closest:
        assert sched.ray_chunk_tests == sched.leaf_visits * nc
        assert sched.chunk_loads == sched.groups * nc
    else:
        assert sched.ray_chunk_tests <= sched.leaf_visits * nc
        assert sched.chunk_loads <= sched.groups * nc


@pytest.mark.parametrize("block", [32, 64, 128])
def test_warp_schedule_matches_per_ray_walk(host_traversal,
                                            host_occluded_counted, block):
    """Seven overlapping instances of two meshes, one alpha-tagged, at
    leaves of `block`: the schedule's hits, with and without raw ids, and
    its occlusion, with and without opaque_only, against the per-ray walk,
    with the same node and leaf visits."""
    meshes, seg_mesh, seg_t, _ = _inputs(alpha_mesh=1)
    b = tinst.build_instanced_bf8(meshes, seg_mesh, seg_t, block,
                                  device="cpu")
    assert b.block == block and b.pages.shape[0] < b.n_leaves
    n = 2000                           # not a multiple of 32
    o, d = (T(a) for a in _rays_at(seg_t, n, 21))
    tmax = T(np.random.default_rng(22).uniform(5, 40, n).astype(np.float32))
    for raw in (False, True):
        want, totals = _host_closest(host_traversal, b, o, d, tmax, raw)
        hit, sched = kernels.closest_bf8i_warp_plain(b, o, d, tmax,
                                                     raw_ids=raw)
        _assert_bits_equal(hit, want)
        assert sched.node_visits == totals[0]
        assert sched.leaf_visits == totals[2]
        _check_schedule(sched, b, closest=True)
        # pages shared across instances: a group holds several leaves
        assert sched.leaves > sched.groups
        assert sched.warps == (n + 31) // 32
    on_alpha = (hit.tri >= 0) & ((hit.tri & ALPHA) != 0)
    assert int(on_alpha.sum()) > 50 and int((hit.tri >= 0).sum()) > n // 4
    dist = T(np.random.default_rng(23).uniform(0.5, 20, n).astype(np.float32))
    n_occ = []
    for flag in (False, True):
        want, totals = _host_occluded(host_occluded_counted, b, o, d, dist,
                                      flag)
        occ, sched = kernels.occluded_bf8i_warp_plain(b, o, d, dist,
                                                      opaque_only=flag)
        assert torch.equal(occ, want)
        assert sched.node_visits == totals[0]
        assert sched.leaf_visits == totals[2]
        _check_schedule(sched, b, closest=False)
        n_occ.append(int(occ.sum()))
    assert 0 < n_occ[1] < n_occ[0] < n


def test_warp_schedule_tie_across_instances(host_traversal,
                                            host_occluded_counted):
    """Two coincident instances of one alpha-tagged mesh (segments 0 and 1)
    and a third, segment 2, beside them. Coherent rays from above, the even
    lanes aimed at the pair and each odd lane at the same point of segment
    2: every hit on the pair ties exactly across instances, and page groups
    hold lanes of two instances (distinct brands over one page). The
    smaller branded id, segment 0's, must win, bit-equal to the per-ray
    walk."""
    pos, tris = _grid_mesh(12)
    seg_t = np.stack([np.eye(4), np.eye(4), np.eye(4)])
    seg_t[2, 0, 3] = 2.5
    meshes = [(pos, tris, np.zeros(len(tris), bool))]
    b = tinst.build_instanced_bf8(meshes, [0, 0, 0], seg_t, device="cpu")
    assert b.block == 32
    # one segment's leaves reference distinct pages, so a group with more
    # leaves than pages holds lanes of two instances
    for s in range(3):
        pages = b.leaf_page[b.leaf_seg == s]
        assert pages.unique().numel() == pages.numel()
    side = 40
    gx, gz = np.meshgrid(np.linspace(-0.95, 0.95, side),
                         np.linspace(-0.95, 0.95, side), indexing="ij")
    pair = np.stack([gx.ravel(), np.full(side * side, 3.0), gz.ravel()], -1)
    beside = pair + [2.5, 0.0, 0.0]
    n = 2 * side * side
    o = T(np.stack([pair, beside], 1).reshape(n, 3).astype(np.float32))
    d = T(np.tile(np.asarray([[0.01, -1.0, 0.02]], np.float32), (n, 1)))
    tmax = torch.full((n,), 1e4)
    for raw in (False, True):
        want, totals = _host_closest(host_traversal, b, o, d, tmax, raw)
        hit, sched = kernels.closest_bf8i_warp_plain(b, o, d, tmax,
                                                     raw_ids=raw)
        _assert_bits_equal(hit, want)
        assert sched.node_visits == totals[0]
        assert sched.leaf_visits == totals[2]
        assert sched.leaves > sched.groups
        _check_schedule(sched, b, closest=True)
    seg = (hit.tri & tinst.SEG_MASK) >> tinst.SEG_SHIFT
    hits = hit.tri >= 0
    assert int(hits[0::2].sum()) > n // 4 and int(hits[1::2].sum()) > n // 4
    assert int(seg[0::2][hits[0::2]].max()) == 0   # the tie: segment 0
    assert bool((seg[1::2][hits[1::2]] == 2).all())
    assert bool(((hit.tri[hits] & ALPHA) != 0).all())           # raw ids
    # every triangle is alpha-tagged: opaque_only finds no occluder
    dist = torch.full((n,), 10.0)
    for flag, want_any in ((False, True), (True, False)):
        want, totals = _host_occluded(host_occluded_counted, b, o, d, dist,
                                      flag)
        occ, sched = kernels.occluded_bf8i_warp_plain(b, o, d, dist,
                                                      opaque_only=flag)
        assert torch.equal(occ, want) and bool(occ.any()) == want_any
        assert sched.node_visits == totals[0]
        assert sched.leaf_visits == totals[2]


def test_warp_schedule_on_sparse_pages(host_traversal,
                                       host_occluded_counted):
    """One shared page of 8 triangles padded out to 32 columns, as the alpha
    cards' trees hold, under 36 instances and coherent rays: page groups
    hold more rays than columns, so the warp steps through the columns
    (`warp_tests` below `ray_chunk_tests`); the hits stay the per-ray
    walk's."""
    b = sparse_page_structure("cpu")
    n = 2048
    o, d = sparse_page_rays(n, "cpu")
    tmax = torch.full((n,), 1e4)
    for raw in (False, True):
        want, totals = _host_closest(host_traversal, b, o, d, tmax, raw)
        hit, sched = kernels.closest_bf8i_warp_plain(b, o, d, tmax,
                                                     raw_ids=raw)
        _assert_bits_equal(hit, want)
        assert sched.node_visits == totals[0]
        assert sched.leaf_visits == totals[2]
        _check_schedule(sched, b, closest=True)
        assert sched.warp_tests < sched.ray_chunk_tests // 2
    assert int((hit.tri >= 0).sum()) > n // 4
    dist = torch.linspace(0.5, 9.0, n)
    for flag in (False, True):
        want, totals = _host_occluded(host_occluded_counted, b, o, d, dist,
                                      flag)
        occ, sched = kernels.occluded_bf8i_warp_plain(b, o, d, dist,
                                                      opaque_only=flag)
        assert torch.equal(occ, want) and 0 < int(occ.sum()) < n
        assert sched.leaf_visits == totals[2]
        _check_schedule(sched, b, closest=False)


def test_warp_schedule_on_dead_and_tail_lanes(host_traversal):
    """Lanes killed as the integrator kills them end at the root in the
    schedule too; 33 lanes leave a warp of one."""
    from pt_torch.render.integrator import _degenerate_masked
    meshes, seg_mesh, seg_t, _ = _inputs()
    b = tinst.build_instanced_bf8(meshes, seg_mesh, seg_t, device="cpu")
    o, d = (T(a) for a in _rays_at(seg_t, 33, 31))
    live = torch.arange(33) % 2 == 0
    od, dd, td = (a.contiguous() for a in
                  _degenerate_masked(b, o, d, 1e4, live))
    hit, sched = kernels.closest_bf8i_warp_plain(b, od, dd, td)
    want, totals = _host_closest(host_traversal, b, od, dd, td, False)
    _assert_bits_equal(hit, want)
    assert sched.node_visits == totals[0] and sched.warps == 2
    assert (hit.tri[~live] == -1).all() and torch.equal(hit.t[~live],
                                                        td[~live])
    assert int((hit.tri[live] >= 0).sum()) > 0


@pytest.mark.parametrize("leaf_retest", [True, False])
def test_warp_schedule_matches_pallas_kernels_within_budget(
        pallas_interpret, leaf_retest):
    """`pt`'s K5/K6 on the structure `pt` built, carried across by
    `convert.bf8_instanced`, against the warp schedule: both `leaf_retest`
    arms of the Pallas kernel, raw ids on one, opaque_only on the other."""
    meshes, seg_mesh, seg_t, _ = _inputs(alpha_mesh=1, lattice=True)
    j = dataclasses.replace(jinst.build_instanced_bf8(meshes, seg_mesh,
                                                      seg_t),
                            leaf_retest=leaf_retest)
    b = convert.bf8_instanced(_fields(j), device="cpu")
    n = 1024
    o, d = _rays_at(seg_t, n, 11)
    tmax = np.full(n, 1e4, np.float32)
    raw = not leaf_retest
    jh = jinst.packet_closest_bf8i(j, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tmax), 1e-5, raw_ids=raw)
    th, _ = kernels.closest_bf8i_warp_plain(b, T(o), T(d), T(tmax),
                                            raw_ids=raw)
    differ = th.tri.numpy() != np.asarray(jh.tri)
    assert differ.mean() <= 0.01, differ.mean()
    same = ~differ & (th.tri.numpy() >= 0)
    assert same.sum() > 300
    # Pallas' o', d' carry ~2^-16 relative error from the bf16 split
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                               rtol=1e-3)
    dist = np.random.default_rng(12).uniform(2, 14, n).astype(np.float32)
    jo = jinst.packet_occluded_bf8i(j, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(dist), 1e-5,
                                    opaque_only=leaf_retest)
    to, _ = kernels.occluded_bf8i_warp_plain(b, T(o), T(d), T(dist),
                                             opaque_only=leaf_retest)
    assert (to.numpy() != np.asarray(jo)).mean() <= 0.01
    assert 0 < to.sum() < n
