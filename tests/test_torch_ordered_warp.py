"""The warp schedule of the redesigned `closest_ordered`
(`csrc/ordered_warp_kernels.cu`) on the CPU, through its plain PyTorch
version (`kernels.closest_ordered_warp_plain`).

* The schedule (lanes walk their own stacks of node ids near child first,
  pause at the leaves whose pop retest passes, are grouped by warp and
  leaf, tested chunk by chunk with the kernels' reduction, resume) is
  bit-equal to the per-ray walk, the g++ build of `ordered_traverse.cuh`,
  and to `closest_ordered_plain`: t, u, v and ids, on Morton trees at
  blocks 64 and 128 and SAH trees at blocks 32, 64 and 1024, every third
  triangle alpha-tagged, with misses; its node visits and triangle tests
  are the counted per-ray walk's.
* An exact t tie across two leaves (the same triangles under two ids, one
  copy per leaf): the smaller id wins, as in the per-ray walk.
* Dead lanes (as the integrator kills them) and a warp of one lane.
* Against `pt`'s Pallas kernel in interpret mode (`packet_closest`, A7) it
  stays within the existing near-edge budget (at most 1% of rays differ).
* The CPU wrappers: `closest_ordered` and `closest_ordered_per_ray` run the
  plain version and launch nothing; both hold the stack bound.

The CUDA kernel itself is tested in tests/test_torch_gpu.py.
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
from pt_torch.accel import kernels
from pt_torch.accel import bvh8 as tbvh

from test_torch_accel import (CSRC, T, _fields, _random_rays, _random_tris,
                              pallas_interpret)  # noqa: F401
from test_torch_gpu import binary_leaf_tree

_HOST_SRC = r"""
#include "ordered_traverse.cuh"
extern "C" void host_ordered(
        const float* lo, const float* hi, const int32_t* miss,
        const int32_t* leaf, const float* pages, int n_top, int block,
        int cols, const float* o, const float* d, const float* tmax,
        float tmin, int n, float* t, int32_t* tri, float* u, float* v,
        unsigned long long* stats, uint8_t* node_seen, uint8_t* tri_seen) {
    v4::Tree tree{lo, hi, miss, leaf, pages, n_top, block, cols};
    for (int i = 0; i < n; ++i) {
        v4::Counts c{0, 0, node_seen, tri_seen};
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        ordered::closest<true>(tree, r, tmin, tmax[i], t + i, tri + i,
                               u + i, v + i, &c);
        stats[0] += c.nodes; stats[1] += c.tris;
    }
}
"""


@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    """The counted per-ray ordered walk of ordered_traverse.cuh, built for
    the host by g++ (no torch headers), with -ffp-contract=off so that it
    rounds as the -fmad=false CUDA build does."""
    tmp = tmp_path_factory.mktemp("ordered_warp_host")
    src = tmp / "ordered.cpp"
    src.write_text(_HOST_SRC)
    lib = tmp / "libordered.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{CSRC}", str(src), "-o",
                    str(lib)], check=True, capture_output=True, timeout=120)
    h = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.host_ordered.argtypes = [p] * 5 + [i, i, i, p, p, p, f, i] + [p] * 7
    return h


def _host_closest(host, tree, o, d, tmax):
    """The g++ per-ray walk, counted: (t, tri, u, v), [box tests, triangle
    tests]."""
    n = o.shape[0]
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    tri = torch.empty(n, dtype=torch.int32)
    wc = kernels.work_counts(tree)
    host.host_ordered(*kernels._tree_args_v4(tree), o.data_ptr(),
                      d.data_ptr(), tmax.data_ptr(), 1e-5, n, t.data_ptr(),
                      tri.data_ptr(), u.data_ptr(), v.data_ptr(),
                      *(a.data_ptr() for a in wc))
    return (t, tri, u, v), wc.totals.tolist()


def _assert_bits_equal(hit, want):
    t, tri, u, v = want
    assert torch.equal(hit.tri, tri)
    for a, b in ((hit.t, t), (hit.u, u), (hit.v, v)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _check_against_host(host, tree, o, d, tmax):
    """The schedule bit-equal to the host walk, with its work; what holds of
    any closest schedule: a group is one leaf's page, staged once, and
    every member is tested against every chunk. Returns (hit, sched)."""
    want, totals = _host_closest(host, tree, o, d, tmax)
    hit, sched = kernels.closest_ordered_warp_plain(tree, o, d, tmax)
    _assert_bits_equal(hit, want)
    assert [sched.node_visits, sched.tri_tests] == totals
    nc = tree.block // 32
    assert sched.leaf_boxes == 0
    assert sum(sched.lanes_per_group) == sched.groups == sched.leaves
    assert sched.groups <= sched.leaf_visits
    assert sched.ray_chunk_tests == sched.leaf_visits * nc
    assert sched.chunk_loads == sched.groups * nc
    assert 0 < sched.warp_tests <= sched.ray_chunk_tests
    assert sched.warps <= -(-o.shape[0] // 32)
    return hit, sched


def _tree(kind, block):
    """A seeded soup of max(2000, 6 * block) triangles (every third
    alpha-tagged) under a Morton tree or an SAH tree at leaves of
    `block`."""
    verts, tri = _random_tris(max(2000, 6 * block), seed=121)
    opaque = (np.arange(tri.shape[0]) % 3) != 0
    if kind == "morton":
        tree = tbvh.build_packet_bvh(T(verts), T(tri), block=block,
                                     tri_opaque=T(opaque))
    else:
        tree = tbvh.build_packet_bvh_sah(verts, tri, block=block,
                                         tri_opaque_np=opaque, device="cpu")
    assert tree.block == block and tree.depth <= kernels.ORDERED_STACK
    return tree


def _rays(n, seed):
    """Rays aimed into the soup, and every eighth pointed away from it."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-14, 14, (n, 3))
    d = rng.uniform(-8, 8, (n, 3)) - o
    d[::8] = o[::8]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(5, 40, n)
    return (T(o.astype(np.float32)), T(d.astype(np.float32)),
            T(tmax.astype(np.float32)))


@pytest.mark.parametrize("kind,block", [("morton", 64), ("morton", 128),
                                        ("sah", 32), ("sah", 64),
                                        ("sah", 1024)])
def test_warp_schedule_matches_per_ray_walk(host_walk, kind, block):
    """2,000 rays (no multiple of 32), with misses: the schedule's hits
    against the per-ray walk's and the plain version's, with the same box
    tests and triangle tests; alpha-tagged ids come out stripped."""
    tree = _tree(kind, block)
    n = 2000
    o, d, tmax = _rays(n, 122)
    hit, sched = _check_against_host(host_walk, tree, o, d, tmax)
    for a, b in zip(hit, kernels.closest_ordered_plain(tree, o, d, tmax)):
        assert torch.equal(a, b)
    assert sched.warps == -(-n // 32)
    hits = hit.tri >= 0
    assert n // 10 < int(hits.sum()) < n - n // 8
    assert bool((hit.t[~hits] == tmax[~hits]).all())
    assert int((hit.tri[hits] % 3 == 0).sum()) > 0       # alpha-tagged
    assert int((hit.tri[hits] & tbvh.ALPHA_TRI_BIT).sum()) == 0
    if block == 1024:
        assert sched.chunk_loads == 32 * sched.groups
    # leaves hold more than one lane now and then
    assert sched.leaf_visits > sched.groups


def test_warp_schedule_tie_across_leaves(host_walk):
    """The same 8 triangles in two leaves, under ids 8-15 in leaf 0 and 0-7
    in leaf 1 (boxes widened so that no pop retest culls), and an unshared
    grid in a third leaf: every hit on the pair ties exactly across leaves
    and groups, and the smaller id must win, bit-equal to the per-ray walk,
    whichever leaf each walk pops first."""
    import chip_smoke
    pos, _, _, tris = chip_smoke._wavy_grid(3)
    k = len(tris)
    corners = pos[tris]
    tree = binary_leaf_tree("cpu", [(corners, np.arange(k) + k),
                                    (corners, np.arange(k)),
                                    (corners + [2.5, 0, 0],
                                     np.arange(k) + 2 * k)], pad=0.5)
    n = 1024
    side = 32
    gx, gz = np.meshgrid(np.linspace(-0.9, 3.4, side),
                         np.linspace(-0.9, 0.9, side), indexing="ij")
    o = T(np.stack([gx.ravel(), np.full(n, 3.0), gz.ravel()], -1)
          .astype(np.float32))
    d = T(np.tile(np.asarray([[0.01, -1.0, 0.02]], np.float32), (n, 1)))
    tmax = torch.full((n,), 1e4)
    hit, sched = _check_against_host(host_walk, tree, o, d, tmax)
    on_pair = (hit.tri >= 0) & (hit.tri < 2 * k)
    assert int(on_pair.sum()) > n // 4
    assert int(hit.tri[on_pair].max()) < k           # the tie: ids 0-7
    assert int(((hit.tri >= 2 * k)).sum()) > n // 4
    assert sched.leaf_visits > sched.groups


def test_warp_schedule_on_dead_and_tail_lanes(host_walk):
    """Lanes killed as the integrator kills them end at the root in the
    schedule too (one box test each); 33 lanes leave a warp of one."""
    from pt_torch.render.integrator import _degenerate_masked
    tree = _tree("sah", 32)
    o, d, _ = _rays(33, 123)
    live = torch.arange(33) % 2 == 0
    od, dd, td = (a.contiguous() for a in
                  _degenerate_masked(tree, o, d, 1e4, live))
    hit, sched = _check_against_host(host_walk, tree, od, dd, td)
    assert sched.warps == 2
    assert (hit.tri[~live] == -1).all() and torch.equal(hit.t[~live],
                                                        td[~live])
    assert int((hit.tri[live] >= 0).sum()) > 0
    dead, _ = kernels.closest_ordered_warp_plain(
        tree, od[~live].contiguous(), dd[~live].contiguous(), td[~live])
    assert (dead.tri == -1).all()


def test_warp_schedule_matches_pallas_kernel_within_budget(pallas_interpret):
    """`pt`'s A7 (`packet_closest`) on the SAH tree `pt` built, carried
    across by `convert`, against the warp schedule."""
    verts, tri = _random_tris(1000, seed=124)
    opaque = (np.arange(1000) % 4) != 0
    jp = jbvh.build_packet_bvh_sah(verts, tri, block=32, max_leaves=8192,
                                   tri_opaque_np=opaque)
    tree = convert.packet_bvh(_fields(jp), device="cpu")
    n = 1024
    o, d = _random_rays(n, seed=125)
    tmax = np.full(n, 1e4, np.float32)
    jh = jarch.packet_closest(jp, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tmax), 1e-5)
    th, _ = kernels.closest_ordered_warp_plain(tree, T(o), T(d), T(tmax))
    differ = th.tri.numpy() != np.asarray(jh.tri)
    assert differ.mean() <= 0.01, differ.mean()
    same = ~differ & (th.tri.numpy() >= 0)
    assert same.sum() > 100
    # Pallas' o', d' carry ~2^-16 relative error from the bf16 split, which
    # t = -o'z/d'z amplifies on grazing rays
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                               rtol=1e-2)


def test_cpu_wrappers_run_the_plain_version_and_hold_the_stack_bound():
    """On CPU tensors `closest_ordered` (with and without `counts`) and its
    per-ray arm give the plain version's hits and launch nothing; a tree
    deeper than ORDERED_STACK raises in both and in the schedule."""
    tree = _tree("morton", 64)
    o, d, tmax = _rays(256, 126)
    want = kernels.closest_ordered_plain(tree, o, d, tmax)
    before = dict(kernels.launches)
    for got in (kernels.closest_ordered(tree, o, d, tmax),
                kernels.closest_ordered(tree, o, d, tmax,
                                        counts=kernels.work_counts(tree)),
                kernels.closest_ordered_per_ray(tree, o, d, tmax)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert kernels.launches == before
    tree._depth = kernels.ORDERED_STACK + 1
    for fn in (kernels.closest_ordered, kernels.closest_ordered_per_ray):
        with pytest.raises(ValueError, match="stack"):
            fn(tree, o, d, tmax)
    # a chain of D internal nodes, each with an internal left child and a
    # leaf on the right, all under one box: the near (left) child is pushed
    # last, so the stack grows by one a level, and the schedule raises
    # where a lane's stack would pass ORDERED_STACK entries. Preorder: the
    # chain 0..D-1, node D-1's left leaf D, then the right leaves of nodes
    # D-1, ..., 0 at 2D - i.
    D = kernels.ORDERED_STACK + 2
    n_top = 2 * D + 1
    k = np.arange(n_top)
    top_miss = np.where(k <= D, 2 * D - k + 1, k + 1).astype(np.int32)
    top_miss[0] = n_top
    top_leaf = np.where(k < D, -1, 0).astype(np.int32)
    box = np.tile(np.asarray([[-1.0, -1.0, -1.0]], np.float32), (n_top, 1))
    deep = tbvh.PacketBVH(top_lo=T(box), top_hi=T(-box),
                          top_miss=T(top_miss), top_leaf=T(top_leaf),
                          pages=tree.pages[:1].contiguous(), n_top=n_top,
                          block=tree.block)
    far = torch.full((1,), 1e4)
    with pytest.raises(ValueError, match="stack"):
        kernels.closest_ordered_warp_plain(deep, T(np.asarray(
            [[0.0, 0.0, -5.0]], np.float32)), T(np.asarray(
                [[0.0, 0.0, 1.0]], np.float32)), far)
