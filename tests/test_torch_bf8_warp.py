"""The warp schedule of the redesigned K1 and closest_v6
(`csrc/bf8_warp_kernels.cu`) on the CPU, through its plain PyTorch versions
(`kernels.closest_bf8_warp_plain` / `closest_v6_warp_plain`).

* The schedule (lanes walk their own stacks, K1 pushing far-first by tnear
  and v6 in its node's static order for the ray's octant, pause at pending
  leaves, are grouped by warp and leaf, tested chunk by chunk with the
  kernels' reduction, resume) is bit-equal to the per-ray walk, the g++
  build of `bf8_traverse.cuh` / `v6_traverse.cuh`, at blocks 32, 64 and
  128: t, u, v and ids; its node visits, leaf-box retests and triangle
  tests are the counted per-ray walk's.
* Sparse leaves (8 triangles padded out to 32 columns) under groups of more
  rays than columns: the warp steps through the columns.
* An exact t tie across two leaves (the same triangles under two ids, one
  copy per leaf): the smaller id wins, as in the per-ray walk.
* Dead lanes (as the integrator kills them) and a warp of one lane.
* Against `pt`'s Pallas kernels in interpret mode (`packet_closest_bf8`,
  `packet_closest_v6`) it stays within the existing near-edge budget (at
  most 1% of rays differ, bf16 leaf product).
* Every BF8 and BF8V6 the port builds has pages the warp kernels can stage
  (block % 32 == 0, page width % 4 == 0, 16-byte aligned): the static SBVH
  at block 32 with its alpha subset trees, the block doubling, a flattened
  instanced scene with alpha cards, the Courtyard's flat path and
  `build_bf8_v6`.

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
                              _random_rays, _random_tris,
                              pallas_interpret)  # noqa: F401
from test_torch_gpu import leaf_tree, sparse_leaf_rays, sparse_leaf_trees

WALKS = {"bf8": "closest_bf8", "v6": "closest_v6"}

_HOST_SRC = r"""
#include "v6_traverse.cuh"
extern "C" {
void host_bf8(const float* c_lo, const float* c_hi, const int32_t* c_ent,
              const float* l_lo, const float* l_hi, const float* pages,
              int block, int cols, const float* o, const float* d,
              const float* tmax, float tmin, int n, float* t, int32_t* tri,
              float* u, float* v, unsigned long long* stats,
              uint8_t* node_seen, uint8_t* tri_seen) {
    bf8::Tree tree{c_lo, c_hi, c_ent, l_lo, l_hi, pages, block, cols};
    for (int i = 0; i < n; ++i) {
        bf8::Counts c{0, 0, 0, node_seen, tri_seen};
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        bf8::closest<true>(tree, r, tmin, tmax[i], t + i, tri + i, u + i,
                           v + i, &c);
        stats[0] += c.nodes; stats[1] += c.leaf_boxes; stats[2] += c.tris;
    }
}
void host_v6(const float* u_lo, const float* u_hi, const int32_t* c_ent,
             const int32_t* c_order, const float* pages, int n8, int block,
             int cols, const float* o, const float* d, const float* tmax,
             float tmin, int n, float* t, int32_t* tri, float* u, float* v,
             unsigned long long* stats, uint8_t* node_seen,
             uint8_t* tri_seen) {
    v6::Tree tree{u_lo, u_hi, c_ent, c_order, pages, n8, block, cols};
    for (int i = 0; i < n; ++i) {
        bf8::Counts c{0, 0, 0, node_seen, tri_seen};
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        v6::closest<true>(tree, r, tmin, tmax[i], t + i, tri + i, u + i,
                          v + i, &c);
        stats[0] += c.nodes; stats[1] += c.leaf_boxes; stats[2] += c.tris;
    }
}
}
"""


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    """The counted per-ray closest walks of bf8_traverse.cuh (K1) and
    v6_traverse.cuh (closest_v6), built for the host by g++ (no torch
    headers), with -ffp-contract=off so that they round as the -fmad=false
    CUDA build does."""
    tmp = tmp_path_factory.mktemp("bf8_warp_host")
    src = tmp / "walks.cpp"
    src.write_text(_HOST_SRC)
    lib = tmp / "libwalks.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{CSRC}", str(src), "-o",
                    str(lib)], check=True, capture_output=True, timeout=120)
    h = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.host_bf8.argtypes = [p] * 6 + [i, i, p, p, p, f, i] + [p] * 7
    h.host_v6.argtypes = [p] * 5 + [i, i, i, p, p, p, f, i] + [p] * 7
    return h


def _host_closest(host, walk, tree, o, d, tmax):
    """The g++ per-ray walk `walk`, counted: (t, tri, u, v), [node visits,
    leaf-box retests, triangle tests]."""
    n = o.shape[0]
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    tri = torch.empty(n, dtype=torch.int32)
    wc = kernels.work_counts(tree)
    fn, args = ((host.host_bf8, kernels._tree_args(tree)) if walk == "bf8"
                else (host.host_v6, kernels._tree_args_v6(tree)))
    fn(*args, o.data_ptr(), d.data_ptr(), tmax.data_ptr(), 1e-5, n,
       t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
       *(a.data_ptr() for a in wc))
    return (t, tri, u, v), wc.totals.tolist()


def _schedule(walk, tree, o, d, tmax):
    return getattr(kernels, WALKS[walk] + "_warp_plain")(tree, o, d, tmax)


def _assert_bits_equal(hit, want):
    t, tri, u, v = want
    assert torch.equal(hit.tri, tri)
    for a, b in ((hit.t, t), (hit.u, u), (hit.v, v)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _check_against_host(host, walk, tree, o, d, tmax):
    """The schedule bit-equal to the host walk, with its work; what holds of
    any closest schedule: a group is one leaf's page, staged once, and
    every member is tested against every chunk. Returns (hit, sched)."""
    want, totals = _host_closest(host, walk, tree, o, d, tmax)
    hit, sched = _schedule(walk, tree, o, d, tmax)
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


def _trees(soup, block):
    """An SBVH BF8 tree of `soup` at leaves of `block` (every third
    triangle alpha-tagged) and its BF8V6."""
    verts, tri = (_random_tris(700 * block // 32, seed=91)
                  if soup == "random" else _heightfield_soup(32))
    opaque = (np.arange(tri.shape[0]) % 3) != 0
    b8 = tbvh.build_bf8(tbvh.build_packet_bvh_sah(
        verts, tri, block=block, max_leaves=8192, tri_opaque_np=opaque,
        spatial=True, device="cpu"))
    assert b8.block == block
    return {"bf8": b8, "v6": archive.bf8_v6_of(b8)}


def _soup_rays(soup, n):
    rng = np.random.default_rng(93)
    if soup == "random":                          # aimed into the soup
        o = rng.uniform(-12, 12, (n, 3))
        d = rng.uniform(-8, 8, (n, 3)) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return T(o.astype(np.float32)), T(d.astype(np.float32))
    o = rng.uniform(-11, 11, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(1.5, 6, n)
    d = rng.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return T(o), T(d)


@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("soup,block", [("random", 32), ("random", 64),
                                        ("random", 128), ("heightfield", 32)])
def test_warp_schedule_matches_per_ray_walk(host_walks, walk, soup, block):
    """A seeded soup (SBVH at leaves of `block`) and the Heightfield's SBVH
    at block 32, 2,000 rays (no multiple of 32): the schedule's hits
    against the per-ray walk's, with the same node visits, leaf-box
    retests and triangle tests."""
    tree = _trees(soup, block)[walk]
    n = 2000
    o, d = _soup_rays(soup, n)
    tmax = T(np.random.default_rng(94).uniform(5, 40, n).astype(np.float32))
    hit, sched = _check_against_host(host_walks, walk, tree, o, d, tmax)
    assert sched.warps == -(-n // 32)
    assert int((hit.tri >= 0).sum()) > n // 10
    assert int(((hit.tri >= 0) & (tmax < 1e4)).sum()) > 0
    # leaves hold more than one lane now and then
    assert sched.leaf_visits > sched.groups


@pytest.mark.parametrize("walk", list(WALKS))
def test_warp_schedule_on_sparse_leaves(host_walks, walk):
    """Leaves of 8 triangles padded out to 32 columns under coherent rays:
    leaf groups hold more rays than columns, so the warp steps through the
    columns (`warp_tests` below `ray_chunk_tests`); the hits stay the
    per-ray walk's."""
    tree = sparse_leaf_trees("cpu")[0 if walk == "bf8" else 1]
    n = 4096
    o, d = sparse_leaf_rays(n, "cpu")
    tmax = torch.full((n,), 1e4)
    hit, sched = _check_against_host(host_walks, walk, tree, o, d, tmax)
    # a group steps through at most its leaf's 8 columns
    assert sched.warp_tests <= 8 * sched.groups
    assert sched.warp_tests < sched.ray_chunk_tests // 2
    assert int((hit.tri >= 0).sum()) > n // 4
    assert bool(((hit.tri[hit.tri >= 0] & tbvh.ALPHA_TRI_BIT) == 0).all())


@pytest.mark.parametrize("walk", list(WALKS))
def test_warp_schedule_tie_across_leaves(host_walks, walk):
    """The same 8 triangles in two leaves, under ids 8-15 in leaf 0 and 0-7
    in leaf 1 (boxes widened so that neither retest culls), and an unshared
    grid in a third leaf: every hit on the pair ties exactly across leaves
    and groups, and the smaller id must win, bit-equal to the per-ray walk,
    whichever leaf each walk pops first."""
    import chip_smoke
    pos, _, _, tris = chip_smoke._wavy_grid(3)
    k = len(tris)
    corners = pos[tris]
    none = np.zeros(k, bool)
    tree = leaf_tree("cpu", [(corners, np.arange(k) + k, none),
                             (corners, np.arange(k), none),
                             (corners + [2.5, 0, 0], np.arange(k) + 2 * k,
                              none)], pad=0.5)[0 if walk == "bf8" else 1]
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


@pytest.mark.parametrize("walk", list(WALKS))
def test_warp_schedule_on_dead_and_tail_lanes(host_walks, walk):
    """Lanes killed as the integrator kills them end at the root in the
    schedule too; 33 lanes leave a warp of one."""
    from pt_torch.render.integrator import _degenerate_masked
    tree = _trees("random", 32)[walk]
    o, d = _soup_rays("random", 33)
    live = torch.arange(33) % 2 == 0
    od, dd, td = (a.contiguous() for a in
                  _degenerate_masked(tree, o, d, 1e4, live))
    hit, sched = _check_against_host(host_walks, walk, tree, od, dd, td)
    assert sched.warps == 2
    assert (hit.tri[~live] == -1).all() and torch.equal(hit.t[~live],
                                                        td[~live])
    assert int((hit.tri[live] >= 0).sum()) > 0


@pytest.mark.parametrize("walk", list(WALKS))
def test_warp_schedule_matches_pallas_kernels_within_budget(
        pallas_interpret, walk):
    """`pt`'s K1 (`packet_closest_bf8`) and v6 (`packet_closest_v6`) on the
    structures `pt` built, carried across by `convert`, against the warp
    schedule."""
    verts, tri = _random_tris(1000, seed=95)
    opaque = (np.arange(1000) % 4) != 0
    jp = jbvh.build_packet_bvh_sah(verts, tri, block=32, max_leaves=8192,
                                   tri_opaque_np=opaque, spatial=True)
    if walk == "bf8":
        j = jbvh.build_bf8(jp)
        tree = convert.bf8_bvh(_fields(j), device="cpu")
        packet = jbvh.packet_closest_bf8
    else:
        j = jarch.build_bf8_v6(jp)
        tree = convert.bf8_v6(_fields(j), device="cpu")
        packet = jarch.packet_closest_v6
    n = 1024
    o, d = _random_rays(n, seed=96)
    tmax = np.full(n, 1e4, np.float32)
    jh = packet(j, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), 1e-5)
    th, _ = _schedule(walk, tree, T(o), T(d), T(tmax))
    differ = th.tri.numpy() != np.asarray(jh.tri)
    assert differ.mean() <= 0.01, differ.mean()
    same = ~differ & (th.tri.numpy() >= 0)
    assert same.sum() > 100
    # Pallas' o', d' carry ~2^-16 relative error from the bf16 split, which
    # t = -o'z/d'z amplifies on grazing rays
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                               rtol=1e-2)


def _stageable(tree, what):
    assert tree.block % 32 == 0, what
    assert tree.pages.shape[-1] % 4 == 0, what
    assert tree.pages.data_ptr() % 16 == 0, what
    assert tree.pages.is_contiguous(), what
    kernels._check_warp_pages(tree)


def test_bf8_builders_give_stageable_pages():
    """Every path that builds a BF8BVH or a BF8V6 gives pages the warp
    kernels can stage: the static SBVH at block 32 with its opaque and
    alpha subset trees (the static alpha variant), the block doubling of a
    tree over pt's node budget, a flattened instanced scene with alpha
    cards, the Courtyard's flat path (instancing "flatten", as "auto" takes
    at detail 1.0) and `build_bf8_v6` (`swap_in_bf8_v6`)."""
    import chip_smoke
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.renderer import Renderer
    from pt_torch.scene.examples import make_heightfield_scene
    from pt_torch.scene.standin import make_courtyard_scene
    ns = chip_smoke.port_namespace()
    scenes = {"static alpha variant":
              lambda: chip_smoke.build_animated_scene(ns, 16, 60,
                                                      animate=False),
              "flattened instances with alpha cards":
              lambda: chip_smoke.build_instanced_scene(ns, 16, 12, alpha=True),
              "Courtyard flat": lambda: make_courtyard_scene(0.1, 0.02)}
    for what, make in scenes.items():
        r = Renderer(PathTracingSettings(), device="cpu",
                     instancing="flatten")
        r.set_scene(make(), stream_textures=False)
        r._ensure_accel()
        sp = r.accel.alpha_split
        assert sp is not None, what
        for name, tree in (("full", r.accel.bvh), ("opaque", sp.bvh_opaque),
                           ("alpha", sp.bvh_alpha)):
            assert type(tree).__name__ == "BF8BVH", (what, name)
            _stageable(tree, f"{what}, {name} tree")
    verts, tri = _random_tris(3000, seed=97)
    pb = tbvh.build_packet_bvh_sah(verts, tri, block=32, max_leaves=32,
                                   spatial=True, device="cpu")
    assert pb.block > 32                              # doubled
    _stageable(tbvh.build_bf8(pb), "block doubling")
    _stageable(archive.build_bf8_v6(pb), "block doubling, BF8V6")
    r = Renderer(PathTracingSettings(), device="cpu")
    r.set_scene(make_heightfield_scene(16), stream_textures=False)
    r._ensure_accel()
    assert r.accel.bvh.block == 32
    _stageable(r.accel.bvh, "static SBVH")
    v6, _ = archive.swap_in_bf8_v6(r)
    _stageable(v6, "swap_in_bf8_v6")
