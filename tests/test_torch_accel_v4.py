"""The animated path's accel layer of the PyTorch port: the Morton
`PacketBVH` rebuild and the v4 kernels' plain versions and per-ray code.

* `_topology`, `morton_codes` and `build_packet_bvh` against `pt`'s on the
  same input: the triangle order (page ids), skip links, leaf ids and node
  bounds are bit-equal. The f32 Woop rows are bit-equal on about 98% of
  entries and otherwise differ in their last bits where the terms of a cross
  product cancel (XLA's CPU code rounds those products differently), so
  they are held to 1e-5 of the triangle's largest entry, and the traversal
  results are held exactly instead (next point).
* The plain K3/K4 and `csrc/v4_traverse.cuh`, compiled for the host with
  g++, match `pt.accel.intersect.intersect_brute` with exact ids on random
  non-shared-edge triangles, over the port's tree and over `pt`'s tree
  converted; trees with empty (padding) subtrees and single-leaf trees
  included. Empty subtrees are never entered and degenerate lanes end at the
  root.
* Against the Pallas kernels `packet_closest_v4` / `packet_occluded_v4` in
  interpret mode at most 1% of rays may disagree (bf16 leaf product).

The CUDA kernels themselves are tested in tests/test_torch_gpu.py.
"""

import ctypes
import pathlib
import subprocess

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pt.accel import lbvh as jlbvh
from pt.accel import pallas_bvh as jbvh
from pt.accel.intersect import intersect_brute as j_brute
from pt_torch import convert
from pt_torch.accel import bvh8 as tbvh
from pt_torch.accel import kernels
from pt_torch.accel import lbvh as tlbvh

from test_torch_accel import (T, _fields, _heightfield_soup, _random_rays,
                              _random_tris, pallas_interpret)  # noqa: F401

CSRC = pathlib.Path(kernels.__file__).resolve().parent / "csrc"

SOUPS = {
    "random1000": lambda: _random_tris(1000),          # 16 full leaves
    "padded1100": lambda: _random_tris(1100, seed=5),  # 32 leaves, 14 empty
    "single30": lambda: _random_tris(30, seed=6),      # one leaf, n_top = 1
    "heightfield": lambda: _heightfield_soup(32),
}


def _morton(verts, tri, opaque=None):
    return tbvh.build_packet_bvh(
        T(verts), T(tri), tri_opaque=None if opaque is None else T(opaque))


def _page_ids(pages, block):
    return np.ascontiguousarray(
        np.asarray(pages)[:, 0, 6 * block:7 * block]).view(np.int32)


# ----------------------------------------------------------- the rebuild

@pytest.mark.parametrize("n_leaves", [1, 2, 8, 64, 2048])
def test_topology_matches_pt(n_leaves):
    got, want = tlbvh._topology(n_leaves), jlbvh._topology(n_leaves)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[1][0] == 2 * n_leaves - 1        # the end sentinel: n_top
    dev = tlbvh.topology_tensors(n_leaves, torch.device("cpu"))
    np.testing.assert_array_equal(dev[1].numpy(), want[1])
    assert dev[0].dtype == torch.int64 and dev[2].dtype == torch.int32


def test_morton_codes_match_pt():
    rng = np.random.default_rng(0)
    c = rng.uniform(-7, 9, (5000, 3)).astype(np.float32)
    c[:3] = [[-7, -7, -7], [9, 9, 9], [1, 1, 1]]
    lo, hi = c.min(0), c.max(0)
    got = tlbvh.morton_codes(T(c), T(lo), T(hi))
    want = jlbvh.morton_codes(jnp.asarray(c), jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))
    flat = np.zeros((4, 3), np.float32)          # zero extent: 1e-9 clamp
    got = tlbvh.morton_codes(T(flat), T(flat[0]), T(flat[0]))
    assert got.tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("soup", list(SOUPS))
def test_morton_build_matches_pt(soup):
    verts, tri = SOUPS[soup]()
    opaque = (np.arange(tri.shape[0]) % 3) != 0
    tp = _morton(verts, tri, opaque)
    jp = jbvh.build_packet_bvh(jnp.asarray(verts), jnp.asarray(tri),
                               tri_opaque=jnp.asarray(opaque))
    assert (tp.n_top, tp.block) == (jp.n_top, jp.block)
    assert tbvh.morton_leaf_shape(tri.shape[0]) == (jp.pages.shape[0],
                                                    jp.block)
    blk = tp.block
    # the triangle order, with its alpha tags and padding
    np.testing.assert_array_equal(_page_ids(tp.pages.numpy(), blk),
                                  _page_ids(jp.pages, blk))
    for name in ("top_miss", "top_leaf", "top_lo", "top_hi"):
        g, w = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    got = tp.pages.numpy()[:, :, :6 * blk]
    want = np.asarray(jp.pages)[:, :, :6 * blk]
    assert tp.pages.shape == jp.pages.shape
    assert (got == want).mean() > 0.95
    scale = np.abs(want).reshape(want.shape[0], 8, 6, blk).max(axis=(1, 2))
    err = np.abs(got - want).reshape(want.shape[0], 8, 6, blk).max(axis=(1, 2))
    assert (err <= 1e-5 * np.maximum(scale, 1e-30)).all(), \
        float((err / np.maximum(scale, 1e-30)).max())
    # pt's tree converted into the port's container keeps its bits
    conv = convert.packet_bvh(_fields(jp), device="cpu")
    assert torch.equal(conv.top_lo, tp.top_lo)
    assert torch.equal(conv.top_miss, tp.top_miss)
    assert conv.n_top == tp.n_top and conv.block == tp.block


def test_morton_build_block_doubles_past_max_leaves():
    assert tbvh.morton_leaf_shape(99_458) == (2048, 64)
    assert tbvh.morton_leaf_shape(64 * 8192) == (8192, 64)
    assert tbvh.morton_leaf_shape(64 * 8192 + 1) == (8192, 128)
    assert tbvh.morton_leaf_shape(1) == (1, 64)
    assert tbvh.morton_leaf_shape(100, block=40) == (2, 64)


def test_empty_subtrees_are_far_point_boxes():
    verts, tri = SOUPS["padded1100"]()
    tp = _morton(verts, tri)
    lo, hi = tp.top_lo.numpy(), tp.top_hi.numpy()
    empty = (lo == 1e30).all(axis=1)
    assert empty.sum() > 0 and (hi[empty] == 1e30).all()
    assert np.isfinite(lo).all() and np.isfinite(hi).all()
    assert (lo[~empty] <= hi[~empty]).all() and not empty[0]
    # the leaves of empty subtrees hold only padding
    leaf = tp.top_leaf.numpy()
    ids = _page_ids(tp.pages.numpy(), tp.block)
    assert (ids[leaf[empty & (leaf >= 0)]] == -1).all()


# ------------------------------------------------- plain vs brute oracle

def _brute(verts, tri, o, d, tmax=None):
    kw = {} if tmax is None else {"tmax": jnp.asarray(tmax)}
    return j_brute(jnp.asarray(verts), jnp.asarray(tri), jnp.asarray(o),
                   jnp.asarray(d), **kw)


@pytest.mark.parametrize("soup", ["random1000", "padded1100", "single30"])
@pytest.mark.parametrize("tree", ["port", "pt"])
def test_plain_v4_matches_brute(soup, tree):
    verts, tri = SOUPS[soup]()
    if tree == "port":
        pb = _morton(verts, tri)
    else:
        pb = convert.packet_bvh(_fields(jbvh.build_packet_bvh(
            jnp.asarray(verts), jnp.asarray(tri))), device="cpu")
    o, d = _random_rays(512)
    tmax = np.random.default_rng(1).uniform(5, 40, 512).astype(np.float32)
    got = kernels.closest_v4(pb, T(o), T(d), T(tmax))
    want = _brute(verts, tri, o, d, tmax)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5,
                               atol=1e-5)
    hit = got.tri.numpy() >= 0
    assert hit.sum() > 0 or soup == "single30"
    np.testing.assert_array_equal(got.t.numpy()[~hit], tmax[~hit])
    np.testing.assert_allclose(got.u.numpy()[hit], np.asarray(want.u)[hit],
                               atol=1e-4)
    np.testing.assert_allclose(got.v.numpy()[hit], np.asarray(want.v)[hit],
                               atol=1e-4)
    dist = np.full(512, 8.0, np.float32)
    occ = kernels.occluded_v4(pb, T(o), T(d), T(dist))
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(_brute(verts, tri, o, d, dist).is_hit))


def test_plain_v4_strips_alpha_bit_and_occludes_on_alpha():
    verts, tri = _random_tris(400, seed=8)
    opaque = (np.arange(400) % 2) == 0
    pb = _morton(verts, tri, opaque)
    ids = _page_ids(pb.pages.numpy(), pb.block)
    assert ((ids >= 0) & (ids & tbvh.ALPHA_TRI_BIT != 0)).sum() == 200
    o, d = _random_rays(1024, seed=9)
    far = torch.full((1024,), 1e4)
    h = kernels.closest_v4(pb, T(o), T(d), far)
    want = _brute(verts, tri, o, d)
    np.testing.assert_array_equal(h.tri.numpy(), np.asarray(want.tri))
    assert int(h.tri.max()) < 400
    # K4 has no opaque_only: an alpha-tagged triangle occludes too
    occ = kernels.occluded_v4(pb, T(o), T(d), far)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want.is_hit))


def test_static_sah_tree_goes_through_v4():
    """The static fallback: a binary SBVH tree (no BF8 collapse) is walked
    by K3/K4 as well."""
    verts, tri = _random_tris(700, seed=14)
    pb = tbvh.build_packet_bvh_sah(verts, tri, spatial=True, device="cpu")
    assert int(pb.top_miss[0]) == pb.n_top
    o, d = _random_rays(512, seed=15)
    got = kernels.closest_v4(pb, T(o), T(d), torch.full((512,), 1e4))
    np.testing.assert_array_equal(got.tri.numpy(),
                                  np.asarray(_brute(verts, tri, o, d).tri))


def test_v4_wrapper_rejects_bad_input():
    import dataclasses
    verts, tri = _random_tris(100)
    pb = _morton(verts, tri)
    o, d = (T(a) for a in _random_rays(16))
    tmax = torch.full((16,), 1e4)
    with pytest.raises(TypeError):
        kernels.closest_v4(pb, o.double(), d, tmax)
    with pytest.raises(ValueError):
        kernels.closest_v4(pb, o, d, torch.full((15,), 1e4))
    with pytest.raises(ValueError):
        kernels.occluded_v4(pb, o.t().contiguous().t(), d, tmax)
    bad = dataclasses.replace(pb, top_miss=pb.top_miss.long())
    with pytest.raises(TypeError):
        kernels._tree_args_v4(bad)
    with pytest.raises(ValueError):
        kernels._counts_ptrs(kernels.work_counts(_morton(*_random_tris(300))),
                             pb)
    c = kernels.work_counts(pb)
    assert c.totals.shape == (2,) and c.node_seen.shape == (pb.n_top,)


# ---------------------------------------------- against the Pallas kernels

def test_plain_v4_matches_pallas_kernels_within_budget(pallas_interpret):
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
    th = kernels.closest_v4(pb, T(o), T(d), T(tmax))
    differ = th.tri.numpy() != np.asarray(jh.tri)
    assert differ.mean() <= 0.01, differ.mean()
    assert (th.tri.numpy() >= 0).sum() > 50
    same = ~differ & (th.tri.numpy() >= 0)
    # Pallas' o', d' carry ~2^-16 relative error from the bf16 split, which
    # t = -o'z/d'z amplifies on grazing rays
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                               rtol=1e-2)
    jo = jbvh.packet_occluded_v4(jp, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(dist), 1e-5)
    to = kernels.occluded_v4(pb, T(o), T(d), T(dist))
    assert (to.numpy() != np.asarray(jo)).mean() <= 0.01


# --------------------------------------- the kernels' per-ray code, on host

_HOST_SRC = r"""
#include "v4_traverse.cuh"
extern "C" {
void host_closest(const float* lo, const float* hi, const int32_t* miss,
                  const int32_t* leaf, const float* pages, int n_top,
                  int block, int cols, const float* o, const float* d,
                  const float* tmax, float tmin, int n, float* t,
                  int32_t* tri, float* u, float* v, unsigned long long* stats,
                  uint8_t* node_seen, uint8_t* tri_seen) {
    v4::Tree tree{lo, hi, miss, leaf, pages, n_top, block, cols};
    for (int i = 0; i < n; ++i) {
        v4::Counts c{0, 0, node_seen, tri_seen};
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        v4::closest<true>(tree, r, tmin, tmax[i], t + i, tri + i, u + i,
                          v + i, &c);
        stats[0] += c.nodes; stats[1] += c.tris;
    }
}
void host_occluded(const float* lo, const float* hi, const int32_t* miss,
                   const int32_t* leaf, const float* pages, int n_top,
                   int block, int cols, const float* o, const float* d,
                   const float* dist, float tmin, int n, uint8_t* out) {
    v4::Tree tree{lo, hi, miss, leaf, pages, n_top, block, cols};
    for (int i = 0; i < n; ++i) {
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        out[i] = v4::occluded<false>(tree, r, tmin, dist[i], nullptr);
    }
}
}
"""


@pytest.fixture(scope="module")
def host_traversal(tmp_path_factory):
    """v4_traverse.cuh built for the host by g++ (no torch headers), with
    -ffp-contract=off so it rounds as the -fmad=false CUDA build does."""
    tmp = tmp_path_factory.mktemp("v4_host")
    src = tmp / "v4_host.cpp"
    src.write_text(_HOST_SRC)
    lib = tmp / "libv4_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{CSRC}", str(src), "-o",
                    str(lib)], check=True, capture_output=True, timeout=120)
    h = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.host_closest.argtypes = [p] * 5 + [i, i, i, p, p, p, f, i] + [p] * 7
    h.host_occluded.argtypes = [p] * 5 + [i, i, i, p, p, p, f, i, p]
    return h


def _host_closest(h, pb, o, d, tmax):
    n = o.shape[0]
    t = torch.empty(n)
    tri = torch.empty(n, dtype=torch.int32)
    u, v = torch.empty(n), torch.empty(n)
    counts = kernels.work_counts(pb)
    h.host_closest(*kernels._tree_args_v4(pb), o.data_ptr(), d.data_ptr(),
                   tmax.data_ptr(), 1e-5, n, t.data_ptr(), tri.data_ptr(),
                   u.data_ptr(), v.data_ptr(), *(c.data_ptr() for c in counts))
    return (t, tri, u, v), counts


@pytest.mark.parametrize("soup", list(SOUPS))
def test_host_traversal_matches_plain(host_traversal, soup):
    verts, tri = SOUPS[soup]()
    if soup == "heightfield":
        rng = np.random.default_rng(23)
        o = rng.uniform(-11, 11, (2048, 3)).astype(np.float32)
        o[:, 1] = rng.uniform(1.5, 6, 2048)
        d = rng.normal(size=(2048, 3))
        d[:, 1] = -np.abs(d[:, 1])
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    else:
        o, d = _random_rays(2048, seed=22)
    pb = _morton(verts, tri, (np.arange(tri.shape[0]) % 2) == 0)
    n = o.shape[0]
    ot, dt = T(o), T(d)
    tmax = torch.full((n,), 1e4)
    (t, tri_out, u, v), counts = _host_closest(host_traversal, pb, ot, dt,
                                               tmax)
    plain = kernels.closest_v4_plain(pb, ot, dt, tmax)
    assert torch.equal(tri_out, plain.tri)
    # same arithmetic in the same order: bit-equal t/u/v
    assert torch.equal(t, plain.t) and torch.equal(u, plain.u)
    assert torch.equal(v, plain.v)
    if soup != "single30":
        assert int((plain.tri >= 0).sum()) > n // 20
    nodes, tris = counts.totals.tolist()
    assert nodes >= n and tris < n * tri.shape[0]
    ids = pb.pages[:, 0, 6 * pb.block:7 * pb.block].contiguous()
    valid = ids.view(torch.int32).reshape(-1) >= 0
    assert counts.node_seen[0] == 1
    assert 0 < int(counts.tri_seen.sum()) <= int(valid.sum())
    assert not bool(counts.tri_seen.bool()[~valid].any())
    # no ray enters a subtree that holds only padding
    empty = (pb.top_lo == 1e30).all(dim=1)
    below = empty & ~_roots_of_empty(pb, empty)
    assert not bool(counts.node_seen.bool()[below].any())
    assert bool(below.any()) == (soup == "padded1100")
    dist = torch.as_tensor(np.random.default_rng(24).uniform(
        0.5, 20, n).astype(np.float32))
    out = torch.empty(n, dtype=torch.uint8)
    host_traversal.host_occluded(*kernels._tree_args_v4(pb), ot.data_ptr(),
                                 dt.data_ptr(), dist.data_ptr(), 1e-5, n,
                                 out.data_ptr())
    assert torch.equal(out.bool(),
                       kernels.occluded_v4_plain(pb, ot, dt, dist))


def _roots_of_empty(pb, empty):
    """Roots of the empty subtrees: an empty node that is reached from a
    non-empty parent is slab-tested (and missed); what lies below it must
    never be visited."""
    n = pb.n_top
    miss = pb.top_miss.numpy()
    emp = empty.numpy()
    first = np.zeros(n, bool)
    i = 0
    while i < n:
        if emp[i]:
            first[i] = True
            i = miss[i]          # skip the whole empty subtree
        else:
            i += 1
    return torch.as_tensor(first)


def test_degenerate_lanes_end_at_the_root(host_traversal):
    """Lanes killed as the integrator kills them (origin beyond the root
    box, +x, tmax = TMIN) visit the root and nothing else."""
    from pt_torch.render.integrator import _degenerate_masked
    verts, tri = SOUPS["padded1100"]()
    pb = _morton(verts, tri)
    o, d = (T(a) for a in _random_rays(256, seed=30))
    live = torch.zeros(256, dtype=torch.bool)
    od, dd, td = _degenerate_masked(pb, o, d, 1e4, live)
    (t, tri_out, _, _), counts = _host_closest(host_traversal, pb,
                                               od.contiguous(),
                                               dd.contiguous(), td)
    assert counts.totals.tolist() == [256, 0]
    assert int(counts.node_seen.sum()) == 1 and (tri_out == -1).all()
    assert torch.equal(t, td)
    plain = kernels.closest_v4_plain(pb, od.contiguous(), dd.contiguous(), td)
    assert (plain.tri == -1).all()
