"""The archive slice of the PyTorch port against `pt` on the CPU.

* `build_bf8_v6` gives a structure array-equal to
  `pt.accel.pallas_bvh_archive.build_bf8_v6` on the same input (unified
  bounds, child entries, octant push orders, pages, sizes, root box), and
  `convert.bf8_v6` carries `pt`'s structure across bit for bit; every packed
  push order decodes to a permutation of the 8 children, farthest first
  along the octant's diagonal (bit 4: x < 0, bit 2: y < 0, bit 1: z < 0).
* The ten entry points of `pt_torch.accel.archive` (on the CPU: their
  kernels' plain versions) give exact ids against the f32 brute oracle on
  random non-shared-edge triangles, and differ from `pt`'s Pallas kernel of
  the same name, run in interpret mode, on at most 1% of rays (the Pallas
  leaf test's bf16 passes drop near-edge hits, ROADMAP §2).
* `csrc/ordered_traverse.cuh` and `csrc/v6_traverse.cuh`, compiled for the
  host with g++, walk the same trees (the v6 walk with one and with two pops
  per iteration, and v7's leaf-queue walk) bit-equal to the plain versions;
  dead lanes, as the integrator degenerates them, end at the root. The
  leaf-queue walk with a window of 1 does the v6 walk's work exactly, and
  with a wider window tests more triangles.
* Each entry point counts its calls, and on the CPU no launch.
* The stack bounds raise; `_coherence_keys` is bit-equal to `pt`'s.
* The integrator routes a `BF8V6` to `closest_v6` / `occluded_v6`, and a
  32² Heightfield film through it is within MSE 1e-3 of `pt`'s film (brute
  backend).
* `pt_torch.benches.bvh_kernels` and `.widesub_ab` on the CPU (1,024 rays,
  Heightfield n=16) find no oracle mismatch.

The CUDA kernels themselves are tested in tests/test_torch_gpu.py.
"""

import ctypes
import dataclasses
import pathlib
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
from pt_torch.accel.intersect import intersect_brute as t_brute

from test_torch_accel import (T, _fields, _heightfield_soup, _random_rays,
                              _random_tris, pallas_interpret)  # noqa: F401

CSRC = pathlib.Path(kernels.__file__).resolve().parent / "csrc"
V6_FIELDS = ("u_lo", "u_hi", "c_ent", "c_order", "pages", "root_lo",
             "root_hi")


def _v6_both(verts, tri, spatial, opaque=None):
    kw = dict(block=32, max_leaves=8192, tri_opaque_np=opaque,
              spatial=spatial)
    tv = archive.build_bf8_v6(tbvh.build_packet_bvh_sah(verts, tri,
                                                        device="cpu", **kw))
    jv = jarch.build_bf8_v6(jbvh.build_packet_bvh_sah(verts, tri, **kw))
    return tv, jv


def _assert_v6_equal(tv, want):
    for k in V6_FIELDS:
        g = getattr(tv, k).numpy()
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=k)
    assert (tv.n8, tv.n_leaves, tv.block) == (want["n8"], want["n_leaves"],
                                             want["block"])


@pytest.mark.parametrize("soup", ["random_sah", "random_sbvh", "heightfield"])
def test_bf8_v6_array_equal_to_pt(soup):
    if soup == "heightfield":
        verts, tri = _heightfield_soup(16)
    else:
        verts, tri = _random_tris(1000, seed=40)
    opaque = (np.arange(tri.shape[0]) % 3) != 0
    tv, jv = _v6_both(verts, tri, soup != "random_sah", opaque)
    jf = _fields(jv)
    _assert_v6_equal(tv, jf)
    # pt's structure carried across, and the depth worked out again
    conv = convert.bf8_v6(jf, device="cpu")
    _assert_v6_equal(conv, jf)
    assert conv.depth == tv.depth >= 2
    assert tv.pages is not None and tv.n8 >= 2


def test_octant_orders_decode_to_farthest_first_permutations():
    verts, tri = _random_tris(1000, seed=41)
    tv, _ = _v6_both(verts, tri, True)
    c_lo = tv.u_lo[:tv.n8 * 8].numpy().astype(np.float64)
    c_hi = tv.u_hi[:tv.n8 * 8].numpy().astype(np.float64)
    centers = ((c_lo + c_hi) * 0.5).reshape(tv.n8, 8, 3)
    packed = tv.c_order.numpy().reshape(tv.n8, 8).astype(np.int64)
    for octant in range(8):
        # bit 4: x < 0, bit 2: y < 0, bit 1: z < 0
        diag = np.asarray([-1.0 if octant & 4 else 1.0,
                           -1.0 if octant & 2 else 1.0,
                           -1.0 if octant & 1 else 1.0])
        perm = (packed[:, octant, None] >> (3 * np.arange(8))) & 7
        assert (np.sort(perm, axis=1) == np.arange(8)).all()
        key = np.take_along_axis(centers @ diag, perm, axis=1)
        assert (np.diff(key, axis=1) <= 0).all()      # farthest pushed first


# ------------------------------------------- the ten entry points vs pt

@pytest.fixture(scope="module")
def archive_setup():
    """pt's structures over 300 random triangles (SAH, block 32) and the
    port's converted from them, with 1,024 rays and shadow distances."""
    verts, tri = _random_tris(300, seed=42, spread=4.0)
    jp = jbvh.build_packet_bvh_sah(verts, tri, block=32, max_leaves=8192)
    j8 = jbvh.build_bf8(jp)
    j6 = jarch.build_bf8_v6(jp)
    structures = {
        "packet": (jp, convert.packet_bvh(_fields(jp), device="cpu")),
        "bf8": (j8, convert.bf8_bvh(_fields(j8), device="cpu")),
        "v6": (j6, convert.bf8_v6(_fields(j6), device="cpu"))}
    rng = np.random.default_rng(43)
    o = rng.uniform(-7, 7, (1024, 3)).astype(np.float32)
    d = rng.uniform(-4, 4, (1024, 3)) - o            # aimed into the soup
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dist = rng.uniform(1, 15, 1024).astype(np.float32)
    return verts, tri, structures, o, d, dist


ENTRY_STRUCTURE = {"packet_closest_v3": "packet", "packet_closest_bf8w": "bf8",
                   "packet_closest_v6": "v6", "packet_closest_v6k2": "v6",
                   "packet_closest_v7": "v6", "packet_occluded_v6": "v6",
                   "packet_closest": "packet", "packet_occluded": "packet",
                   "packet_occluded_sub": "packet",
                   "packet_closest_sub": "packet"}


@pytest.mark.parametrize("entry", archive.ENTRY_POINTS)
def test_entry_point_matches_brute_and_pallas(pallas_interpret,
                                              archive_setup, entry):
    verts, tri, structures, o, d, dist = archive_setup
    jstruct, tstruct = structures[ENTRY_STRUCTURE[entry]]
    before = archive.calls[entry]
    if "occluded" in entry:
        got = getattr(archive, entry)(tstruct, T(o), T(d), T(dist))
        want = t_brute(T(verts), T(tri), T(o), T(d), tmax=T(dist)).is_hit
        jgot = np.asarray(getattr(jarch, entry)(
            jstruct, jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist)))
        assert torch.equal(got, want)
        assert 100 < int(got.sum()) < 1000, int(got.sum())
        assert (got.numpy() != jgot).mean() <= 0.01
    else:
        got = getattr(archive, entry)(tstruct, T(o), T(d), 1e4)
        want = t_brute(T(verts), T(tri), T(o), T(d))
        jgot = getattr(jarch, entry)(jstruct, jnp.asarray(o), jnp.asarray(d),
                                     1e4)
        assert torch.equal(got.tri, want.tri)
        assert int((got.tri >= 0).sum()) > 300
        assert (got.tri.numpy() != np.asarray(jgot.tri)).mean() <= 0.01
        same = (got.tri.numpy() == np.asarray(jgot.tri)) & (got.tri.numpy()
                                                            >= 0)
        # Pallas' o', d' carry ~2^-16 relative error from the bf16 split
        np.testing.assert_allclose(got.t.numpy()[same],
                                   np.asarray(jgot.t)[same], rtol=1e-2)
    assert archive.calls[entry] == before + 1
    assert archive.launches[entry] == 0           # nothing launches here


def test_entry_points_check_their_arguments(archive_setup):
    _, _, structures, o, d, _ = archive_setup
    b8, v6 = structures["bf8"][1], structures["v6"][1]
    with pytest.raises(ValueError, match="r_sub"):
        archive.packet_closest_bf8w(b8, T(o), T(d), 1e4, r_sub=0)
    with pytest.raises(ValueError, match="window"):
        archive.packet_closest_v7(v6, T(o), T(d), 1e4, window=0)
    # tmax as an (N,) array or a scalar: the same result
    a = archive.packet_closest_v7(v6, T(o), T(d), torch.full((1024,), 7.0))
    b = archive.packet_closest_v7(v6, T(o), T(d), 7.0, window=3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a.t.max()) == 7.0


# --------------------------------------- the kernels' per-ray code, on host

_HOST_SRC = r"""
#include "ordered_traverse.cuh"
#include "v6_traverse.cuh"
static void binary(const float* lo, const float* hi, const int32_t* miss,
                   const int32_t* leaf, const float* pages, int n_top,
                   int block, int cols, const float* o, const float* d,
                   const float* tmax, float tmin, int n, float* t,
                   int32_t* tri, float* u, float* v,
                   unsigned long long* stats, uint8_t* node_seen,
                   uint8_t* tri_seen, bool stackless) {
    v4::Tree tree{lo, hi, miss, leaf, pages, n_top, block, cols};
    for (int i = 0; i < n; ++i) {
        v4::Counts c{0, 0, node_seen, tri_seen};
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        if (stackless)
            v4::closest<true>(tree, r, tmin, tmax[i], t + i, tri + i, u + i,
                              v + i, &c);
        else
            ordered::closest<true>(tree, r, tmin, tmax[i], t + i, tri + i,
                                   u + i, v + i, &c);
        stats[0] += c.nodes; stats[1] += c.tris;
    }
}
extern "C" {
void host_ordered(const float* lo, const float* hi, const int32_t* miss,
                  const int32_t* leaf, const float* pages, int n_top,
                  int block, int cols, const float* o, const float* d,
                  const float* tmax, float tmin, int n, float* t,
                  int32_t* tri, float* u, float* v, unsigned long long* stats,
                  uint8_t* node_seen, uint8_t* tri_seen) {
    binary(lo, hi, miss, leaf, pages, n_top, block, cols, o, d, tmax, tmin,
           n, t, tri, u, v, stats, node_seen, tri_seen, false);
}
void host_v4(const float* lo, const float* hi, const int32_t* miss,
             const int32_t* leaf, const float* pages, int n_top, int block,
             int cols, const float* o, const float* d, const float* tmax,
             float tmin, int n, float* t, int32_t* tri, float* u, float* v,
             unsigned long long* stats, uint8_t* node_seen,
             uint8_t* tri_seen) {
    binary(lo, hi, miss, leaf, pages, n_top, block, cols, o, d, tmax, tmin,
           n, t, tri, u, v, stats, node_seen, tri_seen, true);
}
void host_v6(const float* u_lo, const float* u_hi, const int32_t* c_ent,
             const int32_t* c_order, const float* pages, int n8, int block,
             int cols, const float* o, const float* d, const float* tmax,
             float tmin, int walk, int window, int n, float* t, int32_t* tri,
             float* u, float* v, unsigned long long* stats,
             uint8_t* node_seen, uint8_t* tri_seen) {
    v6::Tree tree{u_lo, u_hi, c_ent, c_order, pages, n8, block, cols};
    for (int i = 0; i < n; ++i) {
        bf8::Counts c{0, 0, 0, node_seen, tri_seen};
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        if (walk == 1)
            v6::closest_two_pops<true>(tree, r, tmin, tmax[i], t + i,
                                       tri + i, u + i, v + i, &c);
        else if (walk == 2)
            v6::closest_leaf_queue<true>(tree, r, tmin, tmax[i], window,
                                         t + i, tri + i, u + i, v + i, &c);
        else
            v6::closest<true>(tree, r, tmin, tmax[i], t + i, tri + i, u + i,
                              v + i, &c);
        stats[0] += c.nodes; stats[1] += c.leaf_boxes; stats[2] += c.tris;
    }
}
void host_v6_occluded(const float* u_lo, const float* u_hi,
                      const int32_t* c_ent, const int32_t* c_order,
                      const float* pages, int n8, int block, int cols,
                      const float* o, const float* d, const float* dist,
                      float tmin, int n, uint8_t* out) {
    v6::Tree tree{u_lo, u_hi, c_ent, c_order, pages, n8, block, cols};
    for (int i = 0; i < n; ++i) {
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        out[i] = v6::occluded<false>(tree, r, tmin, dist[i], nullptr);
    }
}
}
"""


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    """ordered_traverse.cuh and v6_traverse.cuh built for the host by g++
    (no torch headers), with -ffp-contract=off so that they round as the
    -fmad=false CUDA build does."""
    tmp = tmp_path_factory.mktemp("archive_host")
    src = tmp / "archive_host.cpp"
    src.write_text(_HOST_SRC)
    lib = tmp / "libarchive_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{CSRC}", str(src), "-o",
                    str(lib)], check=True, capture_output=True, timeout=120)
    h = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.host_ordered.argtypes = [p] * 5 + [i, i, i, p, p, p, f, i] + [p] * 7
    h.host_v4.argtypes = h.host_ordered.argtypes
    h.host_v6.argtypes = [p] * 5 + [i, i, i, p, p, p, f, i, i, i] + [p] * 7
    h.host_v6_occluded.argtypes = [p] * 5 + [i, i, i, p, p, p, f, i, p]
    return h


# host walks over a BF8V6, by `walk` as v6_kernels.cu takes it: (walk,
# window)
V6_WALKS = {"v6": (0, 1), "v6k2": (1, 1), "v7": (2, 8)}


def _host_closest(h, bvh, o, d, tmax, walk=None, window=None):
    """One host walk over `bvh`: the ordered walk (walk None), K3's
    stackless walk ("v4") or a BF8V6 walk of V6_WALKS, `window` in place of
    its own."""
    n = o.shape[0]
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    tri = torch.empty(n, dtype=torch.int32)
    counts = kernels.work_counts(bvh)
    outs = (n, t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            *(c.data_ptr() for c in counts))
    if walk is None or walk == "v4":
        fn = h.host_v4 if walk else h.host_ordered
        fn(*kernels._tree_args_v4(bvh), o.data_ptr(), d.data_ptr(),
           tmax.data_ptr(), 1e-5, *outs)
    else:
        code, own = V6_WALKS[walk]
        h.host_v6(*kernels._tree_args_v6(bvh), o.data_ptr(), d.data_ptr(),
                  tmax.data_ptr(), 1e-5, code, window or own, *outs)
    return (t, tri, u, v), counts


def _soup_rays(soup, n=2048):
    if soup == "heightfield":
        rng = np.random.default_rng(53)
        o = rng.uniform(-11, 11, (n, 3)).astype(np.float32)
        o[:, 1] = rng.uniform(1.5, 6, n)
        d = rng.normal(size=(n, 3))
        d[:, 1] = -np.abs(d[:, 1])
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        return T(o), T(d)
    return tuple(T(a) for a in _random_rays(n, seed=52))


SOUPS = {"random1000": lambda: _random_tris(1000, seed=50),
         "heightfield": lambda: _heightfield_soup(32)}


@pytest.mark.parametrize("soup", list(SOUPS))
def test_host_walks_match_plain(host_walks, soup):
    verts, tri = SOUPS[soup]()
    opaque = (np.arange(tri.shape[0]) % 2) == 0
    o, d = _soup_rays(soup)
    n = o.shape[0]
    tmax = torch.full((n,), 1e4)
    sah = tbvh.build_packet_bvh_sah(verts, tri, device="cpu")
    morton = tbvh.build_packet_bvh(T(verts), T(tri))
    sbvh = tbvh.build_packet_bvh_sah(verts, tri, block=32, max_leaves=8192,
                                     tri_opaque_np=opaque, spatial=True,
                                     device="cpu")
    v6 = archive.build_bf8_v6(sbvh)
    runs = [(sah, None), (morton, None)] + [(v6, w) for w in V6_WALKS]
    for bvh, walk in runs:
        (t, tri_out, u, v), counts = _host_closest(host_walks, bvh, o, d,
                                                   tmax, walk)
        plain = kernels.closest_bf8_plain(bvh, o, d, tmax)
        assert int((plain.tri >= 0).sum()) > n // 20
        # same arithmetic in the same order: bit-equal
        for a, b in zip((t, tri_out, u, v), plain):
            assert torch.equal(a, b), (type(bvh).__name__, walk)
        tris = int(counts.totals[-1])
        assert 0 < tris < n * tri.shape[0]
        assert counts.node_seen[0] == 1
    dist = torch.as_tensor(np.random.default_rng(54).uniform(
        0.5, 20, n).astype(np.float32))
    out = torch.empty(n, dtype=torch.uint8)
    host_walks.host_v6_occluded(*kernels._tree_args_v6(v6), o.data_ptr(),
                                d.data_ptr(), dist.data_ptr(), 1e-5, n,
                                out.data_ptr())
    occ = kernels.occluded_v6_plain(v6, o, d, dist)
    assert torch.equal(out.bool(), occ) and 0 < int(occ.sum()) < n


def test_ordered_walk_tests_fewer_triangles_than_stackless(host_walks):
    """Over the Morton tree of a Heightfield, the near-first walk finds the
    same hits as K3's stackless walk with fewer triangle tests: it culls
    boxes behind the nearest hit found so far."""
    verts, tri = SOUPS["heightfield"]()
    o, d = _soup_rays("heightfield")
    pb = tbvh.build_packet_bvh(T(verts), T(tri))
    tmax = torch.full((o.shape[0],), 1e4)
    hit_o, ordered = _host_closest(host_walks, pb, o, d, tmax)
    hit_s, stackless = _host_closest(host_walks, pb, o, d, tmax, "v4")
    assert torch.equal(hit_o[1], hit_s[1])
    assert int(ordered.totals[1]) < int(stackless.totals[1])


def test_leaf_queue_walk_defers_the_t_prune(host_walks):
    """v7's walk with a window of 1 drains its queue after every pop, so
    it prunes as v6 does and does v6's work exactly; with pt's window of 8
    it prunes against an older t, tests more triangles and finds the same
    hits."""
    verts, tri = SOUPS["heightfield"]()
    o, d = _soup_rays("heightfield")
    v6 = archive.build_bf8_v6(tbvh.build_packet_bvh_sah(
        verts, tri, block=32, max_leaves=8192, spatial=True, device="cpu"))
    tmax = torch.full((o.shape[0],), 1e4)
    hit6, c6 = _host_closest(host_walks, v6, o, d, tmax, "v6")
    hit1, c1 = _host_closest(host_walks, v6, o, d, tmax, "v7", window=1)
    hit8, c8 = _host_closest(host_walks, v6, o, d, tmax, "v7")
    assert c1.totals.tolist() == c6.totals.tolist()
    assert torch.equal(c1.tri_seen, c6.tri_seen)
    assert torch.equal(hit1[1], hit6[1]) and torch.equal(hit8[1], hit6[1])
    assert int(c8.totals[2]) > int(c6.totals[2])


def test_degenerate_lanes_end_at_the_root(host_walks):
    """Lanes killed as the integrator kills them (origin beyond the root
    box, +x, tmax = TMIN) test the root and nothing else, in every walk."""
    from pt_torch.render.integrator import _degenerate_masked
    verts, tri = _random_tris(1100, seed=55)
    pb = tbvh.build_packet_bvh(T(verts), T(tri))     # padded subtrees
    v6 = archive.build_bf8_v6(tbvh.build_packet_bvh_sah(
        verts, tri, block=32, max_leaves=8192, spatial=True, device="cpu"))
    o, d = (T(a) for a in _random_rays(256, seed=56))
    live = torch.zeros(256, dtype=torch.bool)
    for bvh, walk, totals in ((pb, None, [256, 0]), (v6, "v6", [256, 0, 0]),
                              (v6, "v6k2", [256, 0, 0]),
                              (v6, "v7", [256, 0, 0])):
        od, dd, td = _degenerate_masked(bvh, o, d, 1e4, live)
        (t, tri_out, _, _), counts = _host_closest(
            host_walks, bvh, od.contiguous(), dd.contiguous(), td, walk)
        assert counts.totals.tolist() == totals
        assert int(counts.node_seen.sum()) == 1 and (tri_out == -1).all()
        assert torch.equal(t, td)


# ------------------------------------------------------ bounds and keys

def test_stack_bounds_raise():
    verts, tri = _random_tris(300, seed=57)
    pb = tbvh.build_packet_bvh(T(verts), T(tri))
    assert pb.depth == int(np.log2(pb.pages.shape[0])) + 1
    assert tbvh.binary_depth(pb.top_miss.numpy(), pb.top_leaf.numpy()) \
        == pb.depth
    sah = tbvh.build_packet_bvh_sah(verts, tri, block=32, device="cpu")
    assert 2 <= sah.depth <= sah.n_top
    v6 = archive.build_bf8_v6(tbvh.build_packet_bvh_sah(
        verts, tri, block=32, max_leaves=8192, spatial=True, device="cpu"))
    o, d = (T(a) for a in _random_rays(16, seed=58))
    tmax = torch.full((16,), 1e4)
    pb._depth = kernels.ORDERED_STACK + 1
    with pytest.raises(ValueError, match="stack"):
        kernels.closest_ordered(pb, o, d, tmax)
    with pytest.raises(ValueError, match="stack"):
        archive.packet_closest_sub(pb, o, d, 1e4)
    deep = dataclasses.replace(v6, depth=19)          # 7*19+1 = 134 > 128
    for fn in (kernels.closest_v6, kernels.closest_v6k2, kernels.closest_v7):
        with pytest.raises(ValueError, match="stack"):
            fn(deep, o, d, tmax)
    with pytest.raises(ValueError, match="stack"):
        kernels.occluded_v6(deep, o, d, tmax)
    nine = dataclasses.replace(v6, depth=9)           # 16*9 = 144 > 128
    kernels.closest_v6(nine, o, d, tmax)              # 7*9+1 = 64 fits
    kernels.closest_v7(nine, o, d, tmax)
    with pytest.raises(ValueError, match="stack"):
        kernels.closest_v6k2(nine, o, d, tmax)


def test_coherence_keys_bit_equal_to_pt():
    from pt.render.integrator import _coherence_keys as j_keys
    from pt_torch.render.integrator import _coherence_keys as t_keys
    verts, tri = _random_tris(500, seed=59)
    jp = jbvh.build_packet_bvh_sah(verts, tri, block=32)
    tp = convert.packet_bvh(_fields(jp), device="cpu")
    o, d = _random_rays(4096, seed=60, spread=14.0)   # some outside the box
    d[::7, 0] = -0.0
    alive = np.random.default_rng(61).uniform(size=4096) > 0.2
    want = np.asarray(j_keys(jp, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(alive))).astype(np.int64)
    got = t_keys(tp, T(o), T(d), T(alive)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0xFFFFFFFF).sum() == (~alive).sum()


# ---------------------------------------------- the duck dispatch, a film

def test_dispatch_routes_bf8_v6_and_film_matches_pt():
    from pt.render import integrator as jint
    from pt.run.renderer import Renderer as JRenderer
    from pt.scene.examples import make_heightfield_scene as j_heightfield
    from pt_torch.render import integrator as tint
    from pt_torch.run.renderer import Renderer
    from pt_torch.scene.examples import make_heightfield_scene
    r = Renderer(tint.PathTracingSettings(sample_count=1, bounce_count=3),
                 device="cpu")
    r.set_scene(make_heightfield_scene(16), stream_textures=False)
    r.on_resize(32, 32)
    v6, fine = archive.swap_in_bf8_v6(r)
    assert r.accel.bvh is v6
    assert v6.pages.data_ptr() == fine.pages.data_ptr()    # shared
    o, d = (T(a) for a in _random_rays(64, seed=62))
    before = dict(archive.calls)
    hit = tint.trace_closest(r.accel.bvh, o, d, torch.full((64,), 1e4))
    occ = tint.trace_occluded(r.accel.bvh, o, d, torch.full((64,), 5.0))
    assert archive.calls["packet_closest_v6"] == \
        before["packet_closest_v6"] + 1
    assert archive.calls["packet_occluded_v6"] == \
        before["packet_occluded_v6"] + 1
    ref = kernels.closest_bf8_plain(r.accel.bvh, o, d, torch.full((64,), 1e4))
    assert torch.equal(hit.tri, ref.tri) and occ.dtype == torch.bool
    before = dict(archive.calls)
    assert r.render() == 1
    assert archive.calls["packet_closest_v6"] - \
        before["packet_closest_v6"] == 3
    assert archive.calls["packet_occluded_v6"] - \
        before["packet_occluded_v6"] == 3
    assert type(r.accel.bvh).__name__ == "BF8V6"      # not rebuilt
    film = r.film_mean()
    jr = JRenderer(jint.PathTracingSettings(sample_count=1, bounce_count=3))
    jr.set_scene(j_heightfield(16))
    jr.on_resize(32, 32)
    jr.render()
    jfilm = jr.film_mean()
    assert np.isfinite(film).all() and film.max() > 0
    mse = float(np.mean((film - jfilm) ** 2))
    assert mse < 1e-3, mse


# ------------------------------------------------------------ the benches

def test_bvh_kernels_bench_on_cpu():
    from pt_torch.benches import bvh_kernels
    lines = []
    out = bvh_kernels.main(device="cpu", n_rays=1024, n=16,
                           emit=lines.append)
    arms = out["arms"]
    assert len(arms) == len(lines) == 11
    assert {a["entry"] for a in arms} == {
        "packet_closest", "packet_closest_sub", "packet_closest_v3",
        "closest_v4", "packet_occluded", "packet_occluded_sub",
        "occluded_v4"}
    assert all(a["oracle_mismatches"] == 0 and a["ms"] is None
               and a["device"] == "cpu" for a in arms)
    assert all(a["disagree_with_v1"] == 0 for a in arms
               if "disagree_with_v1" in a)
    sp, d_sh, dist = out["workloads"]["shadow"]
    occ = archive.packet_occluded(out["tree"], sp, d_sh, dist)
    assert 0 < int(occ.sum()) < 1024


def test_widesub_bench_on_cpu():
    from pt_torch.benches import widesub_ab
    lines = []
    out = widesub_ab.main(device="cpu", n_rays=1024, n=16, emit=lines.append)
    arms = out["arms"]
    assert len(arms) == len(lines) == 4
    assert [a["entry"] for a in arms] == ["closest_bf8"] + [
        "packet_closest_bf8w"] * 3
    assert all(a["oracle_mismatches"] == 0 and a["ms"] is None
               for a in arms)
    o, d, tmax = out["workload"]
    assert int((kernels.closest_bf8(out["tree"], o, d, tmax).tri >= 0)
               .sum()) > 100
