"""Shared-BLAS instancing of the PyTorch port against `pt` on the CPU.

* `shared_dup_ratio`, `shared_mesh_layout`, `decode_instanced_tri` and
  `remap_global_tri` equal `pt`'s.
* `build_instanced_bf8` / `build_instanced_split` give structures array- and
  field-equal to `pt`'s on the same input, and None where `pt` gives None.
* The plain K5/K6 and `csrc/bf8i_traverse.cuh`, compiled for the host with
  g++ (no torch headers), give exact ids against an f32 brute oracle over the
  transformed world triangles on non-overlapping instances, and bit-equal
  t/u/v between themselves.
* Against `pt`'s Pallas kernels K5/K6 themselves, run in interpret mode on
  the CPU, at most 1% of rays may disagree: the Pallas leaf test multiplies
  in 3 bf16 passes and drops near-edge hits that f32 keeps (ROADMAP §2).
* The film of `Renderer(instancing="shared", device="cpu")` against `pt`'s
  Renderer on its brute backend and against the port's own flatten path:
  MSE < 1e-3; against `pt`'s Renderer on its own instanced Pallas path
  (interpret mode): the same structure, and at most 3% of the pixels differ.

The CUDA kernels themselves are tested in tests/test_torch_gpu.py.
"""

import ctypes
import dataclasses
import importlib
import pathlib
import subprocess
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from pt.accel import instanced as jinst
from pt.render import integrator as jint
from pt.run.renderer import Renderer as JRenderer
from pt.scene import flatten as jflat
from pt_torch import convert
from pt_torch.accel import bvh8 as tbvh
from pt_torch.accel import instanced as tinst
from pt_torch.accel import kernels
from pt_torch.accel.intersect import intersect_brute as t_brute
from pt_torch.render import integrator as tint
from pt_torch.run.renderer import Renderer
from pt_torch.scene import flatten as tflat

CSRC = pathlib.Path(kernels.__file__).resolve().parent / "csrc"
ARRAYS = ["c_lo", "c_hi", "c_ent", "l_lo", "l_hi", "leaf_page", "leaf_seg",
          "seg_inv", "pages", "root_lo", "root_hi", "seg_tri_base"]
STATICS = ["n8", "n_leaves", "n_segs", "block", "leaf_retest"]


def T(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _ns(pkg):
    """The scene-building names of package `pkg` ("pt" or "pt_torch")."""
    m = {k: importlib.import_module(f"{pkg}.scene.{k}")
         for k in ("builder", "examples", "graph", "types")}
    cam = importlib.import_module(f"{pkg}.core.camera")
    return types.SimpleNamespace(
        SceneBuilder=m["builder"].SceneBuilder, InputCamera=cam.InputCamera,
        PointLight=m["types"].PointLight,
        DirectionalLight=m["types"].DirectionalLight,
        Geometry=m["types"].Geometry, MeshInfo=m["types"].MeshInfo,
        MetallicRoughnessMaterial=m["types"].MetallicRoughnessMaterial,
        TextureInfo=m["types"].TextureInfo,
        TextureType=m["types"].TextureType)


def _fields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_same_structure(t, j):
    """A port BF8Instanced against a pt one: every array bit for bit, every
    static field."""
    assert isinstance(t, tinst.BF8Instanced)
    assert isinstance(j, jinst.BF8Instanced)
    for k in STATICS:
        assert getattr(t, k) == getattr(j, k), k
    for k in ARRAYS:
        g, w = getattr(t, k), getattr(j, k)
        if w is None:
            assert g is None, k
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert t.depth == tbvh.bf8_depth(t.c_ent.numpy())
    assert t.stack_bound <= 128


def _grid_mesh(n=12, seed=0):
    rng = np.random.default_rng(seed)
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gy = 0.2 * np.sin(gx * 4) * np.cos(gz * 3) \
        + rng.normal(0, 0.01, gx.shape).astype(np.float32)
    pos = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    a, c = idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()
    b, d = idx[1:, :-1].ravel(), idx[:-1, 1:].ravel()
    tris = np.concatenate([np.stack([a, c, b], -1),
                           np.stack([c, a, d], -1)]).astype(np.int32)
    return pos, tris


def _transforms(n, seed=1, spread=10.0):
    rng = np.random.default_rng(seed)
    ts = []
    for _ in range(n):
        s = rng.uniform(0.5, 2.0)
        ang = rng.uniform(0, 2 * np.pi)
        c, sn = np.cos(ang), np.sin(ang)
        m = np.eye(4, dtype=np.float64)
        m[:3, :3] = s * np.asarray([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
        m[:3, 3] = rng.uniform(-spread, spread, 3)
        ts.append(m)
    return np.stack(ts)


def _lattice_transforms(n, seed=1):
    """As `_transforms`, but on a lattice 6 apart, so that no two instances
    (each within a radius of 2.9) overlap: no cross-instance ties."""
    ts = _transforms(n, seed)
    side = int(np.ceil(np.sqrt(n)))
    for i in range(n):
        ts[i, :3, 3] = (6.0 * (i % side), 0.3 * i, 6.0 * (i // side))
    return ts


def _inputs(n_segs=7, n_meshes=2, alpha_mesh=None, lattice=False):
    """(meshes, seg_mesh, seg_transform, seg_tri_base) of the 7-segment,
    2-mesh structure of tests/test_instanced.py; mesh `alpha_mesh` is
    non-opaque."""
    meshes = []
    for m in range(n_meshes):
        pos, tris = _grid_mesh(10 + 2 * m, seed=m)
        opq = None if alpha_mesh is None else \
            np.full(len(tris), m != alpha_mesh, bool)
        meshes.append((pos, tris, opq))
    seg_mesh = [s % n_meshes for s in range(n_segs)]
    seg_t = (_lattice_transforms if lattice else _transforms)(n_segs)
    counts = np.asarray([len(meshes[m][1]) for m in seg_mesh])
    base = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return meshes, seg_mesh, seg_t, base


def _world_tris(meshes, seg_mesh, seg_t):
    """The flattened world triangles (f32 corners v0, v1, v2) in segment
    order, and each one's branded id (segment << SEG_SHIFT | local)."""
    v, ids = [], []
    for s, mi in enumerate(seg_mesh):
        pos, tris = meshes[mi][0], meshes[mi][1]
        w = (pos.astype(np.float64) @ seg_t[s][:3, :3].T
             + seg_t[s][:3, 3]).astype(np.float32)
        v.append(w[tris])
        ids.append((s << tinst.SEG_SHIFT) | np.arange(len(tris)))
    v = np.concatenate(v)
    return v[:, 0], v[:, 1], v[:, 2], np.concatenate(ids).astype(np.int32)


def _rays_at(seg_t, n, seed):
    """Rays from above and around the instances, aimed at points near
    them."""
    rng = np.random.default_rng(seed)
    centers = seg_t[:, :3, 3]
    target = centers[rng.integers(0, len(centers), n)] \
        + rng.uniform(-1.5, 1.5, (n, 3)) * [1, 0.1, 1]
    o = target + rng.normal(0, 1, (n, 3)) * 4 + [0, 6, 0]
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


# ------------------------------------------------------- layout and ids

def _small_scene(ns, n_inst=5, grid_n=10, alpha=False):
    return chip_smoke.build_instanced_scene(ns, n_inst, grid_n, alpha)


@pytest.mark.parametrize("alpha", [False, True], ids=["opaque", "alpha"])
def test_shared_mesh_layout_equals_pt(alpha):
    ts, js = _small_scene(_ns("pt_torch"), alpha=alpha), \
        _small_scene(_ns("pt"), alpha=alpha)
    assert tflat.shared_dup_ratio(ts) == jflat.shared_dup_ratio(js)
    tm, tsm, tb, tdup = tflat.shared_mesh_layout(ts)
    jm, jsm, jb, jdup = jflat.shared_mesh_layout(js)
    assert tdup == jdup and len(tm) == len(jm) == (3 if alpha else 2)
    np.testing.assert_array_equal(tsm, jsm)
    np.testing.assert_array_equal(tb, jb)
    assert tb.dtype == jb.dtype and tsm.dtype == jsm.dtype
    for a, b in zip(tm, jm):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    # an animated geometry has no shared layout, in either package
    ts.geometries[0].is_animated = True
    assert tflat.shared_mesh_layout(ts) is None
    assert tflat.shared_dup_ratio(ts) is None


def test_id_packing_equals_pt():
    assert (tinst.SEG_SHIFT, tinst.SEG_MASK, tinst.TRI_MASK, tinst.MAX_SEGS,
            tinst.MAX_INST_LEAVES, tinst.MAX_INST_BLOCK) == \
        (jinst.SEG_SHIFT, jinst.SEG_MASK, jinst.TRI_MASK, jinst.MAX_SEGS,
         jinst.MAX_INST_LEAVES, jinst.MAX_INST_BLOCK)
    segs = np.asarray([0, 1, 511, 1022, 1023], np.int64)
    local = np.asarray([0, 1, 12345, tinst.TRI_MASK - 1, tinst.TRI_MASK])
    sg, lg = np.meshgrid(segs, local, indexing="ij")
    packed = ((sg << tinst.SEG_SHIFT) | lg).astype(np.int32).ravel()
    packed = np.concatenate([packed, packed | tbvh.ALPHA_TRI_BIT, [-1]]) \
        .astype(np.int32)
    tm, tseg = tinst.decode_instanced_tri(T(packed))
    jm, jseg = jinst.decode_instanced_tri(jnp.asarray(packed))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))
    assert tm.dtype == torch.int32
    base = np.arange(1024, dtype=np.int32) * 1000
    got = tinst.remap_global_tri(T(packed), T(base))
    want = jinst.remap_global_tri(jnp.asarray(packed), jnp.asarray(base))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and int(got[-1]) == -1
    assert int(got[len(packed) // 2]) & tbvh.ALPHA_TRI_BIT


# --------------------------------------------------------------- builds

def test_build_instanced_bf8_equals_pt():
    meshes, seg_mesh, seg_t, base = _inputs()
    for kw in ({}, {"seg_tri_base": base}):
        t = tinst.build_instanced_bf8(meshes, seg_mesh, seg_t, device="cpu",
                                      **kw)
        j = jinst.build_instanced_bf8(meshes, seg_mesh, seg_t, **kw)
        _assert_same_structure(t, j)
    assert (t.n_segs, t.block) == (7, 32) and t.pages.shape[0] < t.n_leaves
    # a pt structure converted into the port's containers keeps its bits
    conv = convert.bf8_instanced(_fields(j), device="cpu")
    _assert_same_structure(conv, j)
    assert conv.depth == t.depth


def _split_inputs(ns_t, ns_j, **kw):
    ts, js = _small_scene(ns_t, **kw), _small_scene(ns_j, **kw)
    tds = tflat.flatten_scene(ts, device="cpu")
    jds = jflat.flatten_scene(js)
    t_in = tflat.shared_mesh_layout(ts)[:3]
    j_in = jflat.shared_mesh_layout(js)[:3]
    return (t_in, tds.seg_transform.numpy().astype(np.float64),
            j_in, np.asarray(jds.seg_transform, np.float64))


def test_build_instanced_split_equals_pt():
    """The small alpha scene through shared_mesh_layout: the full tree and
    the opaque subset tree instanced; the alpha subset (5 crosses of two
    quads) is instanced too, as 5 leaves over one shared page."""
    (tm, tsm, tb), tst, (jm, jsm, jb), jst = _split_inputs(
        _ns("pt_torch"), _ns("pt"), alpha=True)
    t_out = tinst.build_instanced_split(tm, tsm, tst, tb, device="cpu")
    j_out = jinst.build_instanced_split(jm, jsm, jst, jb)
    _assert_same_structure(t_out[0], j_out[0])
    for (tt, tsel), (jt, jsel) in zip(t_out[1:], j_out[1:]):
        np.testing.assert_array_equal(tsel, jsel)
        assert tsel.dtype == jsel.dtype == np.int32
        _assert_same_structure(tt, jt)
    assert t_out[2][0].pages.shape[0] == 1 and t_out[2][0].n_leaves == 5


def test_build_instanced_split_hybrid_equals_pt():
    """A single-leaf alpha subset: its instanced build is infeasible, so
    `tree_a` is None in both packages (the renderer then builds a flat
    subset tree)."""
    meshes, seg_mesh, seg_t, base = _inputs(n_segs=4, n_meshes=2)
    pos, tris = _grid_mesh(3, seed=5)                     # 8 triangles
    meshes = [(meshes[0][0], meshes[0][1], np.ones(len(meshes[0][1]), bool)),
              (pos, tris, np.zeros(len(tris), bool))]
    seg_mesh = [0, 0, 0, 1]
    counts = np.asarray([len(meshes[m][1]) for m in seg_mesh])
    base = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    t_out = tinst.build_instanced_split(meshes, seg_mesh, seg_t, base,
                                        device="cpu")
    j_out = jinst.build_instanced_split(meshes, seg_mesh, seg_t, base)
    _assert_same_structure(t_out[0], j_out[0])
    _assert_same_structure(t_out[1][0], j_out[1][0])
    assert t_out[2][0] is None and j_out[2][0] is None
    np.testing.assert_array_equal(t_out[2][1], j_out[2][1])
    assert len(t_out[2][1]) == 8


@pytest.mark.parametrize("case", ["singular", "too_many_segments",
                                  "single_leaf", "mixed_opacity"])
def test_infeasible_builds_give_none_as_pt(case):
    pos, tris = _grid_mesh(8)
    meshes = [(pos, tris, None)]
    if case == "singular":
        seg_t = _transforms(2)
        seg_t[1, :3, :3] = 0.0
        args = (meshes, [0, 0], seg_t)
    elif case == "too_many_segments":
        n = tinst.MAX_SEGS + 1
        args = (meshes, [0] * n, np.broadcast_to(np.eye(4), (n, 4, 4)).copy())
    elif case == "single_leaf":
        p3, t3 = _grid_mesh(3)
        args = ([(p3, t3, None)], [0], np.eye(4)[None])
    else:
        opq = np.ones(len(tris), bool)
        opq[::2] = False
        args = ([(pos, tris, opq)], [0, 0], _transforms(2),
                np.asarray([0, len(tris)], np.int64))
        assert tinst.build_instanced_split(*args, device="cpu") is None
        assert jinst.build_instanced_split(*args) is None
        return
    assert tinst.build_instanced_bf8(*args, device="cpu") is None
    assert jinst.build_instanced_bf8(*args) is None


def test_seg_mesh_out_of_range_raises():
    pos, tris = _grid_mesh(8)
    with pytest.raises(ValueError, match="out of range"):
        tinst.build_instanced_bf8([(pos, tris, None)], [0, 1],
                                  _transforms(2), device="cpu")


# ------------------------------------------------- the kernels' logic

def _oracle(meshes, seg_mesh, seg_t, o, d, tmax=1e4):
    v0, v1, v2, ids = _world_tris(meshes, seg_mesh, seg_t)
    pos = np.stack([v0, v1, v2], axis=1).reshape(-1, 3)
    hit = t_brute(T(pos), T(np.arange(len(pos)).reshape(-1, 3)), T(o), T(d),
                  1e-5, tmax)
    tri = hit.tri.numpy()
    return np.where(tri >= 0, ids[np.maximum(tri, 0)], -1), hit.t.numpy()


def test_plain_closest_matches_brute_oracle():
    meshes, seg_mesh, seg_t, base = _inputs(lattice=True)
    b = tinst.build_instanced_bf8(meshes, seg_mesh, seg_t, device="cpu")
    o, d = _rays_at(seg_t, 2048, 5)
    tmax = torch.full((2048,), 1e4)
    h = kernels.closest_bf8i(b, T(o), T(d), tmax)
    want, want_t = _oracle(meshes, seg_mesh, seg_t, o, d)
    np.testing.assert_array_equal(h.tri.numpy(), want)
    hit = want >= 0
    assert hit.sum() > 400
    np.testing.assert_allclose(h.t.numpy()[hit], want_t[hit], rtol=1e-4)
    # misses: t = tmax, u = v = 0
    assert (h.t.numpy()[~hit] == 1e4).all()
    assert (h.u.numpy()[~hit] == 0).all() and (h.v.numpy()[~hit] == 0).all()
    mesh_tri, seg = tinst.decode_instanced_tri(h.tri)
    assert int(seg.max()) == 6 and int(mesh_tri.max()) < len(meshes[1][1])
    # with seg_tri_base, closest() gives global flattened ids
    g = tinst.build_instanced_bf8(meshes, seg_mesh, seg_t, device="cpu",
                                  seg_tri_base=base)
    glob = g.closest(T(o), T(d), tmax, 1e-5).tri.numpy()
    local = np.where(want >= 0, want & tinst.TRI_MASK, -1)
    wseg = np.where(want >= 0, want >> tinst.SEG_SHIFT, 0)
    np.testing.assert_array_equal(glob, np.where(want >= 0,
                                                 base[wseg] + local, -1))
    # occlusion agrees with the closest hit under the same limit
    dist = np.random.default_rng(6).uniform(2, 14, 2048).astype(np.float32)
    occ = kernels.occluded_bf8i(b, T(o), T(d), T(dist)).numpy()
    near = kernels.closest_bf8i(b, T(o), T(d), T(dist)).tri.numpy() >= 0
    np.testing.assert_array_equal(occ, near)
    assert 0 < occ.sum() < hit.sum()


def test_plain_alpha_bit_raw_ids_and_opaque_only():
    meshes, seg_mesh, seg_t, _ = _inputs(alpha_mesh=1, lattice=True)
    b = tinst.build_instanced_bf8(meshes, seg_mesh, seg_t, device="cpu")
    o, d = _rays_at(seg_t, 1024, 7)
    tmax = torch.full((1024,), 1e4)
    h = kernels.closest_bf8i(b, T(o), T(d), tmax)
    raw = kernels.closest_bf8i(b, T(o), T(d), tmax, raw_ids=True)
    tri, rtri = h.tri.numpy(), raw.tri.numpy()
    on_alpha = (tri >= 0) & ((tri >> tinst.SEG_SHIFT) % 2 == 1)
    assert on_alpha.sum() > 50 and ((tri >= 0) & ~on_alpha).sum() > 50
    assert (tri & tbvh.ALPHA_TRI_BIT)[tri >= 0].max() == 0
    np.testing.assert_array_equal(
        rtri, np.where(on_alpha, tri | tbvh.ALPHA_TRI_BIT, tri))
    assert torch.equal(raw.t, h.t)
    # opaque_only: the occluder must be a triangle of an opaque segment
    occ_all = kernels.occluded_bf8i(b, T(o), T(d), tmax).numpy()
    occ_opq = kernels.occluded_bf8i(b, T(o), T(d), tmax,
                                    opaque_only=True).numpy()
    np.testing.assert_array_equal(occ_all, tri >= 0)
    opaque_meshes = [(m[0], m[1], None) for m in meshes]
    keep = [s for s, mi in enumerate(seg_mesh) if mi != 1]
    want, _ = _oracle(opaque_meshes, [seg_mesh[s] for s in keep],
                      seg_t[keep], o, d)
    np.testing.assert_array_equal(occ_opq, want >= 0)
    assert occ_opq.sum() < occ_all.sum()


def test_tie_across_instances_smallest_branded_id_wins():
    """Two coincident instances: every hit is an exact t tie between leaves
    of different segments; the smaller branded id (segment 0) wins."""
    pos, tris = _grid_mesh(10)
    seg_t = np.stack([np.eye(4), np.eye(4)])
    b = tinst.build_instanced_bf8([(pos, tris, None)], [0, 0], seg_t,
                                  device="cpu")
    rng = np.random.default_rng(8)
    o = np.stack([rng.uniform(-0.9, 0.9, 256), np.full(256, 3.0),
                  rng.uniform(-0.9, 0.9, 256)], -1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (256, 1))
    h = kernels.closest_bf8i(b, T(o), T(d), torch.full((256,), 1e4))
    assert bool((h.tri >= 0).all())
    assert int((h.tri >> tinst.SEG_SHIFT).max()) == 0


def test_wrappers_reject_bad_input():
    meshes, seg_mesh, seg_t, _ = _inputs()
    b = tinst.build_instanced_bf8(meshes, seg_mesh, seg_t, device="cpu")
    o, d = _rays_at(seg_t, 16, 9)
    tmax = torch.full((16,), 1e4)
    with pytest.raises(TypeError):
        kernels.closest_bf8i(b, T(o).double(), T(d), tmax)
    with pytest.raises(ValueError):
        kernels.occluded_bf8i(b, T(o)[:8], T(d), tmax)
    with pytest.raises(ValueError):
        kernels.closest_bf8i(b, T(o).t().contiguous().t(), T(d), tmax)
    deep = dataclasses.replace(b, depth=19)
    with pytest.raises(ValueError, match="stack"):
        kernels.closest_bf8i(deep, T(o), T(d), tmax)
    bad = dataclasses.replace(b, leaf_seg=b.leaf_seg.long())
    with pytest.raises(TypeError, match="leaf_seg"):
        kernels._tree_args_bf8i(bad)
    wc = kernels.work_counts(b)
    assert wc.totals.shape == (4,) and wc.leaf_seen.shape == (b.n_leaves,)
    assert wc.tri_seen.shape == (b.pages.shape[0] * b.block,)


# ---------------------------------------------- against the Pallas kernels

@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run pt's Pallas kernels in interpret mode on the CPU (nothing in pt
    changes: pl.pallas_call is patched to pass InterpretParams)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    orig = pl.pallas_call

    def interpreted(*args, **kw):
        kw.setdefault("interpret", pltpu.InterpretParams())
        return orig(*args, **kw)
    monkeypatch.setattr(pl, "pallas_call", interpreted)


@pytest.mark.parametrize("leaf_retest", [True, False])
def test_plain_matches_pallas_kernels_within_budget(pallas_interpret,
                                                    leaf_retest):
    """`pt`'s K5/K6 on the structure `pt` built, carried across by
    `convert.bf8_instanced`; both `leaf_retest` arms of the Pallas kernel
    (the port always retests, which changes no result)."""
    meshes, seg_mesh, seg_t, _ = _inputs(alpha_mesh=1, lattice=True)
    j = jinst.build_instanced_bf8(meshes, seg_mesh, seg_t)
    assert j.leaf_retest
    j = dataclasses.replace(j, leaf_retest=leaf_retest)
    b = convert.bf8_instanced(_fields(j), device="cpu")
    assert b.leaf_retest == leaf_retest
    n = 1024
    o, d = _rays_at(seg_t, n, 11)
    tmax = np.full(n, 1e4, np.float32)
    raw = not leaf_retest
    jh = jinst.packet_closest_bf8i(j, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tmax), 1e-5, raw_ids=raw)
    th = kernels.closest_bf8i(b, T(o), T(d), T(tmax), raw_ids=raw)
    differ = th.tri.numpy() != np.asarray(jh.tri)
    assert differ.mean() <= 0.01, differ.mean()
    same = ~differ & (th.tri.numpy() >= 0)
    assert same.sum() > 300
    # Pallas' o', d' carry ~2^-16 relative error from the bf16 split, which
    # t = -o'z/d'z amplifies on grazing rays
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                               rtol=1e-3)
    dist = np.random.default_rng(12).uniform(2, 14, n).astype(np.float32)
    jo = jinst.packet_occluded_bf8i(j, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(dist), 1e-5,
                                    opaque_only=leaf_retest)
    to = kernels.occluded_bf8i(b, T(o), T(d), T(dist),
                               opaque_only=leaf_retest)
    assert (to.numpy() != np.asarray(jo)).mean() <= 0.01
    assert 0 < to.sum() < n


# --------------------------------------- the kernels' per-ray code, on host

_HOST_SRC = r"""
#include "bf8i_traverse.cuh"
extern "C" {
static bf8i::Tree make(const float* c_lo, const float* c_hi,
                       const int32_t* c_ent, const float* l_lo,
                       const float* l_hi, const int32_t* leaf_page,
                       const int32_t* leaf_seg, const float* seg_inv,
                       const float* pages, int block, int cols) {
    bf8i::Tree t;
    t.top = bf8::Tree{c_lo, c_hi, c_ent, l_lo, l_hi, pages, block, cols};
    t.leaf_page = leaf_page; t.leaf_seg = leaf_seg; t.seg_inv = seg_inv;
    return t;
}
void host_closest(const float* c_lo, const float* c_hi, const int32_t* c_ent,
                  const float* l_lo, const float* l_hi,
                  const int32_t* leaf_page, const int32_t* leaf_seg,
                  const float* seg_inv, const float* pages, int block,
                  int cols, const float* o, const float* d,
                  const float* tmax, float tmin, int raw_ids, int n,
                  float* t, int32_t* tri, float* u, float* v,
                  unsigned long long* stats, uint8_t* node_seen,
                  uint8_t* leaf_seen, uint8_t* tri_seen) {
    bf8i::Tree tree = make(c_lo, c_hi, c_ent, l_lo, l_hi, leaf_page,
                           leaf_seg, seg_inv, pages, block, cols);
    for (int i = 0; i < n; ++i) {
        bf8i::Counts c{0, 0, 0, 0, node_seen, leaf_seen, tri_seen};
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        bf8i::closest<true>(tree, r, tmin, tmax[i], raw_ids != 0, t + i,
                            tri + i, u + i, v + i, &c);
        stats[0] += c.nodes; stats[1] += c.leaf_boxes;
        stats[2] += c.leaf_visits; stats[3] += c.tris;
    }
}
void host_occluded(const float* c_lo, const float* c_hi,
                   const int32_t* c_ent, const float* l_lo,
                   const float* l_hi, const int32_t* leaf_page,
                   const int32_t* leaf_seg, const float* seg_inv,
                   const float* pages, int block, int cols, const float* o,
                   const float* d, const float* dist, float tmin,
                   int opaque_only, int n, uint8_t* out) {
    bf8i::Tree tree = make(c_lo, c_hi, c_ent, l_lo, l_hi, leaf_page,
                           leaf_seg, seg_inv, pages, block, cols);
    for (int i = 0; i < n; ++i) {
        rt::Ray r = rt::make_ray(o[3*i], o[3*i+1], o[3*i+2],
                                 d[3*i], d[3*i+1], d[3*i+2]);
        out[i] = bf8i::occluded<false>(tree, r, tmin, dist[i],
                                       opaque_only != 0, nullptr);
    }
}
}
"""


@pytest.fixture(scope="module")
def host_traversal(tmp_path_factory):
    """bf8i_traverse.cuh built for the host by g++ (no torch headers), with
    -ffp-contract=off so it rounds as the -fmad=false CUDA build does."""
    tmp = tmp_path_factory.mktemp("bf8i_host")
    src = tmp / "bf8i_host.cpp"
    src.write_text(_HOST_SRC)
    lib = tmp / "libbf8i_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", f"-I{CSRC}", str(src), "-o",
                    str(lib)], check=True, capture_output=True, timeout=120)
    h = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.host_closest.argtypes = [p] * 9 + [i, i, p, p, p, f, i, i] + [p] * 8
    h.host_occluded.argtypes = [p] * 9 + [i, i, p, p, p, f, i, i, p]
    return h


@pytest.mark.parametrize("case", ["lattice", "overlapping", "alpha_cards"])
def test_host_traversal_matches_plain(host_traversal, case):
    """The kernels' per-ray walk against the plain version: ids equal and
    t/u/v bit-equal, over non-overlapping instances, over instances strewn
    into each other, and over the 2-page tree of alpha cards (most columns
    padding)."""
    if case == "alpha_cards":
        (tm, tsm, tb), tst, _, _ = _split_inputs(
            _ns("pt_torch"), _ns("pt_torch"), n_inst=9, alpha=True)
        _, _, (b, _) = tinst.build_instanced_split(tm, tsm, tst, tb,
                                                   device="cpu")
        assert b.pages.shape[0] == 1 and b.n_leaves == 9
        seg_t = tst[[s for s in range(len(tsm)) if tsm[s] == 2]]
        seg_t[:, 1, 3] += 1.2                  # aim at the cards
    else:
        meshes, seg_mesh, seg_t, _ = _inputs(
            alpha_mesh=1, lattice=case == "lattice")
        if case == "overlapping":
            seg_t = _transforms(7, spread=1.5)
        b = tinst.build_instanced_bf8(meshes, seg_mesh, seg_t, device="cpu")
    n = 2048
    o, d = _rays_at(seg_t, n, 21)
    ot, dt = T(o), T(d)
    tmax = torch.full((n,), 1e4)
    args = kernels._tree_args_bf8i(b)
    for raw in (0, 1):
        t = torch.empty(n)
        tri = torch.empty(n, dtype=torch.int32)
        u, v = torch.empty(n), torch.empty(n)
        wc = kernels.work_counts(b)
        host_traversal.host_closest(
            *args, ot.data_ptr(), dt.data_ptr(), tmax.data_ptr(), 1e-5, raw,
            n, t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(),
            wc.totals.data_ptr(), wc.node_seen.data_ptr(),
            wc.leaf_seen.data_ptr(), wc.tri_seen.data_ptr())
        plain = kernels.closest_bf8i_plain(b, ot, dt, tmax, raw_ids=bool(raw))
        ties = (tri != plain.tri) & (t == plain.t)
        assert int(ties.sum()) <= (2 if case == "overlapping" else 0)
        ok = ~ties
        assert torch.equal(tri[ok], plain.tri[ok])
        assert torch.equal(t, plain.t)
        assert torch.equal(u[ok], plain.u[ok])
        assert torch.equal(v[ok], plain.v[ok])
    assert int((plain.tri >= 0).sum()) > n // 20
    nodes, leaf_boxes, leaf_visits, tris = wc.totals.tolist()
    assert 0 < nodes and 0 < leaf_visits <= leaf_boxes
    assert int(wc.leaf_seen.sum()) <= min(leaf_visits, b.n_leaves)
    ids = b.pages[:, 0, 6 * b.block:7 * b.block].contiguous()
    valid = ids.view(torch.int32).reshape(-1) >= 0
    assert 0 < int(wc.tri_seen.sum()) <= int(valid.sum())
    assert not bool(wc.tri_seen.bool()[~valid].any())
    assert tris < n * int(valid.sum()) * b.n_segs         # pruning happened
    dist = T(np.random.default_rng(24).uniform(2, 14, n).astype(np.float32))
    for flag in (0, 1):
        out = torch.empty(n, dtype=torch.uint8)
        host_traversal.host_occluded(*args, ot.data_ptr(), dt.data_ptr(),
                                     dist.data_ptr(), 1e-5, flag, n,
                                     out.data_ptr())
        want = kernels.occluded_bf8i_plain(b, ot, dt, dist,
                                           opaque_only=bool(flag))
        assert torch.equal(out.bool(), want)


# ------------------------------------------------------------- renderer

def _render(scene, instancing, samples=1):
    r = Renderer(tint.PathTracingSettings(sample_count=1, bounce_count=3),
                 device="cpu", instancing=instancing)
    r.set_scene(scene)
    r.on_resize(32, 32)
    r.render(samples)
    return r


def test_want_instanced_policy_equals_pt():
    for mode, dup, n in (("auto", 16.0, 300_000), ("flatten", 16.0, 300_000),
                         ("shared", 1.0, 10), ("auto", 2.0, 300_000),
                         ("auto", 16.0, 50_000), ("auto", 8.0, 400_000),
                         ("auto", 4.0, 200_000), ("auto", 3.99, 10**7)):
        assert Renderer._want_instanced(mode, dup, n) == \
            JRenderer._want_instanced(mode, dup, n, False), (mode, dup, n)


@pytest.mark.parametrize("alpha", [False, True], ids=["opaque", "alpha"])
def test_shared_film_matches_flatten_film_and_pt(alpha):
    """32², 1 spp, 3 bounces, same RNG: the shared-BLAS path against the
    port's flatten path and against `pt`'s Renderer (its brute backend on
    the CPU; `pt`'s own instanced structures are held against the port's in
    the test below)."""
    shared = _render(_small_scene(_ns("pt_torch"), alpha=alpha), "shared")
    flat = _render(_small_scene(_ns("pt_torch"), alpha=alpha), "flatten")
    auto = _render(_small_scene(_ns("pt_torch"), alpha=alpha), "auto")
    assert isinstance(shared.accel.bvh, tinst.BF8Instanced)
    assert shared.accel.bvh.seg_tri_base is not None
    assert isinstance(flat.accel.bvh, tbvh.BF8BVH)
    assert isinstance(auto.accel.bvh, tbvh.BF8BVH)     # a small scene
    if alpha:
        sp = shared.accel.alpha_split
        assert isinstance(sp.bvh_opaque, tinst.BF8Instanced)
        assert isinstance(sp.bvh_alpha, tinst.BF8Instanced)
        assert isinstance(flat.accel.alpha_split.bvh_alpha,
                          (tbvh.BF8BVH, tbvh.PacketBVH))
    else:
        assert shared.accel.alpha_split is None
    film = shared.film_mean()
    assert np.isfinite(film).all() and film.max() > 0
    assert float(np.mean((film - flat.film_mean()) ** 2)) < 1e-3
    assert abs(shared.rays_traced - flat.rays_traced) \
        <= 0.01 * flat.rays_traced
    jr = JRenderer(jint.PathTracingSettings(sample_count=1, bounce_count=3,
                                            backend="brute"))
    jr.set_scene(_small_scene(_ns("pt"), alpha=alpha), stream_textures=False)
    jr.on_resize(32, 32)
    jr.render()
    mse = float(np.mean((film - jr.film_mean()) ** 2))
    assert mse < 1e-3, mse
    snap = shared.snapshot()
    assert snap.shape == (32, 32, 3)
    assert (0 <= snap).all() and (snap <= 1).all()


def test_shared_film_against_pt_renderer_on_its_pallas_path(
        pallas_interpret, monkeypatch):
    """`pt`'s Renderer taking its own shared-BLAS arm on this CPU: its
    static path asks `jax.default_backend()` for "tpu", which is patched
    here, and its K5/K6 run in interpret mode; nothing in `pt` changes.
    Both renderers must select `BF8Instanced`. The films are held to a share
    of differing pixels, not to an MSE: `pt`'s Pallas leaf test drops
    near-edge hits that f32 keeps (up to 1% of rays, ROADMAP §2), `pt`'s own
    brute backend differs from its Pallas path on the same pixels, and under
    this scene's bright lights a handful of flipped paths alone put the MSE
    far above 1e-3. Three bounces compound the ray budget, so at most 3% of
    the pixels may differ; the others agree within rtol 1e-3."""
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jr = JRenderer(jint.PathTracingSettings(sample_count=1, bounce_count=3,
                                            backend="pallas"),
                   instancing="shared")
    jr.set_scene(_small_scene(_ns("pt")), stream_textures=False)
    jr.on_resize(32, 32)
    jr.render()
    jfilm = jr.film_mean()
    r = _render(_small_scene(_ns("pt_torch")), "shared")
    assert type(jr.accel.bvh).__name__ == type(r.accel.bvh).__name__ \
        == "BF8Instanced"
    assert jr.accel.alpha_split is None and r.accel.alpha_split is None
    _assert_same_structure(r.accel.bvh, jr.accel.bvh)
    film = r.film_mean()
    differ = np.abs(film - jfilm).max(axis=-1) \
        > 1e-3 * (1.0 + np.abs(jfilm).max(axis=-1))
    print(f"share of differing pixels {differ.mean():.4f}, film MSE "
          f"{float(np.mean((film - jfilm) ** 2)):.3g}")
    assert differ.mean() <= 0.03, differ.mean()
    assert abs(r.rays_traced - jr.rays_traced) <= 0.01 * jr.rays_traced


@pytest.mark.parametrize("alpha", [False, True], ids=["opaque", "alpha"])
def test_renderer_structures_equal_pt_build_instanced(alpha):
    """`Renderer._ensure_accel` with instancing="shared" against `pt`'s
    `Renderer._build_instanced` on the same scene: the types of the accel
    and of the split trees, and every array of each."""
    from pt.core.cache import LRUCache
    from pt.run.renderer import _prepare_attribs_jit
    r = Renderer(device="cpu", instancing="shared")
    r.set_scene(_small_scene(_ns("pt_torch"), alpha=alpha))
    r._ensure_accel()
    jr = JRenderer(jint.PathTracingSettings(backend="pallas"),
                   instancing="shared")
    jr.scene = _small_scene(_ns("pt"), alpha=alpha)
    jr.ds = jflat.flatten_scene(jr.scene)
    base = _prepare_attribs_jit(jr.ds, jr._jit_settings())
    JRenderer._accel_cache = LRUCache(4)

    def build_static(rows, opq_rows):
        raise AssertionError("both subset builds are feasible here")
    jacc = jr._build_instanced(("k", alpha), np.asarray(jr.ds.tri_idx),
                               np.asarray(jr.ds.tri_opaque), build_static,
                               base)
    JRenderer._accel_cache = None
    assert type(r.accel.bvh).__name__ == type(jacc.bvh).__name__ \
        == "BF8Instanced"
    _assert_same_structure(r.accel.bvh, jacc.bvh)
    if not alpha:
        assert r.accel.alpha_split is None and jacc.alpha_split is None
        return
    tsp, jsp = r.accel.alpha_split, jacc.alpha_split
    _assert_same_structure(tsp.bvh_opaque, jsp.bvh_opaque)
    _assert_same_structure(tsp.bvh_alpha, jsp.bvh_alpha)
    np.testing.assert_array_equal(tsp.sel_opaque.numpy(),
                                  np.asarray(jsp.sel_opaque))
    np.testing.assert_array_equal(tsp.sel_alpha.numpy(),
                                  np.asarray(jsp.sel_alpha))


def test_renderer_decision_table():
    """The arms of `_build_instanced` beyond the two above: a hybrid split
    (flat alpha subset tree), wholly alpha content (no split), an
    infeasible structure (flatten), and "flatten" on an instanced scene."""
    ns = _ns("pt_torch")
    # one alpha cross in all: the alpha subset is a single leaf
    r = Renderer(device="cpu", instancing="shared")
    r.set_scene(_small_scene(ns, n_inst=1, alpha=True))
    r._ensure_accel()
    sp = r.accel.alpha_split
    assert isinstance(r.accel.bvh, tinst.BF8Instanced)
    assert isinstance(sp.bvh_opaque, tinst.BF8Instanced)
    assert isinstance(sp.bvh_alpha, tbvh.PacketBVH)       # flat, one leaf
    r.on_resize(16, 16)
    assert r.render(1) == 1 and np.isfinite(r.film_mean()).all()
    # wholly alpha: the single-tree loops over the full instanced tree
    scene = _small_scene(ns, n_inst=3)
    for i, g in enumerate(scene.geometries):
        scene.geometries[i] = dataclasses.replace(g, is_opaque=False)
    r = Renderer(device="cpu", instancing="shared")
    r.set_scene(scene)
    r._ensure_accel()
    assert isinstance(r.accel.bvh, tinst.BF8Instanced)
    assert r.ds.has_alpha and r.accel.alpha_split is None
    r.on_resize(16, 16)
    assert r.render(1) == 1 and np.isfinite(r.film_mean()).all()
    # infeasible (a singular instance transform): flatten, silently
    scene = _small_scene(ns, n_inst=3)
    scene.instance_transforms[1][:3, :3] = 0.0
    r = Renderer(device="cpu", instancing="shared")
    r.set_scene(scene)
    r._ensure_accel()
    assert isinstance(r.accel.bvh, tbvh.BF8BVH)
