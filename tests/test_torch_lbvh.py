"""The threaded LBVH backend (`backend="bvh"`) against `pt`'s on the CPU.

* `build_bvh` / `refit_bvh`: every array bit-equal to `pt`'s (the Morton
  order is a stable sort, as `jnp.argsort`; padding slots give ±inf boxes).
* `bvh_closest` / `bvh_occluded` on `tests/test_bvh.py`'s random
  triangles (independent, no shared edges): ids exact against the brute
  oracle; against `pt`'s walk ids equal and t, u, v within rtol 1e-5; the
  loop conditions tested every step or every 8 give bit-equal results.
* Films: `Renderer(backend="bvh")` and `render_image_stats` against `pt`'s
  LBVH films, MSE < 1e-3 (the project's film bar), with no kernel wrapper
  and no brute force reached; an animated scene rebuilds its tree every
  frame; a change of leaf size rebuilds.
* The failed subset tree: a static alpha scene whose subset tree fails to
  build keeps the split when that subset holds at most 4096 triangles
  (`pt`'s rule, `pt/run/renderer.py:739-749`) and traces the subset
  through its Morton tree, where `pt` traces it by brute force.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from pt.accel import lbvh as jlbvh
from pt.accel import traverse as jtrav
from pt.render import integrator as jint
from pt.run.renderer import Renderer as JRenderer
from pt.scene import examples as jex
from pt.scene.flatten import flatten_scene as j_flatten
from pt.scene.textures import build_scene_textures as j_textures
from pt_torch import convert
from pt_torch.accel import lbvh as tlbvh
from pt_torch.accel import traverse as ttrav
from pt_torch.accel.intersect import intersect_brute
from pt_torch.render import integrator as tint
from pt_torch.run import renderer as trenderer
from pt_torch.run.renderer import Renderer
from pt_torch.scene import examples as tex_
from pt_torch.scene.flatten import flatten_scene
from pt_torch.scene.textures import build_scene_textures

from test_torch_animated import _ns
from torch_threads import one_torch_thread  # noqa: F401

FILM_MSE = 1e-3
BVH = tint.PathTracingSettings(sample_count=1, bounce_count=3, backend="bvh")
KERNELS = ("closest_bf8", "occluded_bf8", "closest_v4", "occluded_v4",
           "intersect_brute")
ARRAYS = ("aabb_lo", "aabb_hi", "miss_next", "leaf_id", "leaf_tris")


def _random_tris(n, seed=0, spread=10.0):
    """`tests/test_bvh.py`'s triangles: independent, no shared edges."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n, 3))
    verts = (centers[:, None, :]
             + rng.normal(0, 0.4, (n, 3, 3))).reshape(-1, 3)
    return (verts.astype(np.float32),
            np.arange(n * 3, dtype=np.int32).reshape(n, 3))


def _random_rays(n, seed=1, spread=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_arrays_equal(tree, jtree):
    for name in ARRAYS:
        got, want = getattr(tree, name).numpy(), np.asarray(getattr(jtree,
                                                                    name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
    assert (tree.leaf_count, tree.leaf_size, tree.n_nodes) == (
        jtree.leaf_count, jtree.leaf_size, jtree.n_nodes)


def _forbid(monkeypatch, names):
    def boom(*args, **kwargs):
        raise AssertionError(f"one of {names} was called")
    for name in names:
        monkeypatch.setattr(tint, name, boom)


@pytest.mark.parametrize("n_tris, leaf_size", [(1, 4), (10, 4), (100, 4),
                                               (1000, 4), (300, 2),
                                               (1000, 8)])
def test_build_bvh_arrays_equal_pts(n_tris, leaf_size):
    v, t = _random_tris(n_tris)
    tree = tlbvh.build_bvh(torch.as_tensor(v), torch.as_tensor(t), leaf_size)
    jtree = jlbvh.build_bvh(jnp.asarray(v), jnp.asarray(t), leaf_size)
    _assert_arrays_equal(tree, jtree)
    # padding slots: -1 ids, and their leaves' boxes stay finite only where
    # a real triangle lies
    pad = tree.leaf_count * leaf_size - n_tris
    assert int((tree.leaf_tris < 0).sum()) == pad


def test_morton_ties_keep_pts_order():
    """Many equal Morton codes (a grid of identical centroids): the stable
    sort keeps `pt`'s leaf order."""
    v, t = _random_tris(64)
    v = np.tile(v[:3], (64, 1))            # every triangle the same
    tree = tlbvh.build_bvh(torch.as_tensor(v), torch.as_tensor(t), 4)
    jtree = jlbvh.build_bvh(jnp.asarray(v), jnp.asarray(t), 4)
    _assert_arrays_equal(tree, jtree)
    assert tree.leaf_tris.flatten().tolist() == list(range(64))


def test_refit_arrays_equal_pts():
    v, t = _random_tris(200)
    moved = v + np.asarray([5.0, -1.0, 0.5], np.float32) * np.sin(
        np.arange(len(v), dtype=np.float32))[:, None]
    tree = tlbvh.refit_bvh(
        tlbvh.build_bvh(torch.as_tensor(v), torch.as_tensor(t), 4),
        torch.as_tensor(moved), torch.as_tensor(t))
    jtree = jlbvh.refit_bvh(jlbvh.build_bvh(jnp.asarray(v), jnp.asarray(t),
                                            4),
                            jnp.asarray(moved), jnp.asarray(t))
    _assert_arrays_equal(tree, jtree)
    o, d = _random_rays(256, seed=3)
    T = torch.as_tensor
    hb = intersect_brute(T(moved), T(t), T(o), T(d))
    hv = ttrav.bvh_closest(tree, T(moved), T(t), T(o), T(d))
    assert torch.equal(hv.tri, hb.tri)


def _walks(n_tris, n_rays=512, seed=1, **kw):
    v, t = _random_tris(n_tris)
    o, d = _random_rays(n_rays, seed=seed)
    T = torch.as_tensor
    tree = tlbvh.build_bvh(T(v), T(t), 4)
    jtree = jlbvh.build_bvh(jnp.asarray(v), jnp.asarray(t), 4)
    return (v, t, o, d), tree, jtree


@pytest.mark.parametrize("n_tris", [10, 100, 1000])
def test_closest_exact_against_brute_and_pts(n_tris):
    (v, t, o, d), tree, jtree = _walks(n_tris)
    T = torch.as_tensor
    hv = ttrav.bvh_closest(tree, T(v), T(t), T(o), T(d))
    hb = intersect_brute(T(v), T(t), T(o), T(d))
    assert torch.equal(hv.tri, hb.tri)
    np.testing.assert_allclose(hv.t.numpy(), hb.t.numpy(), rtol=1e-5,
                               atol=1e-5)
    jh = jtrav.bvh_closest(jtree, jnp.asarray(v), jnp.asarray(t),
                           jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(hv.tri.numpy(), np.asarray(jh.tri))
    for got, want in ((hv.t, jh.t), (hv.u, jh.u), (hv.v, jh.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert hv.tri.dtype == torch.int32
    assert n_tris < 100 or int((hv.tri >= 0).sum()) > 0


@pytest.mark.parametrize("n_tris", [300, 1000])
def test_occluded_exact_against_brute_and_pts(n_tris):
    (v, t, o, d), tree, jtree = _walks(n_tris, seed=7)
    T = torch.as_tensor
    dist = torch.full((512,), 8.0)
    ov = ttrav.bvh_occluded(tree, T(v), T(t), T(o), T(d), dist)
    ob = intersect_brute(T(v), T(t), T(o), T(d), tmax=dist).is_hit
    assert torch.equal(ov, ob)
    jo = jtrav.bvh_occluded(jtree, jnp.asarray(v), jnp.asarray(t),
                            jnp.asarray(o), jnp.asarray(d),
                            jnp.full((512,), 8.0))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jo))
    assert 0 < int(ov.sum()) < 512


def test_condition_every_k_steps_is_bit_equal():
    """The loops' conditions tested every step (as `pt`'s while_loops do)
    or every 8: the same hits bit for bit, with fewer host syncs."""
    (v, t, o, d), tree, _ = _walks(1000)
    T = torch.as_tensor
    runs = {}
    for k in (1, 8):
        ttrav.reset_stats()
        hit = ttrav.bvh_closest(tree, T(v), T(t), T(o), T(d), check_every=k)
        occ = ttrav.bvh_occluded(tree, T(v), T(t), T(o), T(d), 6.0,
                                 check_every=k)
        runs[k] = (hit, occ, dict(ttrav.stats))
    (h1, o1, s1), (h8, o8, s8) = runs[1], runs[8]
    for a, b in zip(h1, h8):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(o1, o8)
    assert s8["syncs"] * 3 < s1["syncs"], (s1, s8)
    assert s8["steps"] >= s1["steps"] and s1["traces"] == s8["traces"] == 2
    with pytest.raises(ValueError, match="check_every"):
        ttrav.bvh_closest(tree, T(v), T(t), T(o), T(d), check_every=0)


def test_convert_carries_pts_tree():
    """`convert.threaded_bvh` of `pt`'s tree walks like the port's own."""
    (v, t, o, d), tree, jtree = _walks(300)
    T = torch.as_tensor
    conv = convert.threaded_bvh(
        {f.name: (np.asarray(getattr(jtree, f.name))
                  if f.name in ARRAYS else getattr(jtree, f.name))
         for f in dataclasses.fields(jtree)}, device="cpu")
    _assert_arrays_equal(conv, jtree)
    a = ttrav.bvh_closest(conv, T(v), T(t), T(o), T(d))
    b = ttrav.bvh_closest(tree, T(v), T(t), T(o), T(d))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


SCENES = {
    "default": (tex_.make_default_scene, jex.make_default_scene),
    "animated": (lambda: chip_smoke.build_animated_scene(_ns("pt_torch"), 12),
                 lambda: chip_smoke.build_animated_scene(_ns("pt"), 12)),
    "static_alpha": (
        lambda: chip_smoke.build_animated_scene(_ns("pt_torch"), 12, 40,
                                                False),
        lambda: chip_smoke.build_animated_scene(_ns("pt"), 12, 40, False)),
}


def _film(r, scene, width=24, spp=2, frames=1):
    r.set_scene(scene, stream_textures=False)
    r.on_resize(width, width)
    for _ in range(frames):
        r.update_scene_data(scene_changed=scene.update(1.0 / 24.0))
        r.render(spp)
    film = r.film_mean()
    assert np.isfinite(film).all() and film.max() > 0
    return film


@pytest.mark.parametrize("case", list(SCENES))
def test_bvh_renderer_matches_pt(case, monkeypatch):
    t_fn, j_fn = SCENES[case]
    frames = 2 if case == "animated" else 1
    jr = JRenderer(jint.PathTracingSettings(sample_count=1, bounce_count=3,
                                            backend="bvh"))
    want = _film(jr, j_fn(), frames=frames)
    assert isinstance(jr.accel.bvh, jlbvh.ThreadedBVH)
    builds = []
    orig = tint.build_bvh
    with monkeypatch.context() as m:
        _forbid(m, KERNELS)
        m.setattr(tint, "build_bvh",
                  lambda *a: builds.append(a[2]) or orig(*a))
        r = Renderer(BVH, device="cpu")
        got = _film(r, t_fn(), frames=frames)
    assert isinstance(r.accel.bvh, tint.ThreadedTriangles)
    assert r.accel.alpha_split is None          # as pt's LBVH path
    # static: built once; animated: once a frame
    assert builds == [4] * frames
    if case == "default":
        # a still scene's world positions are bit-equal to pt's, so is its
        # tree; an animated frame's transforms differ by ulps
        _assert_arrays_equal(r.accel.bvh.bvh, jr.accel.bvh)
    mse = float(np.mean((got - want) ** 2))
    assert mse < FILM_MSE, mse
    assert abs(r.rays_traced - jr.rays_traced) <= 0.01 * jr.rays_traced


def test_render_image_stats_bvh_matches_pt(monkeypatch):
    scene, jscene = tex_.make_default_scene(), jex.make_default_scene()
    for s in (scene, jscene):
        s.cameras[0].on_resize(24, 24)
    cam, jcam = scene.cameras[0], jscene.cameras[0]
    _forbid(monkeypatch, KERNELS)
    img, rays = tint.render_image_stats(
        flatten_scene(scene, device="cpu"),
        build_scene_textures(scene, device="cpu"), cam.inv_view,
        cam.inv_proj, 24, 24, 0, BVH, device="cpu")
    jimg, jrays = jint.render_image_stats(
        j_flatten(jscene), j_textures(jscene),
        jnp.asarray(jcam.inv_view, jnp.float32),
        jnp.asarray(jcam.inv_proj, jnp.float32), 24, 24, jnp.uint32(0),
        jint.PathTracingSettings(sample_count=1, bounce_count=3,
                                 backend="bvh"))
    img = img.numpy()
    assert np.isfinite(img).all() and img.max() > 0
    assert float(np.mean((img - np.asarray(jimg)) ** 2)) < FILM_MSE
    assert abs(int(rays) - int(jrays)) <= 0.01 * int(jrays)


def test_leaf_size_change_rebuilds(monkeypatch):
    r = Renderer(BVH, device="cpu")
    r.set_scene(tex_.make_default_scene(), stream_textures=False)
    r.on_resize(8, 8)
    r.render(1)
    assert r.accel.bvh.bvh.leaf_size == 4
    r.set_settings(dataclasses.replace(BVH, bounce_count=2))
    assert not r._accel_dirty                      # same tree
    r.set_settings(dataclasses.replace(BVH, bvh_leaf_size=8))
    assert r._accel_dirty and r.total_samples == 0
    r.render(1)
    tree = r.accel.bvh.bvh
    assert tree.leaf_size == 8 and tree.leaf_tris.shape[1] == 8
    r.set_settings(dataclasses.replace(BVH, backend="brute"))
    r.render(1)
    assert isinstance(r.accel.bvh, tint.BruteTriangles)


def _failing_subset(monkeypatch, n_rows):
    """Make the SBVH build fail for any triangle set of `n_rows` rows."""
    orig = trenderer.build_packet_bvh_sah

    def build(wpos, rows, *a, **kw):
        return None if len(rows) == n_rows else orig(wpos, rows, *a, **kw)
    monkeypatch.setattr(trenderer, "build_packet_bvh_sah", build)


@pytest.mark.parametrize("failing", ["alpha", "opaque"])
def test_failed_subset_tree_gets_the_morton_tree(failing, monkeypatch):
    """`pt`'s rule: the split stays, and the subset without a tree gets its
    Morton `PacketBVH` over the scene's rows of the subset, built on the
    device: no brute force runs. The film agrees with `pt`'s brute film,
    whose split finds the same hits."""
    t_fn, j_fn = SCENES["static_alpha"]
    monkeypatch.setattr(Renderer, "_accel_cache", None)
    scene = t_fn()
    opq = flatten_scene(scene, device="cpu").tri_opaque.numpy()
    sel = {"opaque": np.nonzero(opq)[0], "alpha": np.nonzero(~opq)[0]}
    assert 0 < len(sel["alpha"]) <= trenderer._FAILED_SUBSET_MAX
    _failing_subset(monkeypatch, len(sel[failing]))
    built = []
    real_morton = trenderer.build_packet_bvh

    def morton(wpos, tri_idx, **kw):
        built.append((tri_idx, kw["tri_opaque"]))
        return real_morton(wpos, tri_idx, **kw)
    monkeypatch.setattr(trenderer, "build_packet_bvh", morton)
    brute = []
    real_brute = tint.intersect_brute
    monkeypatch.setattr(tint, "intersect_brute", lambda *a, **k: (
        brute.append(1), real_brute(*a, **k))[1])
    r = Renderer(dataclasses.replace(BVH, backend="pallas"), device="cpu")
    got = _film(r, scene)
    split = r.accel.alpha_split
    assert split is not None
    subset = {"opaque": split.bvh_opaque, "alpha": split.bvh_alpha}
    other = "opaque" if failing == "alpha" else "alpha"
    assert type(subset[failing]).__name__ == "PacketBVH"
    assert type(subset[other]).__name__ == "BF8BVH"
    assert np.array_equal(split.sel_opaque.numpy(), sel["opaque"])
    assert np.array_equal(split.sel_alpha.numpy(), sel["alpha"])
    sel_f = split.sel_alpha if failing == "alpha" else split.sel_opaque
    assert len(built) == 1
    assert torch.equal(built[0][0], r.ds.tri_idx[sel_f.long()])
    assert torch.equal(built[0][1], r.ds.tri_opaque[sel_f.long()])
    assert not brute
    jr = JRenderer(jint.PathTracingSettings(sample_count=1, bounce_count=3,
                                            backend="brute"))
    want = _film(jr, j_fn())
    jsplit = jr.accel.alpha_split
    assert np.array_equal(np.asarray(jsplit.sel_alpha), sel["alpha"])
    assert float(np.mean((got - want) ** 2)) < FILM_MSE


def test_failed_subset_past_the_cap_drops_the_split(monkeypatch):
    t_fn, _ = SCENES["static_alpha"]
    monkeypatch.setattr(Renderer, "_accel_cache", None)
    scene = t_fn()
    opq = flatten_scene(scene, device="cpu").tri_opaque.numpy()
    _failing_subset(monkeypatch, int((~opq).sum()))
    monkeypatch.setattr(trenderer, "_FAILED_SUBSET_MAX", int((~opq).sum()) - 1)
    r = Renderer(dataclasses.replace(BVH, backend="pallas"), device="cpu")
    _film(r, scene, width=8, spp=1)
    assert r.accel.alpha_split is None
