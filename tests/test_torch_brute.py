"""The port's brute backend against `pt`'s on the CPU.

* `Renderer` with `backend="brute"` against `pt`'s brute `Renderer`, 24²,
  2 spp, 3 bounces: the Default scene, and the static alpha variant with
  `pt`'s brute opaque/alpha split. Bar: film MSE < 1e-3, the project's film
  contract. The port's kernel backend ("pallas": the SBVH/BF8 trees through
  K1/K2's plain versions here) renders the same films within that bar.
* `render_image_stats` at `__graft_entry__.entry()`'s settings (the
  textured Default, 32², 1 spp, 3 bounces, brute) against `pt`'s: film MSE
  < 1e-3 and the same ray count.
* No fallback: brute reaches no kernel wrapper, the kernel backend never
  reaches brute force, "bvh" builds the threaded LBVH, and an unknown
  backend raises.
* A change of backend through `set_settings` rebuilds the accel; the
  brute accel stays out of the accel cache (as in `pt`), and changing back
  hits the kernel backend's cached tree.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from pt.render import integrator as jint
from pt.run.renderer import Renderer as JRenderer
from pt.scene import examples as jex
from pt.scene.flatten import flatten_scene as j_flatten
from pt.scene.textures import build_scene_textures as j_textures
from pt_torch.accel.bvh8 import BF8BVH
from pt_torch.render import integrator as tint
from pt_torch.run.renderer import Renderer
from pt_torch.scene import examples as tex_
from pt_torch.scene.flatten import flatten_scene
from pt_torch.scene.textures import build_scene_textures

from test_torch_animated import _ns
from torch_threads import one_torch_thread  # noqa: F401


FILM_MSE = 1e-3
BRUTE = tint.PathTracingSettings(sample_count=1, bounce_count=3,
                                 backend="brute")
KERNELS = ("closest_bf8", "occluded_bf8", "closest_v4", "occluded_v4")


def _forbid(monkeypatch, names):
    """Calling any of the integrator's functions `names` fails the test."""
    def boom(*args, **kwargs):
        raise AssertionError(f"one of {names} was called")
    for name in names:
        monkeypatch.setattr(tint, name, boom)


SCENES = {
    "default": (tex_.make_default_scene, jex.make_default_scene),
    "static_alpha": (
        lambda: chip_smoke.build_animated_scene(_ns("pt_torch"), 12, 40,
                                                False),
        lambda: chip_smoke.build_animated_scene(_ns("pt"), 12, 40, False)),
}


def _film(r, scene, width=24, spp=2):
    r.set_scene(scene, stream_textures=False)
    r.on_resize(width, width)
    r.render(spp)
    film = r.film_mean()
    assert np.isfinite(film).all() and film.max() > 0
    return film


@pytest.mark.parametrize("case", list(SCENES))
def test_brute_renderer_matches_pt(case, monkeypatch):
    t_fn, j_fn = SCENES[case]
    jr = JRenderer(jint.PathTracingSettings(sample_count=1, bounce_count=3,
                                            backend="brute"))
    want = _film(jr, j_fn())
    with monkeypatch.context() as m:
        _forbid(m, KERNELS)
        r = Renderer(BRUTE, device="cpu")
        got = _film(r, t_fn())
    assert isinstance(r.accel.bvh, tint.BruteTriangles)
    mse = float(np.mean((got - want) ** 2))
    assert mse < FILM_MSE, mse
    assert abs(r.rays_traced - jr.rays_traced) <= 0.01 * jr.rays_traced
    split = r.accel.alpha_split
    if case == "static_alpha":
        assert split is not None and jr.accel.alpha_split is not None
        assert isinstance(split.bvh_opaque, tint.BruteTriangles)
        jsplit = jr.accel.alpha_split
        for ours, theirs in ((split.sel_opaque, jsplit.sel_opaque),
                             (split.sel_alpha, jsplit.sel_alpha)):
            assert np.array_equal(ours.numpy(), np.asarray(theirs))
        assert torch.equal(split.bvh_alpha.tri_idx,
                           r.ds.tri_idx[split.sel_alpha.long()])
    else:
        assert split is None
    # the kernel backend: its trees through the kernels' plain versions,
    # and no brute force
    with monkeypatch.context() as m:
        _forbid(m, ["intersect_brute"])
        rk = Renderer(dataclasses.replace(BRUTE, backend="pallas"),
                      device="cpu")
        kernel = _film(rk, t_fn())
    assert isinstance(rk.accel.bvh, BF8BVH)
    mse = float(np.mean((kernel - got) ** 2))
    assert mse < FILM_MSE, mse


def test_render_image_stats_brute_matches_pt_at_entry_settings(
        monkeypatch):
    """`entry()`'s call: the Default with its textures at 32², 1 spp, 3
    bounces, brute force in both packages."""
    scene, jscene = tex_.make_default_scene(), jex.make_default_scene()
    for s in (scene, jscene):
        s.cameras[0].on_resize(32, 32)
    cam, jcam = scene.cameras[0], jscene.cameras[0]
    _forbid(monkeypatch, KERNELS)
    img, rays = tint.render_image_stats(
        flatten_scene(scene, device="cpu"),
        build_scene_textures(scene, device="cpu"), cam.inv_view,
        cam.inv_proj, 32, 32, 0, BRUTE, device="cpu")
    jimg, jrays = jint.render_image_stats(
        j_flatten(jscene), j_textures(jscene),
        jnp.asarray(jcam.inv_view, jnp.float32),
        jnp.asarray(jcam.inv_proj, jnp.float32), 32, 32, jnp.uint32(0),
        jint.PathTracingSettings(sample_count=1, bounce_count=3,
                                 backend="brute"))
    img = img.numpy()
    assert np.isfinite(img).all() and img.max() > 0
    mse = float(np.mean((img - np.asarray(jimg)) ** 2))
    assert mse < FILM_MSE, mse
    assert int(rays) == int(jrays)


def test_unknown_and_later_backends_raise():
    """An unknown backend raises; "bvh" (queue 1, item 7, now ported)
    builds `pt`'s threaded LBVH and is taken by `set_settings`."""
    ds = flatten_scene(tex_.make_default_scene(), device="cpu")
    bvh = tint.PathTracingSettings(backend="bvh")
    accel = tint.prepare_accel(ds, bvh)
    assert isinstance(accel.bvh, tint.ThreadedTriangles)
    assert accel.bvh.bvh.leaf_size == bvh.bvh_leaf_size == 4
    with pytest.raises(ValueError, match="unknown backend"):
        tint.resolve_backend(tint.PathTracingSettings(backend="xla"))
    r = Renderer(device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        r.set_settings(tint.PathTracingSettings(backend="xla"))
    assert r.settings.backend == "pallas"
    r.set_settings(bvh)
    assert r.settings.backend == "bvh" and r._accel_dirty
    assert tint.PathTracingSettings().backend == "pallas"
    assert [tint.resolve_backend(tint.PathTracingSettings(backend=b))
            for b in ("pallas", "bvh", "brute")] == ["pallas", "bvh",
                                                     "brute"]


def test_backend_change_rebuilds_and_switching_back_hits_the_cache(
        monkeypatch):
    """pallas → brute → pallas on one renderer: the brute accel is built
    without touching the cache (no kernel runs, no entry added), and
    switching back finds the kernel backend's tree in the cache."""
    monkeypatch.setattr(Renderer, "_accel_cache", None)
    r = Renderer(dataclasses.replace(BRUTE, backend="pallas"), device="cpu")
    r.set_scene(tex_.make_default_scene(), stream_textures=False)
    r.on_resize(8, 8)
    r.render(1)
    tree = r.accel.bvh
    assert isinstance(tree, BF8BVH) and len(Renderer._accel_cache) == 1
    r.set_settings(BRUTE)
    assert r._accel_dirty and r.total_samples == 0
    with monkeypatch.context() as m:
        _forbid(m, KERNELS)
        r.render(1)
    assert isinstance(r.accel.bvh, tint.BruteTriangles)
    assert len(Renderer._accel_cache) == 1     # brute is never cached
    r.set_settings(dataclasses.replace(BRUTE, bounce_count=2))
    assert not r._accel_dirty                  # same backend: no rebuild
    r.set_settings(dataclasses.replace(BRUTE, backend="pallas"))
    assert r._accel_dirty
    r.render(1)
    assert r.accel.bvh is tree                 # a cache hit
    assert len(Renderer._accel_cache) == 1
