"""`pt`'s two lane-order knobs, `sort_rays` and `shade_sorted`, on the CPU.

Both only reorder lanes, so each film is bit-equal to the default film (as
`tests/test_render.py:314` holds `pt`'s `shade_sorted` to its default):

* `sort_rays` traces a tail bounce's closest and shadow rays in coherence
  order over a PacketBVH (an animated scene's Morton tree, K3/K4's plain
  versions here) and scatters the hits back; the kernels give each ray the
  same hit whatever its neighbours. It is inert on the wide structures and
  on alpha scenes, as in `pt`, and `render_image_stats` sorts every bounce.
* `shade_sorted` shades the lanes in material order and permutes the
  payload back: the Default (textures, several materials), the static alpha
  variant (decals) and the animated Heightfield.

The settings carry over from `pt` through `convert.path_tracing_settings`,
and the port's `shade_sorted` film agrees with `pt`'s within the film bar.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from pt.render import integrator as jint
from pt.run.renderer import Renderer as JRenderer
from pt.scene import examples as jex
from pt_torch import convert
from pt_torch.accel.bvh8 import BF8BVH, PacketBVH
from pt_torch.render import integrator as tint
from pt_torch.run.renderer import Renderer
from pt_torch.scene import examples as tex_
from pt_torch.scene.flatten import flatten_scene
from pt_torch.scene.textures import build_scene_textures

from test_torch_animated import _ns
from torch_threads import one_torch_thread  # noqa: F401

FILM_MSE = 1e-3
BASE = tint.PathTracingSettings(sample_count=2, bounce_count=4)

SCENES = {
    "default": tex_.make_default_scene,
    "animated": lambda: chip_smoke.build_animated_scene(_ns("pt_torch"), 12),
    "static_alpha": lambda: chip_smoke.build_animated_scene(
        _ns("pt_torch"), 12, 40, False),
}


def _accum(settings, scene_fn, width=32, frames=2, spp=4):
    """The film after `frames` steps of `spp` (an animated scene moves
    before each), and the renderer."""
    r = Renderer(settings, device="cpu")
    scene = scene_fn()
    r.set_scene(scene, stream_textures=False)
    r.on_resize(width, width)
    for _ in range(frames):
        r.update_scene_data(scene_changed=scene.update(1.0 / 24.0))
        r.render(spp)
    assert np.isfinite(r.film_mean()).all() and r.accum.max() > 0
    return r.accum.clone(), r


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(tint, name)
    monkeypatch.setattr(tint, name,
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


def _bit_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_sort_rays_is_bit_equal_on_the_morton_tree(monkeypatch):
    want, r0 = _accum(BASE, SCENES["animated"])
    assert isinstance(r0.accel.bvh, PacketBVH)
    keys = _spy(monkeypatch, "_coherence_keys")
    got, r1 = _accum(dataclasses.replace(BASE, sort_rays=True),
                     SCENES["animated"])
    # tails only: per frame 3 tail bounces of each of 4 samples
    assert len(keys) == 2 * 4 * 3
    assert _bit_equal(got, want)
    assert r1.rays_traced == r0.rays_traced


@pytest.mark.parametrize("case", ["default", "static_alpha"])
def test_sort_rays_is_inert_off_the_binary_tree(case, monkeypatch):
    """Wide trees (and alpha scenes) take no coherence sort, as in `pt`."""
    want, r0 = _accum(BASE, SCENES[case], frames=1)
    assert isinstance(r0.accel.bvh, BF8BVH)
    keys = _spy(monkeypatch, "_coherence_keys")
    got, _ = _accum(dataclasses.replace(BASE, sort_rays=True), SCENES[case],
                    frames=1)
    assert not keys
    assert _bit_equal(got, want)


def test_render_image_stats_sorts_every_bounce(monkeypatch):
    """The single-call render sorts the primary bounce too (`pt`'s
    `render_flat` passes its default `sort_rays=True` to `bounce_once`)."""
    scene = SCENES["animated"]()
    scene.update(1.0 / 24.0)
    cam = scene.cameras[0]
    cam.on_resize(24, 24)
    ds = flatten_scene(scene, device="cpu")
    tex = build_scene_textures(scene, device="cpu")
    films = []
    for sort in (False, True):
        keys = _spy(monkeypatch, "_coherence_keys")
        img, rays = tint.render_image_stats(
            ds, tex, cam.inv_view, cam.inv_proj, 24, 24, 3,
            dataclasses.replace(BASE, sort_rays=sort), device="cpu")
        assert len(keys) == (2 * 4 if sort else 0)
        films.append((img, int(rays)))
    assert _bit_equal(films[0][0], films[1][0])
    assert films[0][1] == films[1][1]


@pytest.mark.parametrize("case", list(SCENES))
def test_shade_sorted_is_bit_equal(case, monkeypatch):
    want, r0 = _accum(BASE, SCENES[case])
    sorts = _spy(monkeypatch, "_shade_sorted")
    got, r1 = _accum(dataclasses.replace(BASE, shade_sorted=True),
                     SCENES[case])
    assert sorts                        # every bounce went through it
    assert _bit_equal(got, want)
    assert r1.rays_traced == r0.rays_traced


def test_both_knobs_together_are_bit_equal():
    want, _ = _accum(BASE, SCENES["animated"], frames=1)
    got, _ = _accum(dataclasses.replace(BASE, sort_rays=True,
                                        shade_sorted=True),
                    SCENES["animated"], frames=1)
    assert _bit_equal(got, want)


def test_settings_carry_over_from_pt():
    for kw in (dict(sort_rays=True), dict(shade_sorted=True),
               dict(bvh_leaf_size=8, backend="bvh"),
               dict(sort_rays=True, shade_sorted=True, bvh_leaf_size=2)):
        js = jint.PathTracingSettings(**kw)
        got = convert.path_tracing_settings(dataclasses.asdict(js))
        assert got == tint.PathTracingSettings(**kw)
    assert ({f.name for f in dataclasses.fields(tint.PathTracingSettings)}
            == {f.name for f in dataclasses.fields(jint.PathTracingSettings)})
    assert (dataclasses.asdict(tint.PathTracingSettings())
            == dataclasses.asdict(jint.PathTracingSettings()))


def test_shade_sorted_film_matches_pt():
    settings = dataclasses.replace(BASE, sample_count=1, bounce_count=3,
                                   shade_sorted=True)
    r = Renderer(settings, device="cpu")
    r.set_scene(tex_.make_default_scene(), stream_textures=False)
    r.on_resize(24, 24)
    r.render(2)
    jr = JRenderer(jint.PathTracingSettings(sample_count=1, bounce_count=3,
                                            shade_sorted=True))
    jr.set_scene(jex.make_default_scene(), stream_textures=False)
    jr.on_resize(24, 24)
    jr.render(2)
    mse = float(np.mean((r.film_mean() - np.asarray(jr.film_mean())) ** 2))
    assert mse < FILM_MSE, mse
