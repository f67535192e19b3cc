"""The port's debug renderer against `pt`'s on the CPU.

* Every mode with no flag and with each of the four flags, on the Default
  at 48² (`tests/test_debug_flags.py`'s size) with its textures: the port's
  brute backend against `pt`'s (`render_debug_image`'s default in both):
  the id modes (GEOMETRY, PRIMITIVE, INSTANCE) bit-equal, the others within
  1e-5; the port's kernel backend ("pallas": the Morton tree through K3/K4's
  plain versions) against `pt`'s brute frame: at most 0.5% of the pixels
  off by more than 1e-4 (near-edge lanes).
* An alpha-tested scene: the see-through frame (the single-tree alpha loop)
  and the force-opaque frame both match `pt`'s, and differ from each other.
* The MIPS heatmap: the LOD of the color texture on a textured pool, the
  distance stand-in on a constant one, both as `pt`'s.
* `_id_color` is bit-equal to `pt`'s on ids up to 2^32 - 1; the converters
  carry `pt`'s modes, flags and settings.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from pt.render import debug as jdebug
from pt.render.integrator import PathTracingSettings as JSettings
from pt.render.textures import default_texture_pool as j_default_pool
from pt.scene.flatten import flatten_scene as j_flatten
from pt.scene.textures import build_scene_textures as j_textures
from pt_torch import convert
from pt_torch.render import debug as tdebug
from pt_torch.render.integrator import PathTracingSettings
from pt_torch.render.textures import default_texture_pool as t_default_pool
from pt_torch.scene.flatten import flatten_scene as t_flatten
from pt_torch.scene.textures import build_scene_textures as t_textures

from test_torch_animated import _ns
from torch_threads import one_torch_thread  # noqa: F401


W = 48
FLAGS = [{}, {"force_opaque": True}, {"cull_backfaces": True},
         {"disable_color_texture": True}, {"disable_shadows": True}]
ID_MODES = {"GEOMETRY", "PRIMITIVE", "INSTANCE"}
PALLAS = convert.path_tracing_settings(
    dataclasses.asdict(JSettings(backend="pallas")))


def _state(build, constant_pool=False, width=W):
    """(pt side, port side): each (scene, tex, inv_view, inv_proj) for the
    scene `build(package)` at width², from the same seeded construction."""
    out = []
    for pkg, flatten, textures, pool in (
            ("pt", j_flatten, j_textures, j_default_pool),
            ("pt_torch", lambda s: t_flatten(s, device="cpu"),
             lambda s: t_textures(s, device="cpu"),
             lambda: t_default_pool(device="cpu"))):
        scene = build(pkg)
        cam = scene.cameras[0]
        cam.on_resize(width, width)
        tex = pool() if constant_pool or not scene.textures else \
            textures(scene)
        out.append((flatten(scene), tex,
                    np.asarray(cam.inv_view, np.float32),
                    np.asarray(cam.inv_proj, np.float32)))
    return out


def _default(pkg):
    return importlib.import_module(
        f"{pkg}.scene.examples").make_default_scene()


@pytest.fixture(scope="module")
def default_state():
    return _state(_default)


def _pt_frame(j, mode, width=W, **flags):
    ds, tex, iv, ip = j
    return np.asarray(jdebug.render_debug_image(
        ds, tex, iv, ip, width, width, jdebug.DebugRenderMode[mode],
        flags=jdebug.DebugFlags(**flags)))


def _port_frame(t, mode, width=W, settings=None, **flags):
    """The port's frame for `pt`'s mode and flags, carried across by
    `pt_torch.convert`."""
    ds, tex, iv, ip = t
    kw = {} if settings is None else {"settings": settings}
    img = tdebug.render_debug_image(
        ds, tex, iv, ip, width, width,
        convert.debug_mode(jdebug.DebugRenderMode[mode]),
        flags=convert.debug_flags(dataclasses.asdict(
            jdebug.DebugFlags(**flags))), device="cpu", **kw)
    assert img.shape == (width, width, 3) and img.dtype == torch.float32
    return img.numpy()


def _off_share(a, b, tol=1e-4):
    return float(np.mean(np.abs(a - b).max(axis=-1) > tol))


@pytest.mark.parametrize("flags", FLAGS,
                         ids=lambda f: next(iter(f), "no_flag"))
@pytest.mark.parametrize("mode", [m.name for m in tdebug.DebugRenderMode])
def test_debug_frame_matches_pt(default_state, mode, flags):
    j, t = default_state
    want = _pt_frame(j, mode, **flags)
    brute = _port_frame(t, mode, **flags)
    if mode in ID_MODES:
        assert np.array_equal(brute, want)
    else:
        assert np.abs(brute - want).max() <= 1e-5
    assert _off_share(_port_frame(t, mode, settings=PALLAS, **flags),
                      want) <= 0.005
    background = np.asarray([0.1, 0.1, 0.12], np.float32)
    assert not (brute == background).all(axis=-1).all()   # something is hit


@pytest.fixture(scope="module")
def alpha_state():
    return _state(lambda pkg: chip_smoke.build_animated_scene(
        _ns(pkg), 8, 24, False), width=32)


@pytest.mark.parametrize("mode", ["COLOR", "PRIMITIVE"])
def test_alpha_scene_see_through_and_force_opaque(alpha_state, mode):
    """The alpha scene's see-through frame runs `trace_closest_alpha`'s
    single-tree loop (no split in a debug accel), the force-opaque frame
    one closest trace; both as `pt`'s, and they differ."""
    j, t = alpha_state
    assert j[0].has_alpha and t[0].has_alpha
    frames = {}
    for opaque in (False, True):
        want = _pt_frame(j, mode, width=32, force_opaque=opaque)
        got = _port_frame(t, mode, width=32, force_opaque=opaque)
        if mode in ID_MODES:
            assert np.array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-5
        assert _off_share(_port_frame(t, mode, width=32, settings=PALLAS,
                                      force_opaque=opaque), want) <= 0.005
        frames[opaque] = got
    assert _off_share(frames[False], frames[True]) > 0.01


def test_mips_lod_on_textured_and_constant_pools(default_state):
    """A textured pool gives the color texture's LOD, a constant pool the
    distance stand-in; the two heatmaps differ, each as `pt`'s."""
    j, t = default_state
    assert not t[1].all_constant and not j[1].all_constant
    jc, tc = _state(_default, constant_pool=True)
    assert tc[1].all_constant and jc[1].all_constant
    lod = _port_frame(t, "MIPS")
    stand_in = _port_frame(tc, "MIPS")
    assert np.abs(stand_in - _pt_frame(jc, "MIPS")).max() <= 1e-5
    assert np.abs(lod - _pt_frame(j, "MIPS")).max() <= 1e-5
    assert _off_share(lod, stand_in, 1e-3) > 0.1


def test_id_color_bit_equal_to_pt():
    ids = np.concatenate([np.arange(1000, dtype=np.uint32),
                          np.random.default_rng(5).integers(
                              0, 2**32, 4000, dtype=np.uint64).astype(
                                  np.uint32),
                          np.array([2**32 - 1, 2**32 - 2], np.uint32)])
    want = np.asarray(jdebug._id_color(ids))
    got = tdebug._id_color(torch.as_tensor(ids.astype(np.int64))).numpy()
    assert np.array_equal(got, want)


def test_convert_carries_modes_flags_and_settings():
    for m in jdebug.DebugRenderMode:
        assert convert.debug_mode(m) == tdebug.DebugRenderMode[m.name]
    jf = jdebug.DebugFlags(cull_backfaces=True, disable_shadows=True)
    assert convert.debug_flags(dataclasses.asdict(jf)) == tdebug.DebugFlags(
        cull_backfaces=True, disable_shadows=True)
    js = JSettings(sample_count=2, bounce_count=3, backend="brute")
    got = convert.path_tracing_settings(dataclasses.asdict(js))
    assert got == PathTracingSettings(sample_count=2, bounce_count=3,
                                      backend="brute")
    assert tdebug.render_debug_image.__defaults__[0].backend == "brute"
    js = JSettings(sort_rays=True, shade_sorted=True, bvh_leaf_size=8)
    assert convert.path_tracing_settings(dataclasses.asdict(js)) == \
        PathTracingSettings(sort_rays=True, shade_sorted=True,
                            bvh_leaf_size=8)
