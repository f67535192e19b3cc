"""The port `Renderer`'s static-accel cache on the CPU, after `pt`'s
(`pt/run/renderer.py:551-753`).

* A second renderer on the same scene builds nothing (the SBVH builder is
  patched to raise), and hands out the very trees of the first.
* The MetallicRoughness Cubes scene, whose frames move only a light,
  builds its trees once over two frames.
* The key leads with the device: a renderer on another device misses the
  cache, so a tree built for one device is never handed to another.
* The shared-BLAS entries: the instanced alpha trees come back from the
  cache without a rebuild, and a scene whose instanced build is
  infeasible is negatively cached, so the next rebuild goes straight to
  flatten without walking the scene (`pt`'s
  `tests/test_instanced.py::test_renderer_build_instanced_alpha_and_negative_cache`).
"""

import pytest
import torch

import chip_smoke
from pt_torch.accel.instanced import BF8Instanced
from pt_torch.render.integrator import PathTracingSettings, prepare_attribs
from pt_torch.run import renderer as TR
from pt_torch.scene.examples import TEST_SCENES, make_heightfield_scene
from pt_torch.scene.flatten import flatten_scene


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch):
    monkeypatch.setattr(TR.Renderer, "_accel_cache", None)


class _Built(Exception):
    pass


def _counting_builder(monkeypatch, fail=False):
    """Wrap the SBVH builder the renderer calls: count its calls, or raise
    at the first one."""
    calls = []
    real = TR.build_packet_bvh_sah

    def builder(*args, **kw):
        if fail:
            raise _Built("the SBVH builder ran")
        calls.append(kw.get("device"))
        return real(*args, **kw)
    monkeypatch.setattr(TR, "build_packet_bvh_sah", builder)
    return calls


def _renderer(scene, device="cpu", **kw):
    r = TR.Renderer(PathTracingSettings(bounce_count=2), device=device, **kw)
    r.set_scene(scene, stream_textures=False)
    r.on_resize(8, 8)
    return r


def test_second_renderer_on_the_same_scene_builds_nothing(monkeypatch):
    first = _renderer(make_heightfield_scene(16))
    first._ensure_accel()
    assert type(first.accel.bvh).__name__ == "BF8BVH"
    _counting_builder(monkeypatch, fail=True)
    second = _renderer(make_heightfield_scene(16))
    second.render(1)
    assert second.accel.bvh is first.accel.bvh
    # other geometry is another key
    third = _renderer(make_heightfield_scene(17))
    with pytest.raises(_Built):
        third._ensure_accel()


def test_metallic_roughness_cubes_build_once_over_two_frames(monkeypatch):
    calls = _counting_builder(monkeypatch)
    scene = TEST_SCENES["MetallicRoughness Cubes"]()
    assert not (scene.has_animated_instances or scene.has_skinned_geometry)
    r = _renderer(scene)
    r.render(1)
    built = len(calls)
    tree = r.accel.bvh
    assert built > 0
    light = r.ds.point_light_pos.clone()
    for _ in range(2):
        assert scene.update(1.0 / 24.0)           # the light moves
        r.update_scene_data(scene_changed=True)
        assert r._accel_dirty and r.total_samples == 0
        r.render(1)
        assert len(calls) == built and r.accel.bvh is tree
    assert not torch.equal(light, r.ds.point_light_pos)


def test_the_key_carries_the_device(monkeypatch):
    r = _renderer(make_heightfield_scene(16))
    r._ensure_accel()
    (key,) = [k for k in TR.Renderer._accel_cache._data
              if k[-1] != "instanced"]
    assert key[0] == "cpu"
    _counting_builder(monkeypatch, fail=True)
    same = _renderer(make_heightfield_scene(16))
    same._ensure_accel()                          # this device: a hit
    assert same.accel.bvh is r.accel.bvh
    elsewhere = _renderer(make_heightfield_scene(16))
    elsewhere.device = torch.device("cpu", 1)     # as if on another device
    with pytest.raises(_Built):
        elsewhere._ensure_accel()


def test_instanced_alpha_trees_and_the_negative_cache():
    scene = chip_smoke.build_instanced_scene(chip_smoke.port_namespace(), 5,
                                             10, True)
    r = TR.Renderer(PathTracingSettings(), device="cpu", instancing="shared")
    r.scene = scene
    r.ds = flatten_scene(scene, device="cpu")
    base = prepare_attribs(r.ds)
    tri_np = r.ds.tri_idx.numpy()
    opq_np = r.ds.tri_opaque.numpy()
    TR.Renderer._accel_cache = TR.LRUCache(4)

    def build_static(rows, opq_rows):             # the flat-subset fallback
        raise AssertionError("the instanced subset builds should succeed")

    accel = r._build_instanced(("k",), tri_np, opq_np, build_static, base)
    assert isinstance(accel.bvh, BF8Instanced)
    assert isinstance(accel.alpha_split.bvh_opaque, BF8Instanced)
    assert isinstance(accel.alpha_split.bvh_alpha, BF8Instanced)
    # served from the cache: the scene is not walked again
    r.scene = None
    again = r._build_instanced(("k",), tri_np, opq_np, build_static, base)
    assert again.bvh is accel.bvh

    # an animated geometry has no shared layout: infeasible, and cached so
    scene2 = chip_smoke.build_instanced_scene(chip_smoke.port_namespace(), 5,
                                              10, True)
    scene2.geometries[0].is_animated = True
    r2 = TR.Renderer(PathTracingSettings(), device="cpu",
                     instancing="shared")
    r2.scene = scene2
    r2.ds = flatten_scene(scene2, device="cpu")
    assert r2._build_instanced(("k2",), tri_np, opq_np, build_static,
                               base) is None
    assert TR.Renderer._accel_cache.get((("k2",), "instanced")) \
        == TR.Renderer._INFEASIBLE
    r2.scene = None                               # a re-walk would crash
    assert r2._build_instanced(("k2",), tri_np, opq_np, build_static,
                               base) is None


def test_infeasible_instanced_scene_flattens_without_a_retry(monkeypatch):
    """Through `_ensure_accel`: the negative entry sends the second build
    of an infeasible scene straight to the flatten entry."""
    scene = chip_smoke.build_instanced_scene(chip_smoke.port_namespace(), 5,
                                             10, False)
    r = _renderer(scene, instancing="shared")
    attempts = []
    monkeypatch.setattr(TR, "build_instanced_bf8",
                        lambda *a, **kw: attempts.append(1))   # infeasible
    r._ensure_accel()
    assert attempts == [1] and type(r.accel.bvh).__name__ == "BF8BVH"
    flat_tree = r.accel.bvh
    r._accel_dirty = True
    r._ensure_accel()
    assert attempts == [1] and r.accel.bvh is flat_tree
