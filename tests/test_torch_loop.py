"""The port's render loop (`pt_torch.run.renderer`) against `pt`'s on the
CPU.

* Wavefront compaction: the films with compaction on and off (every size
  class patched huge, as `pt`'s own test does) are bit-equal, with a plan
  that compacts (`min(plan) <= 1152` at 48², and `_compact` called).
* spp-major groups: two `render(4)` steps are bit-equal to eight
  `render(1)` calls, ray count included, and the sequence of group sizes (and which group
  may observe the plan) equals `pt`'s for several (film, samples) pairs,
  with the rendering itself patched out on both sides.
* The helpers `_size_class`, `_largest_remainder_alloc`,
  `_rep_major_stream`, `LRUCache` and `fnv1a` equal `pt`'s on seeded
  inputs; the ray-chunk fold keeps the count.
* Films through the new loop, compaction engaged (48², two steps of 2
  spp), against `pt`'s Renderer on its brute backend: the Default and
  the Heightfield (n=16), MSE < 1e-3, the project's film contract.
"""

import numpy as np
import pytest
import torch

from pt.core import cache as jcache
from pt.render import integrator as jint
from pt.run import renderer as JR
from pt.scene import examples as jex
from pt_torch.core import cache as tcache
from pt_torch.render.integrator import PathTracingSettings
from pt_torch.run import renderer as TR
from pt_torch.scene import examples as tex_

from torch_threads import one_torch_thread  # noqa: F401


FILM_MSE = 1e-3


def _port(scene, size=48, bounces=5, spp=1):
    r = TR.Renderer(PathTracingSettings(sample_count=spp,
                                        bounce_count=bounces), device="cpu")
    r.set_scene(scene, stream_textures=False)
    r.on_resize(size, size)
    return r


def test_compaction_on_and_off_give_bit_equal_films(monkeypatch):
    compacted = []
    real = TR._compact

    def spy(carry, k):
        compacted.append(k)
        return real(carry, k)
    monkeypatch.setattr(TR, "_compact", spy)
    r = _port(tex_.make_default_scene())
    r.render(2)                        # sample 0 observes, 1 compacts
    r.render(2)                        # both compact by the plan
    plan = r._plans.get(("tail", 48 * 48))
    assert plan is not None and min(plan) <= 1152, plan
    assert compacted and max(compacted) <= 1152
    with_compaction = r.accum.clone()
    rays = r.rays_traced

    monkeypatch.setattr(TR, "_size_class", lambda n, minimum=1024: 1 << 30)
    compacted.clear()
    r2 = _port(tex_.make_default_scene())
    r2.render(2)
    r2.render(2)
    assert not compacted
    assert torch.equal(with_compaction, r2.accum)
    assert r2.rays_traced == rays


def test_grouped_render_equals_single_samples():
    """render(4) runs one merged bounce 0 over 4 x 2304 lanes, then four
    compacted tails; four render(1) calls trace each sample alone."""
    grouped = _port(tex_.make_default_scene())
    grouped.render(4)                  # sample 0 observes
    grouped.render(4)                  # every sample compacts
    single = _port(tex_.make_default_scene())
    for _ in range(8):
        single.render(1)
    assert grouped.total_samples == single.total_samples == 8
    assert torch.equal(grouped.accum, single.accum)
    assert grouped.rays_traced == single.rays_traced


def _group_log(r, monkeypatch):
    """Patch the rendering out of `r.render`: record (g, rep0, observe_ok)
    of each group instead."""
    log = []
    monkeypatch.setattr(r, "_ensure_accel", lambda: None)
    monkeypatch.setattr(r, "_camera_mats", lambda: (None, None))
    monkeypatch.setattr(
        r, "_render_group",
        lambda g, rep0, iv, ip, *args, observe_ok=True, **kw:
        log.append((g, rep0, observe_ok)))
    return log


@pytest.mark.parametrize("w, h, samples", [
    (48, 48, (1, 2, 3, 4, 7, 8, 13)),
    (512, 512, (1, 3, 4, 5, 9)),
    (640, 480, (2, 3, 5)),
    (1024, 1024, (1, 3)),
    (2048, 1024, (2,)),
])
def test_group_sizes_equal_pts(monkeypatch, w, h, samples):
    t = TR.Renderer(device="cpu")
    j = JR.Renderer(jint.PathTracingSettings())
    logs = []
    for r in (t, j):
        r.on_resize(w, h)
        r.ds = object()
        logs.append(_group_log(r, monkeypatch))
    for n in samples:
        assert t.render(n) == j.render(n)
    assert logs[0] == logs[1] and logs[0]


def test_size_class_and_adaptive_helpers_equal_pts():
    for n in [0, 1, 2, 3, 1023, 1024, 1025, 2047, 2048, 4097, 262144,
              300000, 1 << 20]:
        assert TR._size_class(n) == JR._size_class(n)
        assert TR._size_class(n, 64) == JR._size_class(n, 64)
    rng = np.random.default_rng(13)
    for _ in range(40):
        n = int(rng.integers(1, 60))
        deficit = rng.integers(0, 50, n).astype(np.int64)
        if not deficit.sum():
            continue
        budget = int(rng.integers(1, deficit.sum() + 1))
        a = TR._largest_remainder_alloc(deficit.copy(), budget)
        np.testing.assert_array_equal(
            a, JR._largest_remainder_alloc(deficit.copy(), budget))
        if a.max() == 0:
            continue
        base = rng.integers(0, 100, n).astype(np.int64)
        for x, y in zip(TR._rep_major_stream(a, base),
                        JR._rep_major_stream(a, base)):
            np.testing.assert_array_equal(x, y)


def test_lru_cache_and_fnv1a_equal_pts():
    rng = np.random.default_rng(5)
    for n in (0, 1, 7, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tcache.fnv1a(data) == jcache.fnv1a(data)
    t, j = tcache.LRUCache(3), jcache.LRUCache(3)
    for op, key in zip(rng.integers(0, 3, 200), rng.integers(0, 6, 200)):
        key = int(key)
        if op == 0:
            assert t.get(key) == j.get(key)
        elif op == 1:
            assert t.put(key, key * 10) == j.put(key, key * 10)
        else:
            assert (key in t) == (key in j) and len(t) == len(j)
    with pytest.raises(ValueError):
        tcache.LRUCache(0)


def test_ray_fold_keeps_the_count():
    r = TR.Renderer(device="cpu")
    r._rays_chunks = [torch.tensor(i, dtype=torch.int64)
                      for i in range(600)]
    total = r.rays_traced
    assert total == sum(range(600))
    r._fold_rays(keep=64, limit=512)
    assert len(r._rays_chunks) == 64 and r.rays_traced == total
    r._fold_rays(keep=64, limit=512)       # under the limit: no fold
    assert len(r._rays_chunks) == 64 and r._rays_host == sum(range(536))


@pytest.mark.parametrize("which", ["Default", "Heightfield"])
def test_film_through_the_loop_matches_pt_renderer(which):
    t_scene, j_scene = {
        "Default": (tex_.make_default_scene, jex.make_default_scene),
        "Heightfield": (lambda: tex_.make_heightfield_scene(16),
                        lambda: jex.make_heightfield_scene(16)),
    }[which]
    r = _port(t_scene(), bounces=3)
    jr = JR.Renderer(jint.PathTracingSettings(sample_count=1, bounce_count=3,
                                              backend="brute"))
    jr.set_scene(j_scene(), stream_textures=False)
    jr.on_resize(48, 48)
    for x in (r, jr):
        x.render(2)
        x.render(2)
    assert min(r._plans[("tail", 48 * 48)]) <= 1152
    film, jfilm = r.film_mean(), jr.film_mean()
    assert np.isfinite(film).all() and film.max() > 0
    mse = float(np.mean((film - jfilm) ** 2))
    assert mse < FILM_MSE, mse
    assert abs(r.rays_traced - jr.rays_traced) <= 0.01 * jr.rays_traced
