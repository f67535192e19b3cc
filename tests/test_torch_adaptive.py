"""The port's adaptive film (`Renderer.render_adaptive`) on the CPU, after
`pt`'s `tests/test_adaptive_film.py`.

* tol=0 never converges: every pixel takes max_spp samples on the RNG
  streams of repeated render(1) calls, so the film is bit-equal to the
  uniform one (with the "full" compaction plans applied from the second
  dispatch on).
* Against `pt`'s render_adaptive on the same scene and arguments (the
  LBVH backend in both packages): film MSE < 1e-3, the project's film contract, and the
  mean samples per pixel within 5%.
* The global-MSE mode, the time budget, a uniform render resetting the
  film, the checkpoint fields (`spp_map`, `accum_sq`) and the refusal to
  resume the other kind of film.
* Duplicate lanes of one pixel in a dispatch are added in ordered passes
  with one lane per pixel each; the film equals a single sequential
  index_add_ bit for bit.
* `OfflineRenderer` with `adaptive_tol` end to end (the CLI's flags are in
  `tests/test_torch_app.py`).
"""

import os

import numpy as np
import torch

from pt.render.integrator import PathTracingSettings as JSettings
from pt.run.renderer import Renderer as JRenderer
from pt.scene.examples import make_default_scene as j_default
from pt_torch.out.saver import OutputInfo
from pt_torch.render.integrator import PathTracingSettings
from pt_torch.run import renderer as TR
from pt_torch.run.offline import OfflineRenderer, RenderSettings
from pt_torch.scene.examples import make_default_scene

from torch_threads import one_torch_thread  # noqa: F401


FILM_MSE = 1e-3


def _renderer(size=16, bounces=2, backend="pallas"):
    r = TR.Renderer(PathTracingSettings(sample_count=1, bounce_count=bounces,
                                        backend=backend),
                    device="cpu")
    r.set_scene(make_default_scene(), stream_textures=False)
    r.on_resize(size, size)
    return r


def test_tol_zero_is_bit_equal_to_the_uniform_film():
    ra = _renderer(48, 5)
    stats = ra.render_adaptive(tol=0.0, max_spp=4, min_spp=1,
                               check_every=4)
    assert stats == {"spp_min": 4, "spp_max": 4, "spp_mean": 4.0,
                     "steps": 4}
    assert min(ra._plans[("full", 48 * 48)]) <= 1152     # compacted
    ru = _renderer(48, 5)
    for _ in range(4):
        ru.render(1)
    assert torch.equal(ra.accum, ru.accum)
    assert ra.rays_traced == ru.rays_traced
    np.testing.assert_array_equal(ra.snapshot(), ru.snapshot())
    np.testing.assert_array_equal(ra.film_mean(), ru.film_mean())


def test_film_matches_pts_render_adaptive():
    kw = dict(tol=0.05, max_spp=16, min_spp=2, check_every=2)
    r = _renderer(backend="bvh")             # pt's backend here
    stats = r.render_adaptive(**kw)
    jr = JRenderer(JSettings(sample_count=1, bounce_count=2, backend="bvh"))
    jr.set_scene(j_default(), stream_textures=False)
    jr.on_resize(16, 16)
    jstats = jr.render_adaptive(**kw)
    assert stats["spp_min"] >= 2 and stats["spp_max"] <= 16
    assert abs(stats["spp_mean"] - jstats["spp_mean"]) \
        <= 0.05 * jstats["spp_mean"], (stats, jstats)
    film, jfilm = r.film_mean(), jr.film_mean()
    assert np.isfinite(film).all()
    mse = float(np.mean((film - jfilm) ** 2))
    assert mse < FILM_MSE, mse
    assert float(np.mean((r.snapshot() - jr.snapshot()) ** 2)) < FILM_MSE


def test_target_mse_mode():
    r = _renderer()
    stats = r.render_adaptive(target_mse=5e-4, max_spp=64, min_spp=4,
                              check_every=4)
    assert stats["spp_min"] >= 4
    assert np.isfinite(r.snapshot()).all()
    counts = np.maximum(r._spp_map, 1)
    lum = (r.accum.reshape(-1, 3).numpy() @ TR._LUM) / counts
    var = np.maximum(r._accum_sq.numpy() / counts - lum * lum, 0.0)
    est = float(np.mean(var / counts * np.exp(-lum) ** 2))
    assert est < 5e-4 or (r._spp_map >= 64).any()


def test_max_seconds_deadline():
    r = _renderer()
    stats = r.render_adaptive(tol=0.0, max_spp=64, min_spp=1,
                              check_every=1, max_seconds=0.0)
    assert stats["steps"] == 0 and stats["spp_max"] == 0
    stats = r.render_adaptive(tol=0.0, max_spp=4, min_spp=1,
                              check_every=4, max_seconds=1e9)
    assert stats["spp_min"] == 4
    assert np.isfinite(r.snapshot()).all()


def test_uniform_render_resets_the_adaptive_film():
    r = _renderer()
    r.render_adaptive(tol=0.05, max_spp=4, min_spp=2, check_every=2)
    r.render(1)
    assert r._spp_map is None and r._accum_sq is None
    assert r.total_samples == 1
    assert np.isfinite(r.snapshot()).all()


def test_checkpoint_roundtrip_and_resume_rules(tmp_path):
    r = _renderer()
    r.render_adaptive(tol=0.05, max_spp=8, min_spp=2, check_every=2)
    p = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(p)
    with np.load(p) as data:
        assert {"spp_map", "accum_sq"} <= set(data.files)
    r2 = _renderer()
    r2.load_checkpoint(p)
    np.testing.assert_array_equal(r2._spp_map, r._spp_map)
    assert torch.equal(r2._accum_sq, r._accum_sq)
    np.testing.assert_array_equal(r.snapshot(), r2.snapshot())
    assert r2.rays_traced == r.rays_traced
    # an adaptive checkpoint is not resumed by a uniform offline render
    out = tmp_path / "u.png"
    OfflineRenderer(r2).render(RenderSettings(
        output=OutputInfo(str(out), 16, 16, 30.0, "png"),
        max_sample_count=2, checkpoint_path=p))
    assert r2._spp_map is None and r2.total_samples == 2
    assert not os.path.exists(p)


def test_duplicate_lanes_add_in_ordered_passes():
    rng = np.random.default_rng(3)
    lanes = np.sort(rng.integers(0, 50, 400))
    real = rng.random(400) < 0.9
    passes = TR._occurrence_passes(lanes, real)
    assert sorted(np.concatenate(passes).tolist()) == \
        np.flatnonzero(real).tolist()
    vals = torch.as_tensor(rng.random((400, 3)).astype(np.float32) * 1e3)
    seq = torch.zeros((50, 3))
    idx = torch.as_tensor(np.flatnonzero(real))
    seq.index_add_(0, torch.as_tensor(lanes)[idx], vals[idx])
    passed = torch.zeros((50, 3))
    for sel in passes:
        assert len(np.unique(lanes[sel])) == len(sel)    # one lane a pixel
        passed.index_add_(0, torch.as_tensor(lanes[sel]),
                          vals[torch.as_tensor(sel)])
    assert torch.equal(seq, passed)


def test_offline_adaptive_end_to_end(tmp_path):
    r = _renderer()
    out = tmp_path / "a.png"
    n = OfflineRenderer(r).render(RenderSettings(
        output=OutputInfo(str(out), 16, 16, 30.0, "png"),
        max_sample_count=8, adaptive_tol=0.05))
    assert n == 1 and out.exists()
    assert r._spp_map is not None and r._spp_map.min() >= 8   # min(16, 8)
