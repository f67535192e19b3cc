"""Multi-device rendering of the port (`pt_torch.dist`, `Renderer(mesh=)`
and `OfflineRenderer` under a mesh) against its single-device paths and
against `pt`.

One gang of 4 CPU ranks over gloo serves the module (`gang`); the rank
bodies are in tests/torch_dist_ranks.py, which imports no JAX. Each case is
the counterpart of a check of `pt`:

* film bands equal `render_image_stats` bit for bit, with equal rays
  (`tests/test_render.py::test_film_sharding_matches_single_device`); the
  spp mode's ratio, `pt`'s 8-device bounds scaled to 4 ranks; the 2-D
  mesh's 1-wide cases equal the 1-D modes bit for bit and the 2x2 mesh's
  ratio is in `pt`'s bounds (`test_film_spp_2d_mesh`);
* `Renderer(mesh=)`: films and ray counts bit-equal across 1, 2 and 4
  ranks and to the single-device Renderer (`pt` asks for agreement in
  expectation, `test_production_renderer_sharded`), compaction on and off
  bit-equal, the band tiling a permutation of each band
  (`tests/test_sharded_compaction.py`), the adaptive film at tol=0 equal
  to the single-device one and the target-MSE rule
  (`tests/test_adaptive_film.py`) and its deadline, agreed by the ranks,
  a checkpoint taken under a mesh resumed on one device and under 2
  ranks;
* `dryrun_multichip`'s sequence (`__graft_entry__.py`), the offline save
  under the mesh (one PNG, bytes equal to one device's) and a cancel on one
  rank that stops every rank at the same step;
* a rank that raises fails the gang within its timeout;
* the rank bodies of `chip_smoke.py`'s `[dist]` phase, rehearsed on the
  CPU at a small size;
* against `pt` on `film_mesh(jax.devices()[:4])`: the band tile order,
  pixel arrays and band-local scatter permutation bit-equal, the spp
  stride's frames bit-equal, and the sharded Renderer's film within the
  film bar (MSE < 1e-3, brute backend, the Default at 32²).
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as ranks
from pt_torch.dist import mesh as dm
from pt_torch.dist.launch import Gang, RankError, launch
from pt_torch.render.integrator import PathTracingSettings, render_image_stats
from pt_torch.run.renderer import Renderer

from torch_threads import one_torch_thread  # noqa: F401

FILM_MSE = 1e-3
DEADLINE = 120      # seconds a gang's run may take before its test fails


@pytest.fixture(scope="module")
def gang():
    with Gang(4, "gloo", device="cpu") as g:
        yield g


def _run(gang, fn, *args, **kwargs):
    return gang.run(fn, *args, deadline=DEADLINE, **kwargs)


def _same_on_every_rank(results):
    for other in results[1:]:
        for key, (film, rays) in results[0].items():
            np.testing.assert_array_equal(other[key][0], film)
            assert other[key][1] == rays
    return results[0]


@pytest.fixture(scope="module")
def modes(gang):
    return _same_on_every_rank(_run(gang, ranks.image_modes, 32, 32, 1, 3))


@pytest.fixture(scope="module")
def reference():
    """The port's single-device film (32², 1 spp, 3 bounces) and rays."""
    ds, tex, iv, ip = ranks._inputs(32, 32)
    img, rays = render_image_stats(
        ds, tex, iv, ip, 32, 32, 0,
        PathTracingSettings(sample_count=1, bounce_count=3), device="cpu")
    return img.numpy(), int(rays)


def _single_renderer(settings, size):
    r = Renderer(settings, device="cpu")
    r.set_scene(ranks._scene(), stream_textures=False)
    r.on_resize(size, size)
    return r


def test_gang_joins_over_the_named_backend(gang):
    assert gang.joined == ["gloo on cpu"] * 4
    assert _run(gang, ranks.backend_and_device) == [("gloo", "cpu")] * 4


def test_film_sharding_matches_single_device(modes, reference):
    film, rays = modes["film"]
    np.testing.assert_array_equal(film, reference[0])
    assert rays == reference[1]


def test_spp_sharding_scales(modes, reference):
    img, rays = modes["spp"]
    ratio = float(img.mean() / reference[0].mean())
    assert 3.0 < ratio < 5.0         # 4 merged films within MC noise
    assert rays > 3 * reference[1]


def test_film_spp_2d_mesh(modes, reference):
    np.testing.assert_array_equal(modes["4x1"][0], modes["film"][0])
    assert modes["4x1"][1] == modes["film"][1]
    np.testing.assert_array_equal(modes["1x4"][0], modes["spp"][0])
    assert modes["1x4"][1] == modes["spp"][1]
    img, rays = modes["2x2"]
    ratio = float(img.mean() / reference[0].mean())
    assert 1.5 < ratio < 2.6          # 2 merged films within MC noise
    assert rays > reference[1]


def test_production_renderer_sharded(gang):
    out = _run(gang, ranks.renderer_films, 32, 32, 4, 3)
    st = PathTracingSettings(sample_count=4, bounce_count=3)
    r = _single_renderer(st, 32)
    r.render()
    ref = r.film_mean()
    for rank, films in enumerate(out):
        for n in (1, 2, 4):
            if rank >= n:
                assert films[n] is None
                continue
            film, rays, samples = films[n]
            np.testing.assert_array_equal(film, ref)
            assert (rays, samples) == (r.rays_traced, 4)
    img = out[0][4][0]
    assert np.isfinite(img).all()
    assert abs(img.mean() - ref.mean()) / max(ref.mean(), 1e-9) < 0.2


def test_sharded_compaction_bit_exact(gang):
    out = _run(gang, ranks.compaction_films, 64, 64, 3, 4)
    for res in out:
        np.testing.assert_array_equal(res["on"][0], res["off"][0])
        assert res["on"][1] == res["off"][1]
        assert res["on_plan"] is not None and min(res["on_plan"]) <= 512
        np.testing.assert_array_equal(res["on"][0], out[0]["on"][0])


@pytest.fixture(scope="module")
def tiling(gang):
    return _run(gang, ranks.band_tiling, 32, 32)


def test_sharded_band_tiling_covers_film(tiling):
    n_local = 32 * 32 // 4
    for rank, (arrays, _) in enumerate(tiling):
        assert (arrays["band"], arrays["rows"]) == (rank, 8)
        assert sorted(arrays["perm"].tolist()) == list(range(n_local))
        assert set(arrays["py"].tolist()) == set(range(8 * rank,
                                                       8 * rank + 8))
    img = tiling[0][1]
    assert np.isfinite(img).all()
    # an interior render leaves no untouched scanline bands
    assert (np.abs(img).sum(axis=(1, 2)) > 0).all()


def test_band_arrays_equal_pt(tiling):
    from pt.dist.mesh import film_mesh
    from pt.run.renderer import Renderer as PtRenderer
    r = PtRenderer(mesh=film_mesh(jax.devices()[:4]))
    r.on_resize(32, 32)
    n_local = 32 * 32 // 4
    order = np.concatenate([a["order"] + b * n_local
                            for b, (a, _) in enumerate(tiling)])
    np.testing.assert_array_equal(order, r._order_np)
    for ours, theirs in (("px", r._px), ("py", r._py),
                         ("perm", r._film_perm_sharded)):
        np.testing.assert_array_equal(
            np.concatenate([a[ours] for a, _ in tiling]),
            np.asarray(theirs))


def test_spp_frames_equal_pt():
    """`pt`'s per-rank frame, `frame + rank * uint32(2654435761)` in
    uint32, against `spp_frame`'s host arithmetic, across the wrap."""
    for frame in (0, 1, 7, 12345, 2**31 + 3, 2**32 - 1):
        idx = jnp.arange(8, dtype=jnp.uint32)
        theirs = np.asarray(jnp.uint32(frame) + idx
                            * jnp.uint32(dm.GOLDEN_STRIDE))
        np.testing.assert_array_equal(
            [dm.spp_frame(frame, i) for i in range(8)],
            theirs.astype(np.int64))


def test_sharded_renderer_film_against_pt(gang):
    from pt.dist.mesh import film_mesh
    from pt.run.renderer import Renderer as PtRenderer
    from pt.render.integrator import PathTracingSettings as PtSettings
    from pt.scene.examples import make_default_scene
    ours = _run(gang, ranks.renderer_films, 32, 32, 4, 3, (4,), "brute")[0][4]
    r = PtRenderer(PtSettings(sample_count=1, bounce_count=3,
                              backend="brute"),
                   mesh=film_mesh(jax.devices()[:4]))
    r.set_scene(make_default_scene(), stream_textures=False)
    r.on_resize(32, 32)
    r.render(4)
    theirs = r.film_mean()
    assert float(np.mean((ours[0] - theirs) ** 2)) < FILM_MSE
    assert abs(ours[1] - r.rays_traced) <= 0.01 * r.rays_traced


def test_sharded_adaptive_matches_single_device(gang):
    out = _run(gang, ranks.adaptive_films, 16, 16, 3, tol=0.0, max_spp=4,
                   min_spp=1, check_every=4)
    for res in out:
        stats, film, snap = res["mesh"]
        assert stats["spp_min"] == stats["spp_max"] == 4
        np.testing.assert_array_equal(film, res["single"][1])
        np.testing.assert_allclose(snap, res["single"][2], atol=1e-5)


def test_sharded_target_mse(gang):
    out = _run(gang, ranks.adaptive_films, 16, 16, 3, target_mse=5e-4,
                   max_spp=32, min_spp=2, check_every=4, single=False)
    for res in out:
        stats, film, snap = res["mesh"]
        assert stats["spp_min"] >= 2 and stats["spp_max"] <= 32
        assert np.isfinite(snap).all()
        np.testing.assert_array_equal(film, out[0]["mesh"][1])


def test_sharded_max_seconds_deadline(gang):
    """The ranks agree on the deadline (`tests/test_adaptive_film.py`'s
    max_seconds case): a past one stops every rank before its first
    dispatch, a far one lets the film finish."""
    for past, far, finite in _run(gang, ranks.adaptive_deadlines, 16, 16):
        assert past["steps"] == 0 and past["spp_max"] == 0
        assert far["spp_min"] == 4 and finite


def test_checkpoint_resumes_across_meshes(gang, tmp_path):
    out = _run(gang, ranks.checkpoint_round_trip, 16, 16,
                   str(tmp_path / "c.npz"))
    whole, single, half = out[0]
    for film, rays in (single, half):
        np.testing.assert_array_equal(film, whole[0])
        assert rays == whole[1]
    assert out[2][2] is None


def test_dryrun_multichip(gang, tmp_path):
    out = _run(gang, ranks.dryrun, str(tmp_path))
    for res in out:
        assert res["film"] == (16, 16, 3) and res["film_finite"]
        assert res["spp_finite"] and res["2d_finite"]
        assert res["render_finite"] and res["adaptive_finite"]
        assert res["adaptive"]["spp_min"] == 2, res["adaptive"]
        assert res["frames"] == 1
    assert os.listdir(tmp_path) == ["frame.png"]
    assert [(k, shape) for k, shape, finite in out[0]["weak_scaling"]
            if finite] == [(1, (8, 32, 3)), (2, (16, 32, 3)),
                           (4, (32, 32, 3))]


def test_offline_under_mesh(gang, tmp_path):
    out = _run(gang, ranks.offline_runs, str(tmp_path))
    for res in out:
        assert res["mesh"] == (1, 3)
        # rank 1 alone cancelled, after the ranks' first step
        assert res["cancelled"] == (0, 2)
    assert out[0]["one"] == (1, 3)
    assert sorted(os.listdir(tmp_path)) == ["c.npz", "mesh.png", "one.png"]
    assert ((tmp_path / "mesh.png").read_bytes()
            == (tmp_path / "one.png").read_bytes())


def test_a_rank_that_raises_fails_the_gang():
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        launch(ranks.fail_on_rank, 2, "gloo", 1, device="cpu")
    # well inside the collective's timeout: the gang does not wait for it
    assert time.monotonic() - t0 < dm.COLLECTIVE_TIMEOUT_S / 2


def test_chip_smoke_dist_phase_rehearsed_on_the_cpu(gang, tmp_path):
    """The rank bodies of `chip_smoke.py`'s `[dist]` phase in the gang's CPU
    ranks, at 16² over the Heightfield n=8: its gates but the launches (the
    CPU runs the plain versions)."""
    import chip_smoke
    modes = _run(gang, chip_smoke.dist_rank_modes, 16, 2, 3, "cpu", 8)[0]
    for one_wide, mode in (("4x1", "film"), ("1x4", "spp")):
        np.testing.assert_array_equal(modes[one_wide][0], modes[mode][0])
        assert modes[one_wide][1] == modes[mode][1]
    rend = _run(gang, chip_smoke.dist_rank_renderer, 16, 4, 3, "cpu", 8)
    first = rend[0]
    for n in (1, 2, 4):
        np.testing.assert_array_equal(first[n]["film"], first[1]["film"])
        assert first[n]["rays"] == first[1]["rays"]
        assert all(res[n]["plain"] for res in rend[:n])
    np.testing.assert_array_equal(first["uncompacted"][0], first[1]["film"])
    rest = _run(gang, chip_smoke.dist_rank_rest, 16, 3, str(tmp_path), "cpu",
                8, 16)[0]
    assert rest["adaptive"][0]["spp_min"] == rest["adaptive"][0]["spp_max"]
    assert rest["mesh"] == rest["one"] == 1
    assert ((tmp_path / "mesh" / "frame.png").read_bytes()
            == (tmp_path / "one" / "frame.png").read_bytes())
    assert rest["cross"].shape == (16, 16, 3)
