"""The port's HDR10 output and UI composition against `pt` on the CPU.

* `_srgb_to_linear`, `compose_ui` (float and uint8 overlays) and
  `postprocess(hdr=, ui=)` (bloom on and off) as `pt`'s, to rtol 1e-5.
  `linear_to_hdr10` too, but for its last step: the PQ encode raises its
  base to m2 = 78.84, which multiplies the base's rounding. `pt`'s XLA
  power and PyTorch's round |c|^m1 differently in the last bit on about 2%
  of the values (each within an ulp of the exact value), the base then
  differs by up to 2.4e-7 relative and the encoded value by up to m2 times
  that, 1.9e-5 (measured on 600,000 values). The encoded values are held
  to rtol 2.5e-5, every step before that power to rtol 1e-5.
* `Renderer.snapshot(hdr=True)` on the same film (uniform and adaptive)
  as `pt`'s.
* `python -m pt_torch.run.cli render --hdr` at 32² against `pt`'s
  application path with `hdr=True` (after waiting for `pt`'s streamed
  textures): the decoded PNGs within MSE 1e-3.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pt.post import pipeline as jpost
from pt_torch.post import pipeline as tpost
from pt_torch.scene.textures import decode_png

from torch_threads import one_torch_thread  # noqa: F401


RTOL = 1e-5
RTOL_PQ = 2.5e-5      # the PQ power's amplification (module docstring)


def _linear(seed, shape=(24, 32, 3)):
    """Seeded linear radiance from black to 50 (about 2,500 nits at 203
    nits for 1.0), most of it below 1."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, shape) ** 3 * 50.0).astype(np.float32)


def _ui(seed, shape=(24, 32), dtype=np.uint8):
    """A seeded sRGB RGBA overlay, transparent on about half the pixels."""
    rng = np.random.default_rng(seed)
    rgba = rng.uniform(0.0, 1.0, shape + (4,)).astype(np.float32)
    rgba[..., 3] = np.where(rgba[..., 3] < 0.5, 0.0, rgba[..., 3])
    if dtype == np.uint8:
        return (rgba * 255.0).astype(np.uint8)
    return rgba


def test_srgb_to_linear_matches_pt():
    c = np.linspace(0.0, 1.0, 4097, dtype=np.float32)
    np.testing.assert_allclose(tpost._srgb_to_linear(torch.tensor(c)).numpy(),
                               np.asarray(jpost._srgb_to_linear(c)),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "float"])
def test_compose_ui_matches_pt(dtype):
    screen = 1.0 - np.exp(-_linear(1))
    ui = _ui(2, dtype=dtype)
    got = tpost.compose_ui(torch.tensor(screen), ui).numpy()
    want = np.asarray(jpost.compose_ui(screen, ui))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    covered = ui[..., 3] > 0
    assert covered.any() and (~covered).any()
    assert np.array_equal(got[~covered], screen[~covered])


def test_linear_to_hdr10_matches_pt():
    c = _linear(3, (600, 1000, 3))
    got = tpost.linear_to_hdr10(torch.tensor(c)).numpy()
    want = np.asarray(jpost.linear_to_hdr10(c))
    np.testing.assert_allclose(got, want, rtol=RTOL_PQ, atol=0)
    assert float(np.mean(got == want)) > 0.95
    # the steps before the last power: BT.2020 primaries bit-equal to
    # pt's einsum, scale, then the PQ base
    m = np.asarray(tpost._M709_TO_2020, np.float32)
    bt2020 = torch.tensor(c) @ torch.tensor(m).T
    assert np.array_equal(bt2020.numpy(), np.asarray(
        jnp.einsum("ij,...j->...i", jnp.asarray(m), c)))
    assert tpost.linear_to_hdr10(torch.zeros(1, 3)).max() < 1e-6
    one = tpost.linear_to_hdr10(torch.ones(1, 3)).numpy()
    np.testing.assert_allclose(one, np.asarray(jpost.linear_to_hdr10(
        np.ones((1, 3), np.float32))), rtol=RTOL)
    assert (np.abs(one - 0.58) < 0.01).all()     # 203 nits: PQ about 0.58


@pytest.mark.parametrize("hdr", [False, True], ids=["sdr", "hdr"])
@pytest.mark.parametrize("bloom, ui", [(False, None), (False, "uint8"),
                                       (True, None)],
                         ids=["no_bloom-no_ui", "no_bloom-ui", "bloom-no_ui"])
def test_postprocess_hdr_and_ui_match_pt(hdr, bloom, ui):
    """Both modes with the UI and with bloom (each compile of `pt`'s bloom
    chain takes seconds; the UI is composed after it either way)."""
    accum = _linear(4) * 3.0                  # three samples' sum
    overlay = None if ui is None else _ui(5)
    settings = tpost.PostProcessSettings(exposure=1.3, enable_bloom=bloom)
    jset = jpost.PostProcessSettings(exposure=1.3, enable_bloom=bloom)
    got = tpost.postprocess(torch.tensor(accum), 3.0, settings, hdr=hdr,
                            ui=overlay).numpy()
    want = np.asarray(jpost.postprocess(accum, 3.0, jset, hdr=hdr,
                                        ui=overlay))
    # SDR: 1 - exp(-c) near black rounds to a few 1e-8 either way
    np.testing.assert_allclose(got, want, rtol=RTOL_PQ if hdr else RTOL,
                               atol=0 if hdr else 1e-7)


def test_snapshot_hdr_matches_pt_on_the_same_film():
    """`snapshot(hdr=True)` of one film in both renderers (no scene: the
    film and its counts set by hand), uniform and adaptive."""
    from pt.run.renderer import Renderer as JRenderer
    from pt_torch.run.renderer import Renderer
    accum = _linear(6) * 4.0
    counts = np.random.default_rng(7).integers(1, 9, 24 * 32)
    r, jr = Renderer(device="cpu"), JRenderer()
    for renderer, film in ((r, torch.tensor(accum)),
                           (jr, jnp.asarray(accum))):
        renderer.width, renderer.height = 32, 24
        renderer.accum, renderer.total_samples = film, 4
    for adaptive in (False, True):
        if adaptive:
            r._spp_map = jr._spp_map = counts
        got, want = r.snapshot(hdr=True), jr.snapshot(hdr=True)
        assert got.shape == (24, 32, 3)
        np.testing.assert_allclose(got, want, rtol=RTOL_PQ, atol=0)
        np.testing.assert_allclose(r.snapshot(), jr.snapshot(), rtol=RTOL,
                                   atol=1e-7)


def test_cli_render_hdr_matches_pt_app(tmp_path):
    from pt.out.saver import OutputInfo as JOutputInfo
    from pt.post.pipeline import PostProcessSettings as JPost
    from pt.render.integrator import PathTracingSettings as JSettings
    from pt.run.app import Application as JApplication
    from pt.run.offline import RenderSettings as JRenderSettings
    from pt_torch.run import cli
    jpng = tmp_path / "pt.png"
    app = JApplication()
    app.init("Test Scenes", "Default", 32, 32)
    app.renderer.wait_for_textures()
    assert app.render_offline(
        JRenderSettings(output=JOutputInfo(str(jpng), 32, 32, 30.0, "png"),
                        max_sample_count=2, hdr=True),
        JSettings(sample_count=1, bounce_count=3, backend="brute"),
        JPost()) == 1
    app.shutdown()
    png = tmp_path / "port.png"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["render", "--scene", "Test Scenes/Default", "--size",
                       "32x32", "--spp", "2", "--bounces", "3", "--hdr",
                       "--device", "cpu", "--out", str(png)])
    assert rc == 0, err.getvalue()
    got = decode_png(png.read_bytes())[..., :3] / 255.0
    want = decode_png(jpng.read_bytes())[..., :3] / 255.0
    assert got.shape == (32, 32, 3)
    mse = float(np.mean((got - want) ** 2))
    assert mse < 1e-3, mse
    # PQ lifts the frame: brighter than the SDR film of the same render
    sdr = tmp_path / "sdr.png"
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["render", "--size", "32x32", "--spp", "2",
                         "--bounces", "3", "--device", "cpu", "--out",
                         str(sdr)]) == 0
    assert got.mean() > decode_png(sdr.read_bytes())[..., :3].mean() / 255.0
