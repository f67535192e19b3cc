"""The port's offline renderer, frame saver, checkpoints, scene manager and
host-side core modules on the CPU, after the offline and saver cases of
`tests/test_output.py`.

* `OfflineRenderer`: the sample budget (the last step clamped), the time
  budget, numbered frames of an animated scene with `scene.update(1 /
  framerate)` between them, cancellation and an exception mid-render (the
  partial output deleted, the checkpoint kept), periodic checkpoints.
* A render resumed from its checkpoint is bit-equal to an uninterrupted one
  (every sample seeds its RNG from (pixel, total samples)), through
  `Renderer` and through `OfflineRenderer`, which deletes the checkpoint on
  success; the checkpoint has `pt`'s `.npz` keys.
* `OutputSaver`: the writer thread writes PNG and HDR, numbers a sequence,
  deletes the partial file on cancel, and hands its errors back to the
  caller.
* `SceneManager`: the built-in groups in `pt`'s order, async loading, a
  failed load keeps the previous scene.
* `Config` keeps `pt`'s names and defaults, and the `Renderer`'s
  `set_settings` behaves as `pt`'s.
"""

import dataclasses
import pathlib
import time

import numpy as np
import pytest
import torch

from pt_torch.core.config import Config
from pt_torch.out.saver import OutputInfo, OutputSaver, frame_path
from pt_torch.render.integrator import PathTracingSettings
from pt_torch.run.offline import OfflineRenderer, RenderSettings
from pt_torch.run.renderer import Renderer
from pt_torch.scene.examples import make_default_scene
from pt_torch.scene.textures import decode_png, read_radiance_hdr
from torch_threads import one_torch_thread  # noqa: F401


def _renderer(spp=1, bounces=2, scene=None):
    r = Renderer(PathTracingSettings(sample_count=spp, bounce_count=bounces),
                 device="cpu")
    r.set_scene(scene or make_default_scene(), stream_textures=False)
    return r


def _settings(path, size=16, fmt="png", **kw):
    return RenderSettings(output=OutputInfo(str(path), size, size, 30.0, fmt),
                          **kw)


# ------------------------------------------------------------- offline

def test_offline_render_sample_budget(tmp_path):
    r = _renderer(spp=2, bounces=3)
    path = tmp_path / "offline.png"
    steps = []
    frames = OfflineRenderer(r).render(
        _settings(path, 24, max_sample_count=10, samples_per_step=4),
        lambda f, t, s: steps.append(s))
    assert frames == 1 and path.exists()
    assert steps == [4, 8, 10]               # the last step is clamped
    assert r.total_samples == 10
    assert decode_png(path.read_bytes()).shape == (24, 24, 4)


def test_offline_time_budget(tmp_path):
    r = _renderer()
    frames = OfflineRenderer(r).render(_settings(
        tmp_path / "timed.png", max_sample_count=100000,
        max_time_seconds=0.05, samples_per_step=1))
    assert frames == 1
    assert 1 <= r.total_samples < 100000     # the time budget cut it short


def test_offline_hdr_keeps_linear_radiance(tmp_path):
    r = _renderer()
    path = tmp_path / "film.hdr"
    OfflineRenderer(r).render(_settings(path, fmt="hdr", max_sample_count=2))
    film = read_radiance_hdr(path.read_bytes())
    want = r.film_mean()
    # RGBE keeps 8 bits of each pixel's largest channel
    assert (np.abs(film - want)
            <= want.max(axis=-1, keepdims=True) / 128 + 1e-7).all()


def test_offline_animation_frames(tmp_path):
    """Numbered frames of an animated scene (the Heightfield on a keyframed
    node, `chip_smoke.build_animated_scene`), stepped by 1/framerate
    between frames: each frame differs from the last."""
    import chip_smoke
    scene = chip_smoke.build_animated_scene(chip_smoke.port_namespace(), 12)
    r = _renderer(scene=scene)
    out = tmp_path / "anim.png"
    steps = []
    frames = OfflineRenderer(r).render(RenderSettings(
        output=OutputInfo(str(out), 16, 16, framerate=8.0, format="png"),
        frame_count=3, max_sample_count=2, samples_per_step=1),
        lambda f, t, s: steps.append((f, t, s)))
    assert frames == 3 and not out.exists()
    assert steps == [(f, 3, s) for f in range(3) for s in (1, 2)]
    files = sorted(tmp_path.glob("anim_*.png"))
    assert [f.name for f in files] == [f"anim_{i:05d}.png" for i in range(3)]
    imgs = [decode_png(f.read_bytes()) for f in files]
    assert not np.array_equal(imgs[0], imgs[1])
    assert not np.array_equal(imgs[1], imgs[2])


def test_offline_cancel_deletes_partial_output_and_keeps_checkpoint(
        tmp_path):
    r = _renderer()
    ckpt = tmp_path / "p.ckpt.npz"
    out = tmp_path / "x.png"
    off = OfflineRenderer(r)
    seen = []

    def progress(frame, total, samples):
        # interval 0: a checkpoint lands after every non-final step
        if samples < 6:
            seen.append(ckpt.exists())
        if samples >= 4:
            off.cancel()

    assert off.render(_settings(out, max_sample_count=6, samples_per_step=2,
                                checkpoint_path=str(ckpt),
                                checkpoint_interval_seconds=0.0),
                      progress) == 0
    assert ckpt.exists() and not out.exists()
    assert any(seen[1:])                     # written during the run
    assert int(np.load(ckpt)["total_samples"]) == 4


def test_offline_exception_deletes_partial_output(tmp_path, monkeypatch):
    r = _renderer()
    out = tmp_path / "x.png"
    calls = []

    def render(samples=None):
        calls.append(samples)
        if len(calls) == 2:
            raise RuntimeError("device lost")
        return Renderer.render(r, samples)
    monkeypatch.setattr(r, "render", render)
    off = OfflineRenderer(r)
    with pytest.raises(RuntimeError, match="device lost"):
        off.render(_settings(out, max_sample_count=4, samples_per_step=1))
    assert not out.exists() and not off.saver.active


def test_offline_rejects_what_item_4_brings(tmp_path):
    """Item 4 is done: what the offline path refused before, HDR10 output,
    now renders. With `hdr` the PNG holds the PQ encoding of the film
    (`snapshot(hdr=True)`, the 8-bit PNG of what `postprocess(hdr=True)`
    gives), brighter than the SDR frame of the same film; an `.hdr` file
    keeps the linear film either way."""
    from pt_torch.post.pipeline import postprocess
    r = _renderer()
    png = tmp_path / "a.png"
    assert OfflineRenderer(r).render(_settings(png, hdr=True,
                                               max_sample_count=2)) == 1
    pq = postprocess(r.accum, 2.0, r.post, hdr=True).numpy()
    assert np.array_equal(r.snapshot(hdr=True), pq)
    got = decode_png(png.read_bytes())[..., :3]
    assert np.array_equal(
        got, (np.clip(pq, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
    sdr = r.snapshot()
    assert pq.mean() > sdr.mean() and (pq >= 0).all() and (pq <= 1).all()
    hdr = tmp_path / "a.hdr"
    assert OfflineRenderer(r).render(_settings(hdr, fmt="hdr", hdr=True,
                                               max_sample_count=2)) == 1
    film = read_radiance_hdr(hdr.read_bytes())
    assert np.abs(film - r.film_mean()).max() <= 0.01 * r.film_mean().max()


# --------------------------------------------------------- checkpoints

def test_checkpoint_resume_bit_exact(tmp_path):
    st = PathTracingSettings(sample_count=1, bounce_count=3)
    r = Renderer(st, device="cpu")
    r.set_scene(make_default_scene(), stream_textures=False)
    r.on_resize(24, 24)
    r.render(2)
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)
    with np.load(path) as data:
        assert sorted(data.files) == ["accum", "height", "rays_total",
                                      "total_samples", "width"]
    rays_at_2 = r.rays_traced
    r.render(2)
    full = r.accum.clone()

    r2 = Renderer(st, device="cpu")
    r2.set_scene(make_default_scene(), stream_textures=False)
    r2.load_checkpoint(path)
    assert (r2.width, r2.height, r2.total_samples) == (24, 24, 2)
    assert r2.rays_traced == rays_at_2
    r2.render(2)
    assert torch.equal(r2.accum, full)
    assert r2.rays_traced == r.rays_traced


def test_offline_checkpoint_resume_bit_exact(tmp_path):
    st = PathTracingSettings(sample_count=1, bounce_count=3)
    ckpt = tmp_path / "film.ckpt.npz"

    def offline(spp, name, checkpoint=None):
        r = Renderer(st, device="cpu")
        r.set_scene(make_default_scene(), stream_textures=False)
        OfflineRenderer(r).render(_settings(
            tmp_path / name, 24, max_sample_count=spp, samples_per_step=2,
            checkpoint_path=checkpoint and str(checkpoint)))
        return r

    full = offline(4, "full.png")
    offline(2, "half.png").save_checkpoint(str(ckpt))
    resumed = offline(4, "resumed.png", ckpt)
    assert resumed.total_samples == 4
    assert torch.equal(resumed.accum, full.accum)
    assert not ckpt.exists()                 # deleted on success
    assert (tmp_path / "resumed.png").read_bytes() == \
        (tmp_path / "full.png").read_bytes()


def test_offline_unusable_checkpoint_starts_fresh(tmp_path):
    ckpt = tmp_path / "bad.ckpt.npz"
    ckpt.write_bytes(b"not a checkpoint")
    r = _renderer()
    assert OfflineRenderer(r).render(_settings(
        tmp_path / "a.png", max_sample_count=2,
        checkpoint_path=str(ckpt))) == 1
    assert r.total_samples == 2 and not ckpt.exists()


# --------------------------------------------------------------- saver

def test_saver_writes_png_on_its_thread(tmp_path):
    saver = OutputSaver()
    path = tmp_path / "frame.png"
    saver.register_output(OutputInfo(str(path), 8, 8, 30.0, "png"))
    assert saver.active
    with pytest.raises(RuntimeError, match="already registered"):
        saver.register_output(OutputInfo(str(path), 8, 8))
    saver.submit_frame(torch.full((8, 8, 3), 0.5))
    saver.end_output()
    assert not saver.active
    assert (decode_png(path.read_bytes())[..., :3] == 128).all()


def test_saver_numbers_a_sequence(tmp_path):
    info = OutputInfo(str(tmp_path / "seq.hdr"), 4, 4, 24.0, "hdr",
                      sequence=True)
    saver = OutputSaver()
    saver.register_output(info)
    for i in range(3):
        saver.submit_frame(np.full((4, 4, 3), float(i + 1), np.float32))
    saver.end_output()
    for i in range(3):
        path = pathlib.Path(frame_path(info, i))
        assert path.name == f"seq_{i:05d}.hdr"
        assert (read_radiance_hdr(path.read_bytes()) == i + 1).all()
    assert frame_path(info._replace(sequence=False), 7) == info.path


def test_saver_cancel_deletes_partial(tmp_path):
    saver = OutputSaver()
    path = tmp_path / "frame.png"
    saver.register_output(OutputInfo(str(path), 8, 8, 30.0, "png"))
    saver.submit_frame(np.zeros((8, 8, 3), np.float32))
    deadline = time.monotonic() + 10
    while not path.exists() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert path.exists()
    saver.cancel_output()
    assert not path.exists() and not saver.active


def test_saver_hands_writer_errors_back(tmp_path):
    saver = OutputSaver()
    saver.register_output(OutputInfo(str(tmp_path / "bad.png"), 8, 8))
    saver.submit_frame(np.zeros((2, 2, 2, 2), np.float32))   # not an image
    with pytest.raises(ValueError, match="image"):
        saver.end_output()
    assert not saver.active
    saver.register_output(OutputInfo(str(tmp_path / "bad.png"), 8, 8))
    saver.submit_frame(np.zeros((2, 2, 2, 2), np.float32))
    with pytest.raises(ValueError, match="image"):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:   # surfaced on a later submit
            saver.submit_frame(np.zeros((8, 8, 3), np.float32))
            time.sleep(0.01)
    saver.cancel_output()


@pytest.mark.parametrize("fmt", ["jpg", "tga", "mp4"])
def test_saver_formats_of_item_5_raise(tmp_path, fmt, monkeypatch):
    """Item 5 is done: jpg, tga and mp4 (the MJPEG AVI where there is no
    ffmpeg) are written on the saver's thread; a format the port does not
    write still raises."""
    from pt_torch.out import saver
    monkeypatch.setattr(saver, "ffmpeg_available", lambda: False)
    out = OutputSaver()
    out.register_output(OutputInfo(str(tmp_path / f"x.{fmt}"), 8, 8, 30.0,
                                   fmt))
    out.submit_frame(np.full((8, 8, 3), 0.5, np.float32))
    out.end_output()
    written = "x.avi" if fmt == "mp4" else f"x.{fmt}"
    assert [p.name for p in tmp_path.iterdir()] == [written]
    with pytest.raises(ValueError, match="unsupported image format 'bmp'"):
        out.register_output(OutputInfo(str(tmp_path / "x.bmp"), 8, 8, 30.0,
                                       "bmp"))


# ------------------------------------------------------- scene manager

def test_scene_manager_groups_match_pt():
    from pt.scene.manager import SceneManager as JSceneManager
    from pt_torch.scene.manager import SceneManager
    ours, theirs = SceneManager(), JSceneManager()
    assert {g: list(s) for g, s in ours.groups.items()} == \
        {g: list(s) for g, s in theirs.groups.items()}


def test_scene_manager_async_and_failure():
    from pt_torch.scene.manager import SceneManager
    mgr = SceneManager()
    loaded = []
    mgr.on_scene_loaded(loaded.append)
    mgr.set_active_scene("Test Scenes", "Default")   # async
    mgr.wait()
    scene = mgr.get_active_scene()
    assert scene is not None and scene.name == "Default"
    assert loaded == [scene] and mgr.active_name == "Default"

    class Boom:
        def load(self, builder):
            raise RuntimeError("boom")
    mgr.register("Test Scenes", "Broken", Boom())
    mgr.set_active_scene("Test Scenes", "Broken", blocking=True)
    assert mgr.get_active_scene() is scene          # previous scene kept
    assert loaded == [scene]


# ------------------------------------------------- config and settings

def test_config_matches_pt():
    """The port's `Config` holds the fields of `pt`'s that its modules
    read, under `pt`'s names and with `pt`'s defaults."""
    from pt.core.config import Config as JConfig
    theirs = {f.name: f.default for f in dataclasses.fields(JConfig)}
    fields = {f.name: f.default for f in dataclasses.fields(Config)}
    assert fields == {"texture_memory_budget": 2 << 30,
                      "max_texture_size": 4096,
                      "min_refresh_rate": 60.0,
                      "max_samples_per_frame": 64,
                      "assets_path": None, "scenes_path": None,
                      "loader_thread_count": theirs["loader_thread_count"]}
    assert all(theirs[name] == default for name, default in fields.items())


def test_renderer_settings_and_controller():
    """`set_settings` resets the film only when the path-tracing settings
    change, and swaps the post settings in place."""
    r = _renderer(spp=1)
    r.on_resize(8, 8)
    r.render(1)
    r.set_settings(PathTracingSettings(sample_count=1, bounce_count=2))
    assert r.total_samples == 1                 # unchanged settings
    r.set_settings(PathTracingSettings(sample_count=1, bounce_count=3))
    assert r.total_samples == 0 and r.settings.bounce_count == 3
    from pt_torch.post.pipeline import PostProcessSettings
    post = PostProcessSettings(exposure=2.0)
    r.set_settings(post=post)
    assert r.post is post and r.total_samples == 0
