"""Texture streaming in the port `Renderer` on the CPU, after `pt`'s
(`pt/run/renderer.py:401-457`).

* `set_scene` (streaming, `pt`'s default) installs the placeholder pool at
  once and swaps the real one in at the first poll after the loader
  finished; `wait_for_textures` then gives the film of
  `stream_textures=False`, bit for bit.
* A pool built for an earlier scene is never installed: neither a late
  writer of a stale generation nor a real loader overtaken by a second
  `set_scene`. A loader's error reaches the render thread.
* `OfflineRenderer` and the CLI wait for the streamed pool before the
  first sample (the port's deliberate divergence: `pt`'s race its
  loader), so no saved frame is shaded with the placeholder pool, even
  when the loader is slow.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pt_torch.out.saver import OutputInfo, write_radiance_hdr
from pt_torch.render.integrator import PathTracingSettings
from pt_torch.run import cli
from pt_torch.run import renderer as TR
from pt_torch.run.offline import OfflineRenderer, RenderSettings
from pt_torch.scene.examples import make_default_scene
from pt_torch.scene.textures import read_radiance_hdr


def _renderer(stream, size=16):
    r = TR.Renderer(PathTracingSettings(sample_count=1, bounce_count=2),
                    device="cpu")
    r.set_scene(make_default_scene(), stream_textures=stream)
    r.on_resize(size, size)
    return r


@pytest.fixture
def slow_loader(monkeypatch):
    """The loader thread's pool build, held back until the test lets it
    go (or 30 s pass); a build on the main thread is not held."""
    go = threading.Event()
    real = TR.build_scene_textures

    def build(scene, **kw):
        if threading.current_thread() is not threading.main_thread():
            go.wait(30)
        return real(scene, **kw)
    monkeypatch.setattr(TR, "build_scene_textures", build)
    yield go
    go.set()


def test_placeholder_first_then_the_streamed_pool(slow_loader):
    r = _renderer(True)
    placeholder = r.tex
    assert placeholder.count < 9 + 4          # the defaults only
    r.render(1)                               # the loader is not done
    assert r.tex is placeholder and r.total_samples == 1
    slow_loader.set()
    r.wait_for_textures()
    assert r.tex is not placeholder and r.total_samples == 0   # restarted
    r.render(2)
    ref = _renderer(False)
    ref.render(2)
    assert torch.equal(r.accum, ref.accum)


def test_stale_pool_is_not_swapped_in():
    r = _renderer(False)
    current = r.tex
    r._pending_tex = (r._tex_gen - 1, "stale-pool")   # a late stale writer
    r._poll_textures()
    assert r.tex is current and r._pending_tex is None


def test_overtaken_loader_is_dropped(slow_loader):
    """A second set_scene while the first scene's loader still runs: the
    first loader finishes later and its pool is dropped."""
    r = _renderer(True)
    first = r._tex_thread
    r.set_scene(make_default_scene(), stream_textures=False)
    real_pool = r.tex
    slow_loader.set()
    first.join(30)
    assert r._pending_tex is not None and r._pending_tex[0] < r._tex_gen
    r.render(1)
    assert r.tex is real_pool


def test_loader_error_reaches_the_render_thread(monkeypatch):
    def broken(scene, **kw):
        raise OSError("texture file unreadable")
    monkeypatch.setattr(TR, "build_scene_textures", broken)
    r = _renderer(True)
    with pytest.raises(RuntimeError, match="texture loader failed"):
        r.wait_for_textures()


def test_offline_render_waits_for_the_streamed_pool(tmp_path, slow_loader):
    r = _renderer(True)
    threading.Timer(0.5, slow_loader.set).start()
    t0 = time.perf_counter()
    frames = OfflineRenderer(r).render(RenderSettings(
        output=OutputInfo(str(tmp_path / "a.hdr"), 16, 16, 30.0, "hdr"),
        max_sample_count=2, samples_per_step=2))
    assert frames == 1 and time.perf_counter() - t0 >= 0.5
    ref = _renderer(False)
    ref.render(2)
    assert torch.equal(r.accum, ref.accum)


def test_cli_render_never_saves_the_placeholder(tmp_path, slow_loader):
    threading.Timer(0.5, slow_loader.set).start()
    out = tmp_path / "cli.hdr"
    rc = cli.main(["render", "--size", "16x16", "--spp", "2", "--bounces",
                   "2", "--format", "hdr", "--device", "cpu", "--out",
                   str(out)])
    assert rc == 0
    ref = _renderer(False)
    ref.render(2)
    write_radiance_hdr(str(tmp_path / "ref.hdr"), ref.film_mean())
    np.testing.assert_array_equal(read_radiance_hdr(out.read_bytes()),
                                  read_radiance_hdr(
                                      (tmp_path / "ref.hdr").read_bytes()))
