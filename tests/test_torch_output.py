"""The port's video and JPG/TGA output against `pt` on the CPU.

* `write_image` writes JPG (quality 95) and TGA files byte-equal to
  `pt`'s (both through Pillow).
* With no ffmpeg (`ffmpeg_available` patched to False, as on a host
  without one) an mp4 output writes the MJPEG AVI beside the target path,
  byte-equal to `pt`'s for the same frames, and sets the "Output" stat as
  `pt` does; cancelling deletes the partial AVI.
* With ffmpeg (the stub of `tests/test_output.py`, which records its argv
  and the bytes piped to it) the port starts it with `pt`'s argv and pipes
  `pt`'s bytes; cancelling kills it and deletes the partial file.
* `render --frames 3 --format mp4 --device cpu` writes the 3-frame AVI
  where there is no ffmpeg, and numbered files for png, jpg and tga.
"""

import contextlib
import io
import os
import struct
import time

import numpy as np
import pytest
import torch

from pt.core.stats import Stats as JStats
from pt.out import saver as jsaver
from pt_torch.core.stats import Stats
from pt_torch.out import saver as tsaver

from tests.test_output import _install_stub_ffmpeg
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def empty_boards():
    Stats.clear()
    JStats.clear()
    yield
    Stats.clear()
    JStats.clear()


def _frames(n=3, h=16, w=24):
    rng = np.random.default_rng(n)
    gx = np.broadcast_to(np.linspace(0, 1, w, np.float32)[None, :], (h, w))
    return [np.clip(np.stack([np.full_like(gx, k / n), gx, gx[::-1]], -1)
                    + rng.normal(0, 0.05, (h, w, 3)).astype(np.float32),
                    -0.1, 1.1) for k in range(n)]


@pytest.mark.parametrize("fmt", ["jpg", "jpeg", "tga"])
def test_write_image_bytes_equal_pt(tmp_path, fmt):
    img = _frames(1)[0]
    jsaver.write_image(str(tmp_path / f"pt.{fmt}"), img)
    tsaver.write_image(str(tmp_path / f"port.{fmt}"), img)
    assert (tmp_path / f"port.{fmt}").read_bytes() == \
        (tmp_path / f"pt.{fmt}").read_bytes()
    # an explicit format under another suffix: what Pillow makes of it
    jsaver.write_image(str(tmp_path / "pt_as.png"), img, fmt)
    tsaver.write_image(str(tmp_path / "port_as.png"), img, fmt)
    assert (tmp_path / "port_as.png").read_bytes() == \
        (tmp_path / "pt_as.png").read_bytes()


def _video(mod, path, frames, fmt="mp4", cancel=False):
    out = mod.OutputSaver()
    h, w = frames[0].shape[:2]
    out.register_output(mod.OutputInfo(str(path), w, h, 24.0, fmt))
    for f in frames:
        out.submit_frame(f)
    if cancel:
        out.cancel_output()
    else:
        out.end_output()
    assert not out.active


def test_mjpeg_avi_bytes_equal_pt_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(jsaver, "ffmpeg_available", lambda: False)
    monkeypatch.setattr(tsaver, "ffmpeg_available", lambda: False)
    frames = _frames()
    _video(jsaver, tmp_path / "pt.mp4", frames)
    jstat = JStats.get_stats()["Output"]
    _video(tsaver, tmp_path / "port.mp4", [torch.from_numpy(f)
                                          for f in frames])
    assert Stats.get_stats()["Output"] == jstat == \
        "ffmpeg unavailable → native MJPEG AVI"
    data = (tmp_path / "port.avi").read_bytes()
    assert data == (tmp_path / "pt.avi").read_bytes()
    assert not (tmp_path / "port.mp4").exists()
    avih = data.index(b"avih") + 8
    assert struct.unpack("<10I", data[avih:avih + 40])[4] == 3   # frames


def test_mjpeg_avi_cancel_deletes_partial(tmp_path, monkeypatch):
    monkeypatch.setattr(tsaver, "ffmpeg_available", lambda: False)
    _video(tsaver, tmp_path / "clip.mp4", _frames(2), cancel=True)
    assert not list(tmp_path.iterdir())


def test_mjpeg_avi_writer_equals_pt(tmp_path):
    """`MjpegAviWriter` alone: the same file for float and uint8 frames,
    and the index and sizes patched on close."""
    from pt.out.avi import MjpegAviWriter as JWriter
    from pt_torch.out.avi import MjpegAviWriter as TWriter
    frames = _frames(4, 8, 16)
    for cls, name in ((JWriter, "pt.avi"), (TWriter, "port.avi")):
        w = cls(str(tmp_path / name), 16, 8, 12.5)
        for k, f in enumerate(frames):
            w.write_frame(f if k % 2 else
                          (np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8))
        w.close()
    assert (tmp_path / "port.avi").read_bytes() == \
        (tmp_path / "pt.avi").read_bytes()


def test_mp4_argv_and_piped_bytes_equal_pt(tmp_path, monkeypatch):
    frames = _frames(3, 4, 8)
    got = {}
    for mod, name in ((jsaver, "pt"), (tsaver, "port")):
        d = tmp_path / name
        d.mkdir()
        with monkeypatch.context() as m:
            argv_file, stdin_file, sentinel = _install_stub_ffmpeg(d, m)
            assert mod.ffmpeg_available()
            _video(mod, d / "clip.mp4", frames)
            assert sentinel.read_text() == "ok"       # a clean EOF
            got[name] = (argv_file.read_text().replace(str(d), "DIR"),
                         stdin_file.read_bytes(),
                         (d / "clip.mp4").read_bytes())
    assert got["port"] == got["pt"]
    assert len(got["port"][1]) == 3 * 4 * 8 * 4
    assert "Output" not in Stats.get_stats()


def test_mp4_cancel_kills_ffmpeg_and_deletes(tmp_path, monkeypatch):
    _, _, sentinel = _install_stub_ffmpeg(tmp_path, monkeypatch)
    out = tsaver.OutputSaver()
    target = tmp_path / "clip.mp4"
    out.register_output(tsaver.OutputInfo(str(target), 8, 4, format="mp4"))
    out.submit_frame(np.zeros((4, 8, 3), np.float32))
    deadline = time.time() + 10.0
    while not target.exists() and time.time() < deadline:
        time.sleep(0.01)
    assert target.exists()
    out.cancel_output()
    assert not target.exists() and not sentinel.exists()
    assert not out.active
    with pytest.raises(ValueError, match="frame"):
        out.register_output(tsaver.OutputInfo(str(target), 8, 4,
                                              format="mp4"))
        out.submit_frame(np.zeros((2, 2, 3), np.float32))
        out.end_output()
    out.cancel_output()


def _main(argv):
    from pt_torch.run import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("fmt", ["mp4", "png", "jpg", "tga"])
def test_cli_renders_frames_in_every_format(tmp_path, monkeypatch, fmt):
    """Three frames of the Default at 8², 1 spp: mp4 gives the 3-frame
    AVI (no ffmpeg here) and no mp4, each image format three numbered 8x8
    files."""
    from PIL import Image
    monkeypatch.setattr(tsaver, "ffmpeg_available", lambda: False)
    out = tmp_path / f"f.{fmt}"
    rc, _, err = _main(["render", "--size", "8x8", "--spp", "1",
                        "--bounces", "2", "--frames", "3", "--device",
                        "cpu", "--format", fmt, "--out", str(out)])
    assert rc == 0, err
    if fmt == "mp4":
        data = (tmp_path / "f.avi").read_bytes()
        avih = data.index(b"avih") + 8
        assert struct.unpack("<10I", data[avih:avih + 40])[4] == 3
        assert not out.exists()
        return
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"f_{i:05d}.{fmt}" for i in range(3)]
    for p in tmp_path.iterdir():
        with Image.open(p) as im:
            assert im.size == (8, 8)
    assert os.path.getsize(tmp_path / f"f_00000.{fmt}") > 0
