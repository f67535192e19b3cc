"""Offline frame sink: PNG/JPG/TGA/HDR images and MP4 video.

Port of `pt.out.saver` (≙ the reference's OutputSaver,
Renderer/OutputSaver.cpp): `OutputInfo`, and `OutputSaver` with its writer
thread (frames are handed off and converted to host arrays there),
numbered file names for an image sequence, `end_output` (drain, flush and
close), `cancel_output` (kill the encoder, delete the partial file), and
errors of the writer thread raised on the caller's next `submit_frame` or
`end_output`.

PNG is written with the standard library alone (`zlib` + `struct`: 8 bits
per sample, filter 0 per scanline) and HDR by the Radiance RGBE writer, so
neither needs Pillow. JPG (quality 95) and TGA go through Pillow, imported
only there, as in `pt`. mp4 pipes raw RGBA frames to an ffmpeg subprocess
with `pt`'s arguments (`-vcodec libx264 -preset veryslow -crf 17`); where
no `ffmpeg` is on the PATH it writes an MJPEG AVI beside the target path
instead (`pt_torch.out.avi`, whose JPEG frames need Pillow) and sets the
"Output" stat.
"""

from __future__ import annotations

import os
import pathlib
import queue
import shutil
import struct
import subprocess
import threading
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from pt_torch.core.stats import Stats

FORMATS = ("png", "jpg", "jpeg", "tga", "hdr", "mp4")


class OutputInfo(NamedTuple):
    """≙ OutputInfo (Renderer.h): target path, extent, framerate, format."""
    path: str
    width: int
    height: int
    framerate: float = 30.0
    format: str = "png"          # png | jpg | tga | hdr | mp4
    sequence: bool = False       # image formats with >1 frame → numbered


def check_format(fmt: str) -> str:
    """`fmt` lower-cased if the port writes it; else ValueError. (`pt`
    writes a PNG under any other name.)"""
    fmt = fmt.lower()
    if fmt not in FORMATS:
        raise ValueError(f"unsupported image format '{fmt}' (png, jpg, tga, "
                         "hdr or mp4)")
    return fmt


def write_radiance_hdr(path: str, rgb: np.ndarray) -> None:
    """Radiance RGBE writer (flat scanlines; ≙ stbi_write_hdr)."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]
    maxc = rgb.max(axis=-1)
    exp = np.where(maxc > 1e-32,
                   np.floor(np.log2(np.maximum(maxc, 1e-38))) + 1,
                   0).astype(np.int32)
    scale = np.where(maxc > 1e-32, 2.0 ** (8 - exp), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(u8: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, C) uint8 image, C = 1 (grey; also (H, W)),
    2 (grey + alpha), 3 (truecolor) or 4 (truecolor + alpha): 8 bits per
    sample, no interlace, filter type 0 on every scanline."""
    u8 = np.ascontiguousarray(u8, np.uint8)
    if u8.ndim == 2:
        u8 = u8[..., None]
    if u8.ndim != 3 or not 1 <= u8.shape[2] <= 4:
        raise ValueError(f"expected an (H, W, 1..4) image, got {u8.shape}")
    h, w, ch = u8.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, w * ch)],
                         axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[ch],
                       0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b""))


def write_image(path: str, image: np.ndarray, fmt: Optional[str] = None) -> None:
    """Write one frame. `image` is float (H, W, 3): display-encoded [0,1]
    for the 8-bit formats, linear radiance for HDR (≙ WriteImage,
    OutputSaver.cpp:227-257). JPG and TGA are Pillow's, as in `pt`."""
    fmt = check_format(fmt or pathlib.Path(path).suffix.lstrip("."))
    if fmt == "hdr":
        write_radiance_hdr(path, image)
        return
    u8 = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if fmt in ("jpg", "jpeg", "tga"):
        from PIL import Image
        img = Image.fromarray(u8)
        if fmt == "tga":
            img.save(path, format="TGA")
        else:
            img.save(path, quality=95)
        return
    pathlib.Path(path).write_bytes(encode_png(u8))


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def frame_path(info: OutputInfo, index: int) -> str:
    """Where frame `index` of an image output goes: the target path, or for
    a sequence `<stem>_<index:05d><suffix>` beside it."""
    if not info.sequence:
        return info.path
    base = pathlib.Path(info.path)
    return str(base.with_name(f"{base.stem}_{index:05d}{base.suffix}"))


class OutputSaver:
    """Async frame sink with a writer thread (≙ OutputSaver)."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue(maxsize=4)
        self._thread: Optional[threading.Thread] = None
        self._ffmpeg: Optional[subprocess.Popen] = None
        self._avi = None
        self._info: Optional[OutputInfo] = None
        self._frame_index = 0
        self._error: Optional[Exception] = None

    @property
    def active(self) -> bool:
        return self._info is not None

    def register_output(self, info: OutputInfo) -> None:
        """≙ RegisterOutput (OutputSaver.cpp:64-111): mp4 starts ffmpeg, or
        without it the MJPEG AVI beside the target path."""
        if self.active:
            raise RuntimeError("output already registered")
        check_format(info.format)
        self._info = info
        self._frame_index = 0
        self._error = None
        if info.format == "mp4":
            if ffmpeg_available():
                self._ffmpeg = subprocess.Popen(
                    ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgba",
                     "-s", f"{info.width}x{info.height}",
                     "-r", str(info.framerate), "-i", "-",
                     "-vcodec", "libx264", "-preset", "veryslow",
                     "-crf", "17", "-pix_fmt", "yuv420p", info.path],
                    stdin=subprocess.PIPE,
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            else:
                from pt_torch.out.avi import MjpegAviWriter
                avi_path = str(pathlib.Path(info.path).with_suffix(".avi"))
                self._avi = MjpegAviWriter(avi_path, info.width, info.height,
                                           info.framerate)
                Stats.add_stat("Output",
                               "ffmpeg unavailable → native MJPEG AVI")
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    def submit_frame(self, image) -> None:
        """Queue one frame; `image` may be a tensor on the card: the copy to
        the host happens on the writer thread (≙ the fence-wait + readback
        jthread, OutputSaver.cpp:164-181)."""
        if not self.active:
            raise RuntimeError("no output registered")
        while True:
            if self._error:
                raise self._error
            try:
                self._queue.put(image, timeout=0.25)
                return
            except queue.Full:
                continue

    def end_output(self) -> None:
        """≙ EndOutput (OutputSaver.cpp:183-203): drain, flush, close."""
        if not self.active:
            return
        self._queue.put(None)
        if self._thread:
            self._thread.join()
        if self._ffmpeg:
            self._ffmpeg.stdin.close()
            self._ffmpeg.wait()
            self._ffmpeg = None
        if self._avi:
            self._avi.close()
            self._avi = None
        self._info = None
        self._thread = None
        if self._error:
            raise self._error

    def cancel_output(self) -> None:
        """≙ CancelOutput (OutputSaver.cpp:204-225): kill the encoder and
        delete the partial file (the AVI too)."""
        if not self.active:
            return
        info = self._info
        if self._ffmpeg:
            self._ffmpeg.kill()   # unblocks a writer stuck in stdin.write
        self._queue.put(None)
        if self._thread:
            self._thread.join()
        if self._ffmpeg:
            self._ffmpeg.wait()
            self._ffmpeg = None
        avi_path = None
        if self._avi:
            avi_path = self._avi.path
            self._avi.close()
            self._avi = None
        self._info = None
        self._thread = None
        try:
            if info and os.path.exists(info.path):
                os.remove(info.path)
            if avi_path and os.path.exists(avi_path):
                os.remove(avi_path)
        except OSError:
            pass

    # ------------------------------------------------------------------
    def _writer(self) -> None:
        info = self._info
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                frame = (item.detach().cpu().numpy()
                         if isinstance(item, torch.Tensor)
                         else np.asarray(item))      # off the caller
                if info.format == "mp4":
                    self._write_video_frame(info, frame)
                else:
                    write_image(frame_path(info, self._frame_index), frame,
                                info.format)
                self._frame_index += 1
            except Exception as exc:            # surfaced on next submit
                self._error = exc
                # keep draining (discarding) until the sentinel: producers
                # block on the bounded queue, so exiting here would leave
                # submit_frame/end_output stuck in put() forever
                while self._queue.get() is not None:
                    pass
                return

    def _write_video_frame(self, info: OutputInfo, frame: np.ndarray) -> None:
        if frame.shape[:2] != (info.height, info.width):
            # ffmpeg reads fixed-size rawvideo frames; a mismatched frame
            # would silently shear the whole stream
            raise ValueError(
                f"frame {frame.shape[:2]} != registered "
                f"{(info.height, info.width)}")
        u8 = (np.clip(frame, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if self._ffmpeg is not None:
            rgba = np.concatenate(
                [u8, np.full_like(u8[..., :1], 255)], axis=-1)
            self._ffmpeg.stdin.write(rgba.tobytes())
        else:
            self._avi.write_frame(u8)
