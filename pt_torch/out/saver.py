"""Offline frame sink: PNG and Radiance HDR image files.

Port of the still-image half of `pt.out.saver`. PNG is written with the
standard library alone (`zlib` + `struct`: 8 bits per sample, filter 0
per scanline), so the port needs no Pillow; HDR is the Radiance RGBE writer.
The threaded video sink (OutputSaver) comes with a later slice.
"""

from __future__ import annotations

import pathlib
import struct
import zlib
from typing import Optional

import numpy as np


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
    for PNG, linear radiance for HDR (≙ WriteImage, OutputSaver.cpp:227-257)."""
    fmt = (fmt or pathlib.Path(path).suffix.lstrip(".")).lower()
    if fmt == "hdr":
        write_radiance_hdr(path, image)
        return
    if fmt != "png":
        raise ValueError(f"unsupported image format '{fmt}' (png or hdr)")
    u8 = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    pathlib.Path(path).write_bytes(encode_png(u8))
