"""DDS container + BC1/BC3/BC4/BC5 block decompression (vectorized numpy).

Port of `pt.scene.dds`, the counterpart of the reference's GLI/DDS path (TextureImporter.cpp:69-260):
hand-rolled header parse for metadata without a full load
(GetDDSTextureInfo) plus block decode of the compressed formats the
reference ships (BC1/DXT1 color, BC3/DXT5 color+alpha, BC5/ATI2 normal
maps), including ingest of the pre-built mip chains stored in the file
(the reference uploads those chains directly instead of regenerating,
Image.cpp:226-256).

The texture pool stores float RGBA rows, so blocks are decompressed on
the host at import; the file's mip chain is preserved
level-for-level via TexturePoolBuilder.add_mips.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional

import numpy as np

DDS_MAGIC = b"DDS "
_FOURCC_DX10 = b"DX10"

# DXGI format ids (the subset the reference's gli path accepts)
_DXGI_BC1_UNORM = 71
_DXGI_BC1_UNORM_SRGB = 72
_DXGI_BC2_UNORM = 74
_DXGI_BC3_UNORM = 77
_DXGI_BC3_UNORM_SRGB = 78
_DXGI_BC4_UNORM = 80
_DXGI_BC5_UNORM = 83
_DXGI_R8G8B8A8_UNORM = 28
_DXGI_R8G8B8A8_UNORM_SRGB = 29

_BLOCK_BYTES = {"bc1": 8, "bc2": 16, "bc3": 16, "bc4": 8, "bc5": 16}


@dataclasses.dataclass
class DDSInfo:
    """Parsed header metadata (≙ GetDDSTextureInfo's DDSTextureInfo)."""
    width: int
    height: int
    mip_count: int
    fmt: str                  # bc1|bc2|bc3|bc4|bc5|rgba8
    srgb_hint: bool
    data_offset: int
    cube: bool = False


def is_dds(data: bytes) -> bool:
    return data[:4] == DDS_MAGIC


def parse_dds(data: bytes) -> DDSInfo:
    """Parse the 124-byte DDS_HEADER (+ optional DX10 extension)."""
    if not is_dds(data) or len(data) < 128:
        raise ValueError("not a DDS file")
    (size, flags, height, width, _pitch, _depth, mip_count) = \
        struct.unpack_from("<7I", data, 4)
    if size != 124:
        raise ValueError(f"bad DDS header size {size}")
    # DDSPIXELFORMAT at offset 4+72
    (pf_size, pf_flags, fourcc, bit_count, rmask, gmask, bmask, amask) = \
        struct.unpack_from("<2I4s5I", data, 4 + 72)
    caps2 = struct.unpack_from("<I", data, 4 + 108)[0]
    cube = bool(caps2 & 0x200)
    mip_count = max(1, mip_count)
    offset = 128
    srgb = False

    if pf_flags & 0x4:                       # DDPF_FOURCC
        if fourcc == _FOURCC_DX10:
            dxgi, _dim, _misc, _arr, _misc2 = struct.unpack_from(
                "<5I", data, 128)
            offset = 148
            table = {
                _DXGI_BC1_UNORM: ("bc1", False),
                _DXGI_BC1_UNORM_SRGB: ("bc1", True),
                _DXGI_BC2_UNORM: ("bc2", False),
                _DXGI_BC3_UNORM: ("bc3", False),
                _DXGI_BC3_UNORM_SRGB: ("bc3", True),
                _DXGI_BC4_UNORM: ("bc4", False),
                _DXGI_BC5_UNORM: ("bc5", False),
                _DXGI_R8G8B8A8_UNORM: ("rgba8", False),
                _DXGI_R8G8B8A8_UNORM_SRGB: ("rgba8", True),
            }
            if dxgi not in table:
                raise ValueError(f"unsupported DXGI format {dxgi}")
            fmt, srgb = table[dxgi]
        else:
            table = {b"DXT1": "bc1", b"DXT2": "bc2", b"DXT3": "bc2",
                     b"DXT4": "bc3", b"DXT5": "bc3",
                     b"ATI1": "bc4", b"BC4U": "bc4",
                     b"ATI2": "bc5", b"BC5U": "bc5"}
            if fourcc not in table:
                raise ValueError(f"unsupported fourCC {fourcc!r}")
            fmt = table[fourcc]
    elif pf_flags & 0x40 and bit_count == 32:      # DDPF_RGB uncompressed
        if (rmask, gmask, bmask) != (0xFF, 0xFF00, 0xFF0000):
            raise ValueError("unsupported uncompressed DDS channel masks")
        fmt = "rgba8"
    else:
        raise ValueError("unsupported DDS pixel format")
    return DDSInfo(width=width, height=height, mip_count=mip_count,
                   fmt=fmt, srgb_hint=srgb, data_offset=offset, cube=cube)


# ---------------------------------------------------------------------------
# block decoders — all operate on (N, block_bytes) uint8 arrays at once
# ---------------------------------------------------------------------------

def _decode_c565(c: np.ndarray) -> np.ndarray:
    """(N,) uint16 RGB565 → (N, 3) float in [0,1]."""
    r = ((c >> 11) & 0x1F).astype(np.float32) / 31.0
    g = ((c >> 5) & 0x3F).astype(np.float32) / 63.0
    b = (c & 0x1F).astype(np.float32) / 31.0
    return np.stack([r, g, b], axis=-1)


def _bc1_texels(blocks: np.ndarray, force_opaque: bool) -> np.ndarray:
    """(N, 8) uint8 BC1 color blocks → (N, 16, 4) float RGBA texels in
    raster order within the 4x4 block. `force_opaque` selects the BC3
    color-block variant (always 4-color mode, no punch-through alpha)."""
    n = blocks.shape[0]
    c0 = blocks[:, 0].astype(np.uint16) | (blocks[:, 1].astype(np.uint16) << 8)
    c1 = blocks[:, 2].astype(np.uint16) | (blocks[:, 3].astype(np.uint16) << 8)
    rgb0 = _decode_c565(c0)
    rgb1 = _decode_c565(c1)
    four = (c0 > c1) | force_opaque
    pal = np.zeros((n, 4, 4), np.float32)
    pal[:, 0, :3] = rgb0
    pal[:, 1, :3] = rgb1
    pal[:, 0, 3] = pal[:, 1, 3] = 1.0
    f = four[:, None]
    pal[:, 2, :3] = np.where(f, (2 * rgb0 + rgb1) / 3.0, (rgb0 + rgb1) / 2.0)
    pal[:, 2, 3] = 1.0
    pal[:, 3, :3] = np.where(f, (rgb0 + 2 * rgb1) / 3.0, 0.0)
    pal[:, 3, 3] = np.where(four, 1.0, 0.0)     # 3-color mode: transparent
    bits = (blocks[:, 4].astype(np.uint32)
            | blocks[:, 5].astype(np.uint32) << 8
            | blocks[:, 6].astype(np.uint32) << 16
            | blocks[:, 7].astype(np.uint32) << 24)
    idx = (bits[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 0x3
    return np.take_along_axis(pal, idx[..., None].astype(np.int64), axis=1)


def _bc4_texels(blocks: np.ndarray) -> np.ndarray:
    """(N, 8) uint8 BC4 (single-channel) blocks → (N, 16) float values."""
    n = blocks.shape[0]
    a0 = blocks[:, 0].astype(np.float32)
    a1 = blocks[:, 1].astype(np.float32)
    pal = np.zeros((n, 8), np.float32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    six = a0 > a1
    for i in range(1, 7):                       # palette entries 2..7
        interp6 = ((7 - i) * a0 + i * a1) / 7.0
        if i <= 4:
            interp4 = ((5 - i) * a0 + i * a1) / 5.0
        else:
            interp4 = np.where(np.full(n, i == 5), 0.0, 255.0)
        pal[:, i + 1] = np.where(six, interp6, interp4)
    bits = np.zeros(n, np.uint64)
    for i in range(6):
        bits |= blocks[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    idx = (bits[:, None] >> (3 * np.arange(16, dtype=np.uint64))) \
        .astype(np.int64) & 0x7
    return np.take_along_axis(pal, idx, axis=1) / 255.0


def _blocks_to_image(texels: np.ndarray, width: int, height: int,
                     channels: int) -> np.ndarray:
    """(N, 16, C) per-block texels (raster order in 4x4) → (H, W, C)."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    img = texels.reshape(bh, bw, 4, 4, channels).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(bh * 4, bw * 4, channels)
                                [:height, :width])


def decode_bc_level(raw: bytes, width: int, height: int, fmt: str,
                    reconstruct_z: bool = True) -> np.ndarray:
    """Decode one mip level of compressed data → (H, W, 4) float32 RGBA.
    BC5 (two-channel, the reference's normal-map format) reconstructs
    Z = sqrt(1 - x² - y²) re-encoded to [0,1] when `reconstruct_z` —
    matching what the normal-map sampling expects from an RGB texture."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    n = bw * bh
    bb = _BLOCK_BYTES[fmt]
    blocks = np.frombuffer(raw, np.uint8, n * bb).reshape(n, bb)
    if fmt == "bc1":
        return _blocks_to_image(_bc1_texels(blocks, False), width, height, 4)
    if fmt == "bc2":
        rgba = _bc1_texels(blocks[:, 8:], True)
        abits = np.zeros(n, np.uint64)
        for i in range(8):
            abits |= blocks[:, i].astype(np.uint64) << np.uint64(8 * i)
        aidx = (abits[:, None] >> (4 * np.arange(16, dtype=np.uint64))) \
            .astype(np.int64) & 0xF
        rgba[..., 3] = aidx.astype(np.float32) / 15.0
        return _blocks_to_image(rgba, width, height, 4)
    if fmt == "bc3":
        rgba = _bc1_texels(blocks[:, 8:], True)
        rgba[..., 3] = _bc4_texels(blocks[:, :8])
        return _blocks_to_image(rgba, width, height, 4)
    if fmt == "bc4":
        r = _bc4_texels(blocks)
        tex = np.zeros((n, 16, 4), np.float32)
        tex[..., 0] = r
        tex[..., 3] = 1.0
        return _blocks_to_image(tex, width, height, 4)
    if fmt == "bc5":
        r = _bc4_texels(blocks[:, :8])
        g = _bc4_texels(blocks[:, 8:])
        tex = np.zeros((n, 16, 4), np.float32)
        tex[..., 0] = r
        tex[..., 1] = g
        if reconstruct_z:
            x = r * 2.0 - 1.0
            y = g * 2.0 - 1.0
            z = np.sqrt(np.maximum(0.0, 1.0 - x * x - y * y))
            tex[..., 2] = z * 0.5 + 0.5
        tex[..., 3] = 1.0
        return _blocks_to_image(tex, width, height, 4)
    raise ValueError(f"unknown block format {fmt}")


def decode_dds(data: bytes, info: Optional[DDSInfo] = None,
               max_levels: Optional[int] = None) -> List[np.ndarray]:
    """Decode a DDS file into its stored mip chain
    (list of (H, W, 4) float32, level 0 first)."""
    info = info or parse_dds(data)
    if info.cube:
        # decoding would silently return only face +X's chain; fail
        # loudly so the caller falls back to the default texture instead
        # of using one face as the whole texture
        raise ValueError("cubemap DDS textures are not supported")
    levels: List[np.ndarray] = []
    pos = info.data_offset
    w, h = info.width, info.height
    count = info.mip_count if max_levels is None \
        else min(info.mip_count, max_levels)
    for _ in range(count):
        if info.fmt == "rgba8":
            nbytes = w * h * 4
            img = np.frombuffer(data, np.uint8, w * h * 4, pos) \
                .reshape(h, w, 4).astype(np.float32) / 255.0
        else:
            bw, bh = (w + 3) // 4, (h + 3) // 4
            nbytes = bw * bh * _BLOCK_BYTES[info.fmt]
            img = decode_bc_level(data[pos:pos + nbytes], w, h, info.fmt)
        levels.append(img)
        pos += nbytes
        if w == 1 and h == 1:
            break
        w, h = max(1, w // 2), max(1, h // 2)
    return levels
