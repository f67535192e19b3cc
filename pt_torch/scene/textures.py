"""Scene textures → the device texture pool.

Port of `pt.scene.textures`: metadata without a pixel load
(`get_texture_info`), the decoders for textures given as a file or as
encoded bytes (`_decode_bytes`: PNG through `decode_png`, which needs no
Pillow, and Radiance HDR through `read_radiance_hdr`), and
`build_texture_pool` / `build_scene_textures` with the memory-budget policy
(`_budget_max_dim`, `_downscale_to`). Slot order is `pt`'s: the defaults at
0..8, then the scene's textures in registration order from
SCENE_TEXTURE_OFFSET. A texture that cannot be decoded becomes a 1x1
magenta placeholder, as in `pt`.

DDS (block-compressed textures and their authored mip chains) belongs to
the importers' slice of the port: no procedural scene produces one, and a
DDS texture raises NotImplementedError here.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import List, Optional

import numpy as np

from pt_torch.core.config import Config
from pt_torch.render.textures import (DeviceTextures, TexturePoolBuilder,
                                      _downsample2x, add_default_textures)
from pt_torch.scene.types import TextureInfo

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# samples per pixel by PNG colour type: grey, RGB, palette, grey+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_radiance_hdr(data: bytes) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) reader → (H, W, 3) float32: flat
    scanlines, adaptive RLE and old-style RLE runs."""
    stream = io.BytesIO(data)
    if not stream.readline().startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    while True:
        line = stream.readline()
        if line in (b"\n", b""):
            break
    dims = stream.readline().split()
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    raw = stream.read()
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if raw[pos] == 2 and raw[pos + 1] == 2:     # adaptive RLE
            if ((raw[pos + 2] << 8) | raw[pos + 3]) != w:
                raise ValueError("HDR adaptive-RLE scanline width mismatch")
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = raw[pos]
                    pos += 1
                    if count > 128:                 # run
                        rgbe[y, x:x + count - 128, c] = raw[pos]
                        pos += 1
                        x += count - 128
                    else:                           # literal
                        rgbe[y, x:x + count, c] = np.frombuffer(
                            raw, np.uint8, count, pos)
                        pos += count
                        x += count
        else:            # flat scanline, possibly with old-style RLE runs
            # old-style RLE: a pixel (1,1,1,n) repeats the previous pixel
            # n<<shift times (consecutive markers raise shift by 8). A flat
            # file has no such markers and decodes in one copy per line.
            x = 0
            shift = 0
            while x < w:
                avail = min(w - x, (len(raw) - pos) // 4)
                if avail <= 0:
                    raise ValueError("truncated HDR scanline")
                cand = np.frombuffer(raw, np.uint8, avail * 4,
                                     pos).reshape(avail, 4)
                marks = np.flatnonzero((cand[:, 0] == 1) & (cand[:, 1] == 1)
                                       & (cand[:, 2] == 1))
                lit = int(marks[0]) if len(marks) else avail
                if lit:
                    rgbe[y, x:x + lit] = cand[:lit]
                    x += lit
                    pos += lit * 4
                    shift = 0
                if len(marks) and lit == int(marks[0]):
                    count = int(cand[lit, 3]) << shift
                    prev = (rgbe[y, x - 1] if x
                            else rgbe[y - 1, w - 1] if y else 0)
                    end = min(x + count, w)
                    rgbe[y, x:end] = prev
                    x = end
                    pos += 4
                    shift += 8
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0,
                     np.ldexp(1.0, exp - 136)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _png_chunks(data: bytes):
    """(tag, body) of every chunk of a PNG byte string, CRCs checked."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {tag!r}: CRC mismatch")
        yield tag, body
        pos += 12 + length
        if tag == b"IEND":
            return
    raise ValueError("PNG without an IEND chunk")


def _png_header(ihdr: bytes):
    """(width, height, colour type) of an IHDR body this decoder takes:
    8 bits per sample, no interlace, colour types 0, 2, 3, 4 and 6."""
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth != 8 or ctype not in _PNG_CHANNELS or comp or filt or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}): 8-bit non-interlaced only")
    return w, h, ctype


def _png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG scanline filters → (h, stride) uint8. None, Sub and
    Up are whole-row numpy operations; Average and Paeth depend on the byte
    to the left within the row and run byte by byte."""
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    out = np.zeros((h, stride), np.uint8)
    zero = bytes(stride)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)]
        prev = out[y - 1].tobytes() if y else zero
        if ftype == 0:
            cur = line
        elif ftype == 1:          # Sub: a running sum per byte lane
            lanes = np.frombuffer(line, np.uint8).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).tobytes()
        elif ftype == 2:          # Up
            cur = (np.frombuffer(line, np.uint8)
                   + np.frombuffer(prev, np.uint8)).tobytes()
        elif ftype == 3:          # Average of left and up, rounded down
            cur = bytearray(line)
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:          # Paeth predictor
            cur = bytearray(line)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"PNG scanline filter {ftype}")
        out[y] = np.frombuffer(bytes(cur), np.uint8)
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 4) uint8 RGBA, with the standard library alone
    (`zlib` and the five scanline filters). Grey expands to RGB, a palette
    is looked up, a missing alpha is 255, and a tRNS chunk gives the alpha
    of a palette entry or makes one grey level or RGB colour transparent:
    what `PIL.Image.open(...).convert("RGBA")` gives. Takes 8-bit,
    non-interlaced images of colour types 0, 2, 3, 4 and 6; anything else
    raises ValueError."""
    header = palette = trns = None
    idat = []
    for tag, body in _png_chunks(data):
        if tag == b"IHDR":
            header = _png_header(body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, ctype = header
    ch = _PNG_CHANNELS[ctype]
    px = _png_unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch) \
        .reshape(h, w, ch)
    rgba = np.full((h, w, 4), 255, np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        table = np.full((256, 4), 255, np.uint8)
        table[:, :3] = 0
        table[:len(palette), :3] = palette
        if trns is not None:
            table[:len(trns), 3] = np.frombuffer(trns, np.uint8)
        rgba = table[px[..., 0]]
    elif ctype in (0, 4):
        rgba[..., :3] = px[..., :1]
        if ctype == 4:
            rgba[..., 3] = px[..., 1]
        elif trns is not None:
            key = struct.unpack(">H", trns[:2])[0]
            rgba[..., 3] = np.where(px[..., 0] == key, 0, 255)
    else:
        rgba[..., :ch] = px
        if ctype == 2 and trns is not None:
            key = np.asarray(struct.unpack(">HHH", trns[:6]))
            rgba[..., 3] = np.where((px == key).all(axis=-1), 0, 255)
    return rgba


def _decode_bytes(data: bytes, name: str) -> np.ndarray:
    """Decode encoded image bytes → (H, W, 4) float32 in [0,1] (LDR) or
    linear floats (HDR)."""
    if data[:2] == b"#?":
        rgb = read_radiance_hdr(data)
        return np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
    if data[:4] == b"DDS ":
        raise NotImplementedError(
            f"texture '{name}' is a DDS file; the DDS decoder belongs to "
            "the importers' slice of the port")
    if data[:8] == _PNG_MAGIC:
        return decode_png(data).astype(np.float32) / 255.0
    raise ValueError(f"texture '{name}': unknown image format (PNG and "
                     "Radiance HDR are decoded)")


def _read_head(info: TextureInfo, n: int) -> Optional[bytes]:
    if info.data is not None:
        return info.data[:n]
    if info.path is not None:
        with open(info.path, "rb") as f:
            return f.read(n)
    return None


def get_texture_info(info: TextureInfo) -> TextureInfo:
    """Fill width/height metadata without decoding pixels
    (≙ TextureImporter::GetTextureInfo): from `pixels`, or from a PNG's
    IHDR chunk. Other sources keep what they carry."""
    if info.pixels is not None:
        info.height, info.width = info.pixels.shape[:2]
        return info
    try:
        head = _read_head(info, 33)
        if head is not None and len(head) >= 24 \
                and head[:8] == _PNG_MAGIC and head[12:16] == b"IHDR":
            info.width, info.height = struct.unpack(">II", head[16:24])
    except OSError:
        pass
    return info


def load_texture_pixels(info: TextureInfo) -> Optional[np.ndarray]:
    """Full decode → (H, W, 4) float32; None on failure (the pool then
    holds the magenta placeholder, ≙ SceneImporter.cpp:89-98). In-memory
    `pixels`: gray and gray+alpha expand to RGB(A), RGB gains α = 1, and
    integer sources are normalised by their dtype (uint8 / 255,
    uint16 / 65535). A DDS texture raises NotImplementedError."""
    try:
        if info.pixels is not None:
            raw = np.asarray(info.pixels)
            px = raw.astype(np.float32)
            if px.ndim == 2:
                px = px[..., None]
            if px.shape[-1] == 1:                      # gray → RGB
                px = np.repeat(px, 3, axis=-1)
            elif px.shape[-1] == 2:                    # gray+alpha
                px = np.concatenate(
                    [np.repeat(px[..., :1], 3, axis=-1), px[..., 1:]], -1)
            if px.shape[-1] == 3:
                px = np.concatenate([px, np.ones_like(px[..., :1])], -1)
            if raw.dtype == np.uint8:
                px = px / 255.0
            elif raw.dtype == np.uint16:
                px = px / 65535.0
            return px
        data = info.data
        if data is None and info.path is not None:
            with open(info.path, "rb") as f:
                data = f.read()
        if data is None:
            return None
        return _decode_bytes(data, info.name)
    except NotImplementedError:
        raise
    except Exception:
        return None


def _downscale_to(pixels: np.ndarray, max_dim: int) -> np.ndarray:
    """Repeated 2x box downsample until both dims ≤ max_dim."""
    while max(pixels.shape[0], pixels.shape[1]) > max_dim:
        pixels = _downsample2x(pixels)
    return pixels


def _budget_max_dim(infos: List[TextureInfo], cfg: Config) -> int:
    """Shrink the global size cap until the estimated pool fits the memory
    budget. The estimate is `pt`'s, whatever the pool's row format: 32
    bytes per texel (quad rows of 16 bf16 channels), times 4/3 for the
    generated mips."""
    max_dim = cfg.max_texture_size
    bytes_per_texel = 32 * 4 // 3
    while max_dim > 64:
        total = 0
        for info in infos:
            w = min(info.width or max_dim, max_dim)
            h = min(info.height or max_dim, max_dim)
            total += w * h * bytes_per_texel
        if total <= cfg.texture_memory_budget:
            break
        max_dim //= 2
    return max_dim


def build_texture_pool(infos: List[TextureInfo],
                       cfg: Optional[Config] = None,
                       paired: Optional[bool] = None, dtype=None,
                       quad: Optional[bool] = None,
                       device=None) -> DeviceTextures:
    """Build the device pool from the scene's textures: defaults in slots
    0..8, then `infos` in order. `paired`/`quad`/`dtype` override the pool's
    row format as in `TexturePoolBuilder`; as there, `paired=True` alone
    still gives quad rows (pass `quad=False` with it)."""
    cfg = cfg or Config()
    infos = [get_texture_info(i) for i in infos]
    max_dim = _budget_max_dim(infos, cfg)
    builder = TexturePoolBuilder(paired=paired, quad=quad)
    add_default_textures(builder)
    for info in infos:
        px = load_texture_pixels(info)
        if px is None:
            # broken texture: a 1x1 magenta placeholder keeps the table
            # indices stable while flagging the asset visually
            builder.add(np.asarray([[[1.0, 0.0, 1.0, 1.0]]], np.float32),
                        srgb=False, generate_mips=False)
        else:
            builder.add(_downscale_to(px, max_dim), srgb=info.is_srgb,
                        generate_mips=True)
    return builder.build(dtype=dtype, device=device)


def build_scene_textures(scene, cfg: Optional[Config] = None,
                         paired: Optional[bool] = None, dtype=None,
                         quad: Optional[bool] = None,
                         device=None) -> DeviceTextures:
    return build_texture_pool(scene.textures, cfg, paired=paired,
                              dtype=dtype, quad=quad, device=device)
