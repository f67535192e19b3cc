"""The port's texture formats against `pt` on the CPU.

* DDS: BC1, BC2, BC3, BC4 and BC5 blocks, the DX10 header, sizes that are
  not a multiple of 4, authored mip chains and the repo's three DDS
  fixtures decode bit-equal to `pt`'s `decode_dds`; `parse_dds`,
  `get_texture_info`, `load_texture_pixels` and `load_texture_mips`
  return what `pt`'s return; truncated and flipped DDS files fail as
  `pt`'s fail.
* PNG: every colour type at every bit depth the standard allows, with and
  without a tRNS chunk, interlaced (Adam7) and not, over all five
  scanline filters, decodes (`decode_png`, no Pillow) to what
  `PIL.Image.open(...).convert("RGBA")` gives, which is what `pt` decodes
  it to: 16-bit samples keep their high byte, 16-bit grey clamps to 255.
* JPG, TGA and WEBP decode through Pillow as in `pt`.
* The texture pool: `build_texture_pool` over DDS files (authored mips
  through `TexturePoolBuilder.add_mips`) and the other formats is
  bit-equal to `pt`'s, rows, offsets, sizes and mip counts.
"""

import io
import struct
import zlib

import numpy as np
import pytest

from pt.scene import dds as jdds
from pt.scene import textures as jtex
from pt.scene.types import TextureInfo as JInfo
from pt.scene.types import TextureType as JType
from pt_torch.scene import dds as tdds
from pt_torch.scene import textures as ttex
from pt_torch.scene.types import TextureInfo as TInfo
from pt_torch.scene.types import TextureType as TType

from tests.test_dds import (BLUE565, GREEN565, RED565, bc1_block, bc4_block,
                            make_dds)
from tests.test_import_robustness import _flips, _truncations
from tests.test_torch_import import DATA, _outcome, assert_same
from tests.test_torch_scene import _bits, _torch_bits
from torch_threads import one_torch_thread  # noqa: F401


# ------------------------------------------------------------------ DDS

def _dds_files():
    rng = np.random.default_rng(5)

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    lvl0 = bc1_block(RED565, RED565, [0] * 16) * 4
    lvl1 = bc1_block(BLUE565, BLUE565, [0] * 16)
    header = make_dds(4, 4, b"DX10", b"")
    return {
        "bc1": make_dds(8, 8, b"DXT1", rand(8 * 4)),
        "bc1_3color": make_dds(4, 4, b"DXT1",
                               bc1_block(BLUE565, RED565, [3, 2, 1, 0] * 4)),
        "bc2": make_dds(8, 4, b"DXT3", rand(16 * 2)),
        "bc3": make_dds(8, 8, b"DXT5", rand(16 * 4)),
        "bc3_green": make_dds(4, 4, b"DXT5",
                              bc4_block(255, 0, [1] * 16)
                              + bc1_block(GREEN565, BLUE565, [0] * 16)),
        "bc4": make_dds(8, 8, b"ATI1", rand(8 * 4)),
        "bc4_modes": make_dds(4, 4, b"BC4U",
                              bc4_block(0, 255, list(range(8)) * 2)),
        "bc5": make_dds(8, 8, b"ATI2", rand(16 * 4)),
        "bc5_dx10": header + struct.pack("<5I", 83, 3, 0, 1, 0)
        + bc4_block(128, 128, [0] * 16) * 2,
        "odd_size": make_dds(6, 6, b"DXT1", rand(8 * 4)),
        "mips": make_dds(8, 8, b"DXT1", lvl0 + lvl1, mip_count=2),
        "mips_full": make_dds(16, 16, b"DXT5", rand(16 * (16 + 4 + 1 + 1)),
                              mip_count=4),
        **{f.stem: f.read_bytes() for f in sorted(DATA.glob("*.dds"))},
    }


DDS = _dds_files()


@pytest.mark.parametrize("name", sorted(DDS))
def test_dds_decodes_as_pt(name, tmp_path):
    data = DDS[name]
    assert tdds.is_dds(data) == jdds.is_dds(data)
    for fn in ("parse_dds", "decode_dds"):
        want = _outcome(lambda: getattr(jdds, fn)(data))
        got = _outcome(lambda: getattr(tdds, fn)(data))
        assert want[0] == got[0]
        assert_same(want[1:], got[1:])
    path = tmp_path / f"{name}.dds"
    path.write_bytes(data)
    for source in ({"data": data}, {"path": str(path)}):
        j = JInfo(name, JType.COLOR, **source)
        t = TInfo(name, TType.COLOR, **source)
        jinfo, tinfo = jtex.get_texture_info(j), ttex.get_texture_info(t)
        assert (tinfo.width, tinfo.height) == (jinfo.width, jinfo.height)
        for fn in ("load_texture_pixels", "load_texture_mips"):
            assert_same(getattr(jtex, fn)(j), getattr(ttex, fn)(t), fn)


def test_dds_decode_levels_as_pt():
    """`decode_bc_level` per format on random blocks, and `decode_dds`
    with a level cap."""
    rng = np.random.default_rng(6)
    for fmt, size in (("bc1", 8), ("bc2", 16), ("bc3", 16), ("bc4", 8),
                      ("bc5", 16)):
        for w, h in ((4, 4), (8, 12), (5, 3)):
            blocks = ((w + 3) // 4) * ((h + 3) // 4)
            payload = rng.integers(0, 256, size * blocks,
                                   dtype=np.uint8).tobytes()
            assert_same(jdds.decode_bc_level(payload, w, h, fmt),
                        tdds.decode_bc_level(payload, w, h, fmt))
    data = DDS["mips_full"]
    for cap in (1, 2, 3):
        assert_same(jdds.decode_dds(data, max_levels=cap),
                    tdds.decode_dds(data, max_levels=cap))


@pytest.mark.parametrize("name", ["bc1", "bc5_dx10", "adv_legacy_dxt1",
                                  "adv_cubemap"])
def test_corrupt_dds_fails_as_pt(name):
    rng = np.random.default_rng(2)
    data = DDS[name]
    for v in _truncations(data) + _flips(data, rng, 30):
        for fn in ("parse_dds", "decode_dds"):
            want = _outcome(lambda: getattr(jdds, fn)(v))
            got = _outcome(lambda: getattr(tdds, fn)(v))
            assert want[0] == got[0]
            assert_same(want[1:], got[1:])


# ------------------------------------------------------------------ PNG

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _pack_rows(samples, depth):
    """(h, n) samples → (h, stride) bytes at `depth` bits, big-endian."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    bits = bits.reshape(h, -1).astype(np.uint8)
    pad = (-bits.shape[1]) % 8
    return np.packbits(np.concatenate(
        [bits, np.zeros((h, pad), np.uint8)], 1), axis=1)


def _filter(rows, bpp, first):
    """Scanlines filtered with types first, first+1, ... (mod 5)."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for y in range(rows.shape[0]):
        cur = rows[y].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        ft = (first + y) % 5
        if ft == 0:
            f = cur
        elif ft == 1:
            f = cur - left
        elif ft == 2:
            f = cur - prev
        elif ft == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            f = cur - np.where((pa <= pb) & (pa <= pc), left,
                               np.where(pb <= pc, prev, ul))
        out.append(bytes([ft]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def encode_png_any(img, ctype, depth, interlace=False, plte=None, trns=None,
                   first_filter=0):
    """A PNG of (h, w, channels) samples at any colour type and bit depth,
    Adam7-interlaced or not (Pillow writes neither 16-bit RGB nor
    interlaced files)."""
    h, w, ch = img.shape
    bpp = max(1, depth * ch // 8)
    if interlace:
        raw = b"".join(
            _filter(_pack_rows(img[y0::dy, x0::dx].reshape(
                len(range(y0, h, dy)), -1), depth), bpp, first_filter)
            for x0, y0, dx, dy in _ADAM7 if x0 < w and y0 < h)
    else:
        raw = _filter(_pack_rows(img.reshape(h, w * ch), depth), bpp,
                      first_filter)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _png_cases():
    cases = []
    for ctype, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                          (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            for interlace in (False, True):
                for trns in ((False, True) if ctype in (0, 2, 3)
                             else (False,)):
                    cases.append((ctype, depth, interlace, trns))
    return cases


def _png_bytes(ctype, depth, interlace, trns, size=(13, 11)):
    """A random image of the case, its tRNS key taken from a pixel that
    occurs, so that transparency shows."""
    rng = np.random.default_rng(ctype * 100 + depth * 2 + int(interlace))
    h, w = size
    ch = _CHANNELS[ctype]
    top = min(1 << depth, 6) if ctype == 3 else 1 << depth
    if depth == 16 and ctype == 0:
        top = 400              # around the clamp at 255
    img = rng.integers(0, top, (h, w, ch))
    plte = key = None
    if ctype == 3:
        plte = rng.integers(0, 256, (6, 3))
        key = bytes(rng.integers(0, 256, 4).tolist()) if trns else None
    elif trns and ctype == 0:
        key = struct.pack(">H", int(img[1, 2, 0]))
    elif trns:
        key = struct.pack(">HHH", *map(int, img[1, 2]))
    return encode_png_any(img, ctype, depth, interlace, plte, key,
                          first_filter=depth % 5)


@pytest.mark.parametrize("ctype, depth, interlace, trns", _png_cases(),
                         ids=lambda v: str(int(v)))
def test_png_decodes_as_pillow_and_pt(ctype, depth, interlace, trns):
    from PIL import Image
    data = _png_bytes(ctype, depth, interlace, trns)
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGBA"))
    got = ttex.decode_png(data)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    j = jtex.load_texture_pixels(JInfo("p", JType.COLOR, data=data))
    t = ttex.load_texture_pixels(TInfo("p", TType.COLOR, data=data))
    assert_same(j, t)
    j = jtex.get_texture_info(JInfo("p", JType.COLOR, data=data))
    t = ttex.get_texture_info(TInfo("p", TType.COLOR, data=data))
    assert (t.height, t.width) == (j.height, j.width) == (13, 11)


def test_png_quirks_match_pillow():
    """What the port copies from Pillow, spelled out: 16-bit grey clamps
    ([0, 300, 1000, 65535] → [0, 255, 255, 255]), 16-bit RGB keeps the
    high byte (0x1234 → 18)."""
    grey = np.asarray([0, 300, 1000, 65535]).reshape(1, 4, 1)
    got = ttex.decode_png(encode_png_any(grey, 0, 16))
    np.testing.assert_array_equal(got[0, :, 0], [0, 255, 255, 255])
    rgb = np.full((1, 1, 3), 0x1234)
    assert ttex.decode_png(encode_png_any(rgb, 2, 16))[0, 0, 0] == 18


def test_bad_png_is_none_as_in_pt():
    """Bad depth for its colour type, a broken CRC, a cut stream: the
    loaders give None (the pool's placeholder) in both packages."""
    good = _png_bytes(2, 8, False, False)
    bad_depth = encode_png_any(np.zeros((2, 2, 3), np.int64), 2, 8)
    bad_depth = bad_depth[:24] + bytes([4]) + bad_depth[25:]
    bad_crc = good[:40] + bytes([good[40] ^ 1]) + good[41:]
    for data in (bad_crc, good[:60], good[:8]):
        assert jtex.load_texture_pixels(JInfo("b", JType.COLOR,
                                              data=data)) is None
        assert ttex.load_texture_pixels(TInfo("b", TType.COLOR,
                                              data=data)) is None
    with pytest.raises(ValueError):
        ttex.decode_png(bad_depth)


# ------------------------------------------------------- Pillow formats

def _pillow_bytes(fmt, mode="RGB"):
    from PIL import Image
    rng = np.random.default_rng(len(fmt))
    px = rng.integers(0, 256, (9, 14, len(mode)), dtype=np.uint8)
    img = Image.fromarray(px[..., 0] if mode == "L" else px, mode)
    buf = io.BytesIO()
    img.save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


@pytest.mark.parametrize("fmt, mode", [("JPEG", "RGB"), ("JPEG", "L"),
                                       ("TGA", "RGB"), ("TGA", "RGBA"),
                                       ("WEBP", "RGB"), ("WEBP", "RGBA")])
def test_pillow_formats_decode_as_pt(fmt, mode, tmp_path):
    data = _pillow_bytes(fmt, mode)
    path = tmp_path / f"t.{fmt.lower()}"
    path.write_bytes(data)
    for source in ({"data": data}, {"path": str(path)}):
        j = JInfo("t", JType.COLOR, **source)
        t = TInfo("t", TType.COLOR, **source)
        assert_same(jtex.load_texture_pixels(j), ttex.load_texture_pixels(t))
        jtex.get_texture_info(j)
        ttex.get_texture_info(t)
        assert (t.width, t.height) == (j.width, j.height) == (14, 9)


# ------------------------------------------------------------- the pool

def test_pool_with_dds_mips_and_every_format_equals_pt(tmp_path):
    """One pool of every source kind: DDS with and without authored mips
    (from bytes and from a file), PNG (16-bit, interlaced), JPG, TGA,
    WEBP, HDR and a broken file. The pool's rows, offsets, sizes and mip
    counts equal `pt`'s; the authored level 1 of the 'mips' DDS is blue."""
    from pt.core.config import Config as JConfig
    from pt_torch.core.config import Config
    (tmp_path / "m.dds").write_bytes(DDS["mips_full"])
    from pt.out.saver import write_radiance_hdr
    write_radiance_hdr(str(tmp_path / "e.hdr"),
                       np.linspace(0, 4, 48, dtype=np.float32).reshape(4, 4,
                                                                       3))
    sources = [
        ("mips", JType.COLOR, {"data": DDS["mips"]}),
        ("m.dds", JType.NORMAL, {"path": str(tmp_path / "m.dds")}),
        ("bc5", JType.NORMAL, {"data": DDS["bc5"]}),
        ("png16", JType.COLOR, {"data": _png_bytes(6, 16, True, False)}),
        ("jpg", JType.COLOR, {"data": _pillow_bytes("JPEG")}),
        ("tga", JType.ROUGHNESS, {"data": _pillow_bytes("TGA", "RGBA")}),
        ("webp", JType.COLOR, {"data": _pillow_bytes("WEBP")}),
        ("hdr", JType.COLOR, {"path": str(tmp_path / "e.hdr")}),
        ("broken", JType.COLOR, {"data": b"\x89PNG\r\n\x1a\nbroken"}),
    ]
    jinfos = [JInfo(n, t, **s) for n, t, s in sources]
    tinfos = [TInfo(n, TType[t.name], **s) for n, t, s in sources]
    for budget in (2 << 30, 5000):
        jp = jtex.build_texture_pool(
            jinfos, JConfig(texture_memory_budget=budget, max_texture_size=8,
                            loader_thread_count=3))
        tp = ttex.build_texture_pool(
            tinfos, Config(texture_memory_budget=budget, max_texture_size=8,
                           loader_thread_count=3), device="cpu")
        assert tp.count == jp.count == 9 + len(sources)
        np.testing.assert_array_equal(_torch_bits(tp.data), _bits(jp.data))
        for name in ("offsets", "sizes", "mip_counts"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(jp, name)))
    pool = ttex.build_texture_pool(tinfos[:1], quad=False, device="cpu")
    row = pool.data[int(pool.offsets[9, 1])].float().numpy()
    np.testing.assert_allclose(row[:3], [0, 0, 1], atol=1e-2)
