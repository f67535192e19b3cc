"""The Courtyard, the Default scene, the embedded art and the texture file
decoders of the PyTorch port against `pt` on the CPU.

* `make_courtyard_scene(detail=0.1, tex_scale=0.05)`, its flythrough,
  `make_default_scene()` and the Roughness Test Cubes, MetallicRoughness
  Cubes and Reuse Mesh scenes: every array and scalar of the `Scene`
  equals `pt`'s; the flattened `DeviceScene` is array-equal (the
  MetallicRoughness one also after its light's node has moved) and the
  texture pool bit-equal (bf16 compared as its uint16 bits).
* `decode_png` (standard library only) gives exactly what `pt`'s
  `_decode_bytes` gives through Pillow, on the four embedded PNGs, on
  seeded PNGs written by the port's own writer (grey, grey+alpha, RGB, RGBA)
  and on Pillow-written ones that use all five scanline filters, a palette
  and tRNS chunks. A Radiance HDR written by the port reads back equal to
  `pt`'s reader, RLE files included.
* The film of the Default scene at 32², 1 spp, 3 bounces against `pt`'s
  Renderer on its brute backend: MSE < 1e-3, the project's film contract.
"""

import dataclasses
import enum
import io
import struct
import zlib

import numpy as np
import pytest
import torch

from pt import resources as jres
from pt.render import integrator as jint
from pt.run.renderer import Renderer as JRenderer
from pt.scene import examples as jex
from pt.scene import standin as jstand
from pt.scene import textures as jstex
from pt.scene.flatten import flatten_scene as j_flatten
from pt_torch import resources as tres
from pt_torch.accel import bvh8 as tbvh
from pt_torch.out.saver import encode_png, write_radiance_hdr
from pt_torch.render import integrator as tint
from pt_torch.run.renderer import Renderer
from pt_torch.scene import examples as tex_
from pt_torch.scene import standin as tstand
from pt_torch.scene import textures as tstex
from pt_torch.scene.flatten import DeviceScene
from pt_torch.scene.flatten import flatten_scene as t_flatten
from pt_torch.scene.types import TextureInfo, TextureType


def _same(a, b, path="scene"):
    """`a` (port) equals `b` (pt), recursively: arrays with dtype and shape,
    dataclasses and plain objects by attribute, sequences and mappings by
    item, enums by value, scalars by ==. Callables are not compared."""
    if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(b, (bytes, str, int, float, bool, type(None))) \
            or isinstance(b, enum.Enum):
        assert type(a).__name__ == type(b).__name__, path
        assert (a.value == b.value if isinstance(b, enum.Enum) else a == b), \
            path
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif callable(b) and not hasattr(b, "__dict__"):
        assert callable(a), path
    else:
        assert type(a).__name__ == type(b).__name__, path
        names = ([f.name for f in dataclasses.fields(b)]
                 if dataclasses.is_dataclass(b) else sorted(vars(b)))
        assert names == ([f.name for f in dataclasses.fields(a)]
                         if dataclasses.is_dataclass(a)
                         else sorted(vars(a))), path
        for k in names:
            x, y = getattr(a, k), getattr(b, k)
            if callable(y) and not isinstance(y, type) \
                    and type(y).__name__ in ("function", "method"):
                continue
            _same(x, y, f"{path}.{k}")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _torch_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _assert_device_scene_equal(ts, js):
    for f in dataclasses.fields(DeviceScene):
        got, want = getattr(ts, f.name), getattr(js, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f.name)
            assert got.numpy().dtype == np.asarray(want).dtype, f.name
            assert got.shape == np.asarray(want).shape, f.name
        else:
            assert got == want, f.name


def _assert_pool_equal(tp, jp):
    assert tp.data.shape == jp.data.shape
    np.testing.assert_array_equal(_torch_bits(tp.data), _bits(jp.data))
    for name in ("offsets", "sizes", "mip_counts"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    assert (tp.all_constant, tp.paired, tp.quad) == (jp.all_constant,
                                                     jp.paired, jp.quad)


SCENES = {
    "courtyard": (lambda: tstand.make_courtyard_scene(0.1, 0.05),
                  lambda: jstand.make_courtyard_scene(0.1, 0.05)),
    "flythrough": (lambda: tstand.make_courtyard_flythrough_scene(0.1, 0.05),
                   lambda: jstand.make_courtyard_flythrough_scene(0.1, 0.05)),
    "default": (tex_.make_default_scene, jex.make_default_scene),
    "roughness": (tex_.make_roughness_test_scene,
                  jex.make_roughness_test_scene),
    "metallic_roughness": (tex_.make_metallic_roughness_cubes_scene,
                           jex.make_metallic_roughness_cubes_scene),
    "reuse_mesh": (tex_.make_reuse_mesh_scene, jex.make_reuse_mesh_scene),
}


@pytest.mark.parametrize("which", list(SCENES))
def test_scene_equals_pt(which):
    ts, js = (f() for f in SCENES[which])
    _same(ts, js)
    assert len(ts.textures) == {"courtyard": 59, "flythrough": 59,
                                "default": 4, "roughness": 0,
                                "metallic_roughness": 12,
                                "reuse_mesh": 0}[which]
    _assert_device_scene_equal(t_flatten(ts, device="cpu"), j_flatten(js))
    _assert_pool_equal(tstex.build_scene_textures(ts, device="cpu"),
                       jstex.build_scene_textures(js))
    if which == "flythrough":
        # the orbit camera follows its node in both packages
        assert ts.update(0.5) == js.update(0.5) is True
        np.testing.assert_array_equal(np.asarray(ts.cameras[0].inv_view),
                                      np.asarray(js.cameras[0].inv_view))
        assert not ts.has_animated_instances
    if which == "metallic_roughness":
        # the light's node is keyframed: the light moves, no instance does
        assert ts.update(3.0) == js.update(3.0) is True
        assert not ts.has_animated_instances
        _assert_device_scene_equal(t_flatten(ts, device="cpu"),
                                   j_flatten(js))


def test_courtyard_instancing_numbers():
    """What decides the Courtyard's path: at full detail it has more
    flatten segments than the shared-BLAS cap and little duplication, so
    "auto" keeps it flat and "shared" is infeasible."""
    from pt_torch.accel.instanced import MAX_SEGS
    from pt_torch.scene.flatten import shared_dup_ratio
    full = tstand.make_courtyard_scene(1.0, 0.02)
    segs = sum(len(full.models[i.model_index].meshes)
               for i in full.instances)
    dup, total = shared_dup_ratio(full)
    assert segs == 1135 > MAX_SEGS and total == 212884
    assert abs(dup - 1.88) < 0.01
    assert not Renderer._want_instanced("auto", dup, total)
    part = tstand.make_courtyard_scene(0.85, 0.02)
    assert sum(len(part.models[i.model_index].meshes)
               for i in part.instances) == 985


def test_test_scenes_catalog():
    assert list(tex_.TEST_SCENES) == list(jex.TEST_SCENES) == [
        "Default", "MetallicRoughness Cubes", "Roughness Test Cubes",
        "Heightfield", "Reuse Mesh", "Courtyard", "Courtyard Flythrough"]
    assert tex_.TEST_SCENES["Default"]().name == "Default"
    geos = tex_.add_cube(tex_.SceneBuilder("cube"))
    assert len(geos) == 6


# ------------------------------------------------------------- decoders

def _j_decode(data):
    return jstex._decode_bytes(data, "t")


def _t_decode(data):
    return tstex._decode_bytes(data, "t")


@pytest.mark.parametrize("name", jres.NAMES)
def test_embedded_png_decodes_as_pt(name):
    assert tres.NAMES == jres.NAMES
    data = tres.texture_bytes(name)
    assert data == jres.texture_bytes(name)
    rgba = tres.texture_rgba(name)
    np.testing.assert_array_equal(rgba, jres.texture_rgba(name))
    assert rgba.dtype == np.uint8 and rgba.shape[2] == 4
    got, want = _t_decode(data), _j_decode(data)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    info = tstex.get_texture_info(TextureInfo(name, TextureType.COLOR,
                                              data=data))
    jinfo = jstex.get_texture_info(jex.TextureInfo(
        name=name, type=jex.TextureType.COLOR, data=data))
    assert (info.width, info.height) == (jinfo.width, jinfo.height) \
        == rgba.shape[1::-1]


@pytest.mark.parametrize("channels", [1, 2, 3, 4],
                         ids=["grey", "grey_alpha", "rgb", "rgba"])
def test_own_writer_png_decodes_as_pt(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (13, 21, channels), dtype=np.uint8)
    data = encode_png(img[..., 0] if channels == 1 else img)
    got, want = _t_decode(data), _j_decode(data)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (13, 21, 4) and got.dtype == np.float32
    rgba = tstex.decode_png(data)
    np.testing.assert_array_equal(rgba[..., 0], img[..., 0])
    np.testing.assert_array_equal(rgba[..., 3],
                                  img[..., -1] if channels in (2, 4) else 255)


def _filtered_png(img, ftype, ctype):
    """A PNG of `img` (H, W, C) with scanline filter `ftype` applied to
    every row by the textbook forward filters."""
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch).astype(np.int32)
    out = bytearray()
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        out += bytes([ftype]) + ((cur - pred) & 0xFF).astype(np.uint8) \
            .tobytes()

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_scanline_filters_decode_as_pt(ftype):
    rng = np.random.default_rng(10 + ftype)
    for ctype, ch in ((0, 1), (4, 2), (2, 3), (6, 4)):
        img = rng.integers(0, 256, (9, 17, ch), dtype=np.uint8)
        data = _filtered_png(img, ftype, ctype)
        np.testing.assert_array_equal(_t_decode(data), _j_decode(data))
        np.testing.assert_array_equal(tstex.decode_png(data)[..., 0],
                                      img[..., 0])


@pytest.mark.parametrize("case", ["palette", "palette_trns", "grey_trns",
                                  "rgb_trns", "adaptive"])
def test_pillow_written_png_decodes_as_pt(case):
    from PIL import Image
    rng = np.random.default_rng(20)
    buf = io.BytesIO()
    if case.startswith("palette"):
        im = Image.fromarray(rng.integers(0, 200, (11, 19), dtype=np.uint8),
                             "P")
        im.putpalette(rng.integers(0, 256, 200 * 3, dtype=np.uint8).tolist())
        kw = ({"transparency": bytes(rng.integers(0, 256, 150,
                                                  dtype=np.uint8))}
              if case == "palette_trns" else {})
        im.save(buf, "PNG", **kw)
    elif case == "grey_trns":
        Image.fromarray(rng.integers(0, 8, (11, 19), dtype=np.uint8) * 30,
                        "L").save(buf, "PNG", transparency=90)
    elif case == "rgb_trns":
        img = rng.integers(0, 2, (11, 19, 3), dtype=np.uint8) * 255
        Image.fromarray(img, "RGB").save(buf, "PNG",
                                         transparency=(255, 0, 255))
    else:
        # a smooth image: Pillow's encoder picks filters row by row
        yy, xx = np.mgrid[0:40, 0:56]
        img = np.stack([xx * 4, yy * 6, (xx + yy) * 2, 255 - xx * 3],
                       -1).astype(np.uint8)
        Image.fromarray(img, "RGBA").save(buf, "PNG", optimize=True)
    data = buf.getvalue()
    got, want = _t_decode(data), _j_decode(data)
    np.testing.assert_array_equal(got, want)
    if case.endswith("trns"):
        assert 0 < (got[..., 3] < 1).sum() < got[..., 3].size


def test_png_decoder_refuses_what_it_does_not_take():
    img = np.zeros((4, 4, 3), np.uint8)
    good = encode_png(img)
    assert tstex.decode_png(good).shape == (4, 4, 4)

    def with_header(depth, ctype, interlace):
        ihdr = struct.pack(">IIBBBBB", 4, 4, depth, ctype, 0, 0, interlace)
        crc = struct.pack(">I", zlib.crc32(b"IHDR" + ihdr) & 0xFFFFFFFF)
        return good[:16] + ihdr + crc + good[33:]
    # what the standard does not allow: colour type 5, a 16-bit palette,
    # 2-bit RGB, interlace method 2
    for bad in (with_header(8, 5, 0), with_header(16, 3, 0),
                with_header(2, 2, 0), with_header(8, 2, 2)):
        with pytest.raises(ValueError, match="unsupported PNG"):
            tstex.decode_png(bad)
    # 16-bit RGB, Adam7 and 4-bit palettes are taken now (queue 1, item 6):
    # under this 8-bit RGB image data they fail on its length instead
    for other in (with_header(16, 2, 0), with_header(8, 2, 1),
                  with_header(4, 3, 0)):
        with pytest.raises(ValueError, match="wrong length|PLTE"):
            tstex.decode_png(other)
    with pytest.raises(ValueError, match="CRC"):
        tstex.decode_png(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    with pytest.raises(ValueError, match="not a PNG"):
        tstex.decode_png(b"GIF89a" + good)
    # other formats go to Pillow, as in pt: a broken one raises there and
    # the loader gives the placeholder
    with pytest.raises(OSError):
        tstex._decode_bytes(b"\xff\xd8\xff\xe0 a jpeg", "photo.jpg")
    assert tstex.load_texture_pixels(TextureInfo(
        "photo.jpg", TextureType.COLOR, data=b"\xff\xd8\xff\xe0")) is None
    # an undecodable texture becomes the magenta placeholder, as in pt
    info = TextureInfo("broken.png", TextureType.COLOR, data=good[:20])
    assert tstex.load_texture_pixels(info) is None
    pool = tstex.build_texture_pool([info], device="cpu")
    jpool = jstex.build_texture_pool([jex.TextureInfo(
        name="broken.png", type=jex.TextureType.COLOR, data=good[:20])])
    _assert_pool_equal(pool, jpool)


def test_radiance_hdr_reads_back_as_pt(tmp_path):
    rng = np.random.default_rng(30)
    img = rng.gamma(1.0, 3.0, (9, 13, 3)).astype(np.float32)
    img[0, 0] = 0.0
    path = tmp_path / "sky.hdr"
    write_radiance_hdr(str(path), img)
    data = path.read_bytes()
    got, want = tstex.read_radiance_hdr(data), jstex.read_radiance_hdr(data)
    np.testing.assert_array_equal(got, want)
    # RGBE keeps 8 bits of the largest channel (truncated, not rounded)
    assert (np.abs(got - img) <= img.max(axis=-1, keepdims=True) / 128).all()
    np.testing.assert_array_equal(_t_decode(data), _j_decode(data))
    # adaptive-RLE scanlines (runs and literals) and old-style RLE repeats
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 8\n"
    line = b"\x02\x02\x00\x08" + b"".join(
        bytes([128 + 5, v]) + bytes([3, v, v + 1, v + 2])
        for v in (10, 60, 110, 129))
    old = head.replace(b"+X 8", b"+X 6") + bytes(
        [9, 8, 7, 130, 1, 1, 1, 2, 5, 5, 5, 128, 1, 1, 1, 2]) * 2
    for blob in (head + line + line, old):
        np.testing.assert_array_equal(tstex.read_radiance_hdr(blob),
                                      jstex.read_radiance_hdr(blob))
    with pytest.raises(ValueError, match="not a Radiance"):
        tstex.read_radiance_hdr(b"P6\n1 1\n255\n")


def test_texture_from_file_path(tmp_path):
    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, (8, 16, 4), dtype=np.uint8)
    path = tmp_path / "t.png"
    path.write_bytes(encode_png(img))
    info = tstex.get_texture_info(TextureInfo("t.png", TextureType.COLOR,
                                              path=str(path)))
    assert (info.width, info.height) == (16, 8)
    np.testing.assert_array_equal(tstex.load_texture_pixels(info),
                                  img.astype(np.float32) / 255.0)
    missing = TextureInfo("gone.png", TextureType.COLOR,
                          path=str(tmp_path / "gone.png"))
    assert tstex.get_texture_info(missing).width in (0, None)
    assert tstex.load_texture_pixels(missing) is None


# ---------------------------------------------------------- Default film

def test_default_film_matches_pt_renderer():
    """32², 1 spp, 3 bounces, same RNG. The Default scene has 36 triangles:
    two leaves of block 32 under a one-node BF8 tree (K1/K2, their plain
    versions here)."""
    r = Renderer(tint.PathTracingSettings(sample_count=1, bounce_count=3),
                 device="cpu")
    r.set_scene(tex_.make_default_scene(), stream_textures=False)
    r.on_resize(32, 32)
    assert r.render() == 1
    assert r.ds.num_triangles == 36 and not r.tex.all_constant
    assert isinstance(r.accel.bvh, tbvh.BF8BVH) and r.accel.bvh.n8 == 1
    assert r.accel.bvh.n_leaves == 2 and r.accel.alpha_split is None
    film = r.film_mean()
    jr = JRenderer(jint.PathTracingSettings(sample_count=1, bounce_count=3,
                                            backend="brute"))
    jr.set_scene(jex.make_default_scene(), stream_textures=False)
    jr.on_resize(32, 32)
    jr.render()
    jfilm = jr.film_mean()
    assert np.isfinite(film).all() and film.max() > 0
    mse = float(np.mean((film - jfilm) ** 2))
    assert mse < 1e-3, mse
    assert abs(r.rays_traced - jr.rays_traced) <= 0.01 * jr.rays_traced
    # background pixels, bloom off: 1 - exp(-skybox colour)
    from pt_torch.post.pipeline import PostProcessSettings, postprocess
    snap = postprocess(r.accum, 1.0, PostProcessSettings(enable_bloom=False))
    sky = 1.0 - np.exp(-r.ds.skybox_color.numpy())
    assert np.abs(snap.numpy() - sky).max(axis=-1).min() < 1e-6
