"""The static main path of the PyTorch port against `pt` on the CPU.

* Bounce-0 carry parity against `pt.render.integrator.bounce_once` with
  `pt` on its brute backend: RNG states and liveness bit-equal, floats
  within rtol=1e-4, atol=1e-5 (several chained f32 stages).
* The film of `Renderer(device="cpu")` against `pt`'s Renderer (brute on
  the CPU) on the Heightfield (n=16) at 32², 1 spp, 3 bounces: MSE < 1e-3,
  the project's standing film contract.
* The miss shader (clear, equirect, cube skyboxes) and `postprocess`
  within rtol=1e-5 of `pt`'s; PNG and HDR writers.
"""

import dataclasses
import struct
import zlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pt.post.pipeline import PostProcessSettings as JPost
from pt.post.pipeline import postprocess as j_postprocess
from pt.render import integrator as jint
from pt.run.renderer import Renderer as JRenderer
from pt.scene.examples import make_heightfield_scene as j_heightfield
from pt.scene.flatten import flatten_scene as j_flatten
from pt.render.textures import default_texture_pool as j_default_pool
from pt_torch.out.saver import encode_png, write_image, write_radiance_hdr
from pt_torch.post.pipeline import PostProcessSettings, postprocess
from pt_torch.render import integrator as tint
from pt_torch.run.renderer import Renderer, _tile_order
from pt_torch.scene.examples import make_heightfield_scene as t_heightfield
from pt_torch.scene.flatten import flatten_scene as t_flatten


def _pixels(w, h):
    order = _tile_order(w, h)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return xs.reshape(-1)[order], ys.reshape(-1)[order]


def test_bounce0_carry_matches_pt_brute():
    w = h = 32
    px, py = _pixels(w, h)
    r = Renderer(tint.PathTracingSettings(bounce_count=1), device="cpu")
    r.set_scene(t_heightfield(16), stream_textures=False)
    r.on_resize(w, h)
    r._ensure_accel()
    iv, ip = r._camera_mats()
    pxt, pyt = torch.as_tensor(px), torch.as_tensor(py)
    state = tint.init_rng_state(pxt, pyt, w, 3)
    state, o, d, diff = tint.raygen(pxt, pyt, w, h, iv, ip, state, r.settings)
    tc = tint.bounce_once(r.ds, r.tex, r.accel, tint.start_carry(state, o, d,
                                                                 diff),
                          r.settings, bounce=0)

    js = j_flatten(j_heightfield(16))
    jset = jint.PathTracingSettings(bounce_count=1, backend="brute")
    jacc = jint.prepare_accel(js, jset)
    assert jacc.bvh is None                               # the brute backend
    jpx, jpy = jnp.asarray(px.astype(np.uint32)), jnp.asarray(py.astype(np.uint32))
    jstate = jint.init_rng_state(jpx, jpy, w, 3)
    jstate, jo, jd, jdiff = jint.raygen(jpx, jpy, w, h, jnp.asarray(iv.numpy()),
                                        jnp.asarray(ip.numpy()), jstate, jset)
    jc = jint.bounce_once(js, j_default_pool(), jacc,
                          jint.start_carry(jstate, jo, jd, jdiff), jset,
                          sort_rays=False, rr_div=1.0, tail=False)

    np.testing.assert_array_equal(tc.state.numpy().astype(np.uint32),
                                  np.asarray(jc.state))
    np.testing.assert_array_equal(tc.alive.numpy(), np.asarray(jc.alive))
    assert int(tc.rays) == int(jc.rays)
    alive = tc.alive.numpy()
    assert 0 < alive.sum() < alive.size
    for name in ("origin", "direction", "throughput"):
        np.testing.assert_allclose(getattr(tc, name).numpy()[alive],
                                   np.asarray(getattr(jc, name))[alive],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    for name in ("radiance", "max_roughness"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    for a, b in zip(tc.diff, jc.diff):
        np.testing.assert_allclose(a.numpy()[alive], np.asarray(b)[alive],
                                   rtol=1e-4, atol=1e-4)


def test_film_matches_pt_renderer():
    r = Renderer(tint.PathTracingSettings(sample_count=1, bounce_count=3),
                 device="cpu")
    r.set_scene(t_heightfield(16), stream_textures=False)
    r.on_resize(32, 32)
    assert r.render() == 1
    film = r.film_mean()
    jr = JRenderer(jint.PathTracingSettings(sample_count=1, bounce_count=3))
    jr.set_scene(j_heightfield(16))
    jr.on_resize(32, 32)
    jr.render()
    jfilm = jr.film_mean()
    assert film.shape == jfilm.shape == (32, 32, 3)
    assert np.isfinite(film).all() and film.max() > 0
    mse = float(np.mean((film - jfilm) ** 2))
    assert mse < 1e-3, mse
    assert abs(r.rays_traced - jr.rays_traced) <= 0.01 * jr.rays_traced
    snap = r.snapshot()
    assert snap.shape == (32, 32, 3) and (0 <= snap).all() and (snap <= 1).all()


@pytest.mark.parametrize("kind", ["clear", "equirect", "cube"])
def test_skybox_matches_pt(kind):
    from pt.scene.types import SkyboxKind
    rng = np.random.default_rng(3)
    img = {"clear": np.zeros((1, 1, 3)),
           "equirect": rng.uniform(0, 4, (16, 32, 3)),
           "cube": rng.uniform(0, 1, (6, 8, 8, 3))}[kind].astype(np.float32)
    code = int(getattr(SkyboxKind, kind.upper()))
    js = dataclasses.replace(j_flatten(j_heightfield(8)), skybox_kind=code,
                             skybox_image=jnp.asarray(img))
    ts = dataclasses.replace(t_flatten(t_heightfield(8), device="cpu"),
                             skybox_kind=code,
                             skybox_image=torch.as_tensor(img))
    d = rng.normal(size=(4096, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
             [0, 0, -1]]
    np.testing.assert_allclose(
        tint._skybox_emissive(ts, torch.as_tensor(d)).numpy(),
        np.asarray(jint._skybox_emissive(js, jnp.asarray(d))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bloom", [True, False])
def test_postprocess_matches_pt(bloom):
    rng = np.random.default_rng(0)
    accum = rng.gamma(0.5, 2.0, (48, 64, 3)).astype(np.float32)
    accum[3, 5] = 500.0                    # a firefly that blooms
    accum[7, 9, 1] = np.nan                # sentinel pixels
    accum[8, 9, 0] = np.inf
    settings = dict(exposure=1.3, bloom_threshold=0.9, bloom_intensity=0.4,
                    enable_bloom=bloom)
    got = postprocess(torch.as_tensor(accum), 4.0,
                      PostProcessSettings(**settings))
    want = j_postprocess(jnp.asarray(accum), 4.0, JPost(**settings))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _read_png(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks.append((tag, body))
        pos += 12 + length
    assert [c[0] for c in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, ctype, _, _, _ = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, ctype) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()                 # filter type 0
    return rows[:, 1:].reshape(h, w, 3)


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(-0.2, 1.2, (21, 34, 3)).astype(np.float32)
    path = tmp_path / "frame.png"
    write_image(str(path), img)
    want = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(_read_png(path.read_bytes()), want)
    assert encode_png(want) == path.read_bytes()
    # jpg and tga are written now (through Pillow, as pt's); a format the
    # port does not write still raises
    with pytest.raises(ValueError):
        write_image(str(tmp_path / "frame.bmp"), img)


def test_hdr_bytes_match_pt(tmp_path):
    from pt.out.saver import write_radiance_hdr as j_write_hdr
    rng = np.random.default_rng(2)
    img = rng.gamma(1.0, 3.0, (9, 13, 3)).astype(np.float32)
    img[0, 0] = 0.0
    write_radiance_hdr(str(tmp_path / "a.hdr"), img)
    j_write_hdr(str(tmp_path / "b.hdr"), img)
    assert (tmp_path / "a.hdr").read_bytes() == (tmp_path / "b.hdr").read_bytes()


def test_unported_paths_raise():
    """Multi-device rendering is ported (`tests/test_torch_dist.py`): a
    mesh raises only where the Renderer cannot shard film rows over it, a
    2-D mesh, whose second axis `pt`'s stages do not use either."""
    scene = t_heightfield(8)

    class TwoAxes:
        ndim = 2
    with pytest.raises(ValueError, match="1-D mesh"):
        Renderer(device="cpu", mesh=TwoAxes())
    # shared-BLAS instancing renders now, through the instanced structure
    r = Renderer(device="cpu", instancing="shared")
    r.set_scene(scene, stream_textures=False)
    r.on_resize(8, 8)
    assert r.render(1) == 1 and np.isfinite(r.film_mean()).all()
    assert type(r.accel.bvh).__name__ == "BF8Instanced"
    flat = Renderer(device="cpu", instancing="flatten")
    flat.set_scene(t_heightfield(8), stream_textures=False)
    flat.on_resize(8, 8)
    flat.render(1)
    assert float(np.mean((r.film_mean() - flat.film_mean()) ** 2)) < 1e-3
    # an alpha-tested scene renders; a DDS texture is decoded now (queue 1,
    # item 6), and one whose header names no format becomes pt's magenta
    # placeholder instead of raising
    alpha = t_heightfield(8)
    alpha.geometries[0] = dataclasses.replace(alpha.geometries[0],
                                              is_opaque=False)
    r = Renderer(device="cpu")
    r.set_scene(alpha, stream_textures=False)
    r.on_resize(8, 8)
    assert r.render(1) == 1 and np.isfinite(r.film_mean()).all()
    from pt_torch.scene.types import TextureInfo, TextureType
    alpha.textures.append(TextureInfo("a.dds", TextureType.COLOR,
                                      data=b"DDS " + bytes(124)))
    r = Renderer(device="cpu")
    r.set_scene(alpha, stream_textures=False)
    assert r.tex.count == 9 + 1 and int(r.tex.mip_counts[9]) == 1
