"""Host scene layer of the PyTorch port against `pt`.

The Heightfield (n=16 and the bench size n=224) must flatten to
array-equal DeviceScene fields; the default texture pool must be bit-equal
(bf16 compared as its uint16 bits), as must a mipped sRGB pool. World
vertices and material/texture sampling match within rtol=1e-5, atol=1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pt.render import textures as jtex
from pt.render.materials import sample_material as j_sample_material
from pt.scene.examples import make_heightfield_scene as j_heightfield
from pt.scene.flatten import flatten_scene as j_flatten
from pt.scene.flatten import world_vertices as j_world_vertices
from pt_torch import convert
from pt_torch.render import textures as ttex
from pt_torch.render.materials import sample_material as t_sample_material
from pt_torch.scene.builder import SceneBuilder
from pt_torch.scene.examples import make_heightfield_scene as t_heightfield
from pt_torch.scene.flatten import DeviceScene
from pt_torch.scene.flatten import flatten_scene as t_flatten
from pt_torch.scene.flatten import world_vertices as t_world_vertices
from pt_torch.scene.types import Geometry, MeshInfo, MetallicRoughnessMaterial


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def _torch_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


@pytest.mark.parametrize("n", [16, 224])
def test_flatten_heightfield_array_equal(n):
    ts = t_flatten(t_heightfield(n), device="cpu")
    js = j_flatten(j_heightfield(n))
    assert ts.num_triangles == 2 * (n - 1) ** 2
    for f in dataclasses.fields(DeviceScene):
        got, want = getattr(ts, f.name), getattr(js, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f.name)
            assert got.numpy().dtype == np.asarray(want).dtype, f.name
            assert got.shape == np.asarray(want).shape, f.name
        else:
            assert got == want, f.name


def test_world_vertices_match():
    ts = t_flatten(t_heightfield(16), device="cpu")
    js = j_flatten(j_heightfield(16))
    for got, want in zip(t_world_vertices(ts), j_world_vertices(js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_convert_device_scene_round_trip():
    js = j_flatten(j_heightfield(16))
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    fields = {k: (np.asarray(v) if hasattr(v, "shape") else v)
              for k, v in fields.items()}
    ds = convert.device_scene(fields, device="cpu")
    ref = t_flatten(t_heightfield(16), device="cpu")
    for f in dataclasses.fields(DeviceScene):
        got, want = getattr(ds, f.name), getattr(ref, f.name)
        if isinstance(got, torch.Tensor):
            assert torch.equal(got, want), f.name
        else:
            assert got == want, f.name


def test_default_texture_pool_bit_equal():
    tp = ttex.default_texture_pool(device="cpu")
    jp = jtex.default_texture_pool()
    assert tp.data.dtype == torch.bfloat16 and tuple(tp.data.shape) == (9, 16)
    np.testing.assert_array_equal(_torch_bits(tp.data), _bits(jp.data))
    for name in ("offsets", "sizes", "mip_counts"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    assert (tp.all_constant, tp.paired, tp.quad) == (jp.all_constant,
                                                     jp.paired, jp.quad)
    conv = convert.device_textures(
        {"data": np.asarray(jp.data), "offsets": np.asarray(jp.offsets),
         "sizes": np.asarray(jp.sizes), "mip_counts": np.asarray(jp.mip_counts),
         "all_constant": jp.all_constant, "paired": jp.paired,
         "quad": jp.quad}, device="cpu")
    assert torch.equal(conv.data.view(torch.int16), tp.data.view(torch.int16))


def _textured_pools(layout):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (16, 8, 4)).astype(np.float32)
    hdr = rng.uniform(0, 4, (4, 4, 3)).astype(np.float32)
    out = []
    for mod in (ttex, jtex):
        b = mod.TexturePoolBuilder(**layout)
        mod.add_default_textures(b)
        b.add(img, srgb=True)
        b.add(img[..., :3], srgb=False, generate_mips=False)
        if layout.get("quad") is False:
            b.add(hdr)                 # HDR-range texels keep f32 rows
        out.append(b.build(device="cpu") if mod is ttex else b.build())
    return out


@pytest.mark.parametrize("layout", [{}, {"quad": False, "paired": True},
                                    {"quad": False, "paired": False}],
                         ids=["quad", "paired", "flat"])
def test_texture_pool_bit_equal_and_sampling(layout):
    tp, jp = _textured_pools(layout)
    np.testing.assert_array_equal(_torch_bits(tp.data), _bits(jp.data))
    for name in ("offsets", "sizes", "mip_counts"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    rng = np.random.default_rng(4)
    n = 4096
    idx = rng.integers(0, tp.count, n).astype(np.int32)
    idx[:3] = [tp.count + 5, 9, 10]     # past the table: clamped like JAX
    uv = rng.uniform(-2, 3, (n, 2)).astype(np.float32)
    dx, dy = rng.uniform(-0.2, 0.2, (2, n, 2)).astype(np.float32)
    for kw in ({}, {"nearest_mip": True}):
        got = ttex.sample_texture_grad(tp, torch.as_tensor(idx),
                                       torch.as_tensor(uv),
                                       torch.as_tensor(dx),
                                       torch.as_tensor(dy), **kw)
        want = jtex.sample_texture_grad(jp, jnp.asarray(idx), jnp.asarray(uv),
                                        jnp.asarray(dx), jnp.asarray(dy), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    got = ttex.sample_texture_grad(tp, torch.as_tensor(idx),
                                   torch.as_tensor(uv))
    want = jtex.sample_texture_grad(jp, jnp.asarray(idx), jnp.asarray(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_sample_material_matches_pt():
    ts = t_flatten(t_heightfield(16), device="cpu")
    js = j_flatten(j_heightfield(16))
    tp, jp = _textured_pools({})
    rng = np.random.default_rng(5)
    n = 2048
    rows = np.zeros(n, np.int32)
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    inside = rng.uniform(0, 1, n) < 0.3
    dx, dy = rng.uniform(-0.05, 0.05, (2, n, 2)).astype(np.float32)
    got = t_sample_material(ts, tp, torch.as_tensor(rows), torch.as_tensor(uv),
                            torch.as_tensor(inside), torch.as_tensor(dx),
                            torch.as_tensor(dy))
    want = j_sample_material(js, jp, jnp.asarray(rows), jnp.asarray(uv),
                             jnp.asarray(inside), jnp.asarray(dx),
                             jnp.asarray(dy))
    for f in dataclasses.fields(got):
        np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                   np.asarray(getattr(want, f.name)),
                                   rtol=1e-5, atol=1e-6, err_msg=f.name)


def test_skinned_scene_raises():
    """A skinned scene flattens (tests/test_torch_animated.py holds it
    against `pt`); what raises is a bone index outside the palette, which a
    tensor gather would not clamp as JAX does."""
    def scene(bone):
        b = SceneBuilder("skinned")
        pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        nrm = np.tile([0.0, 0.0, 1.0], (3, 1)).astype(np.float32)
        idx = np.zeros((3, 4), np.int32)
        idx[2, 0] = bone
        vb = b.add_animated_vertices(pos, np.zeros((3, 2), np.float32), nrm,
                                     nrm, nrm, idx,
                                     np.tile([1.0, 0, 0, 0], (3, 1)))
        ib = b.add_animated_indices([0, 1, 2])
        geo = b.add_geometry(Geometry(vb, 3, ib, 3, True, is_animated=True))
        mat = b.add_material("m", MetallicRoughnessMaterial())
        node = b.add_scene_node(0, np.eye(4))
        b.add_bone("root", node, np.eye(4))
        b.add_model_instance(b.add_model([MeshInfo(geo, mat)]), node)
        return b.create_scene()
    ds = t_flatten(scene(0), device="cpu")
    assert ds.has_skinning and tuple(ds.bone_palette.shape) == (1, 4, 4)
    np.testing.assert_allclose(t_world_vertices(ds)[0].numpy()[1], [1, 0, 0],
                               atol=1e-6)
    with pytest.raises(ValueError, match="palette"):
        t_flatten(scene(3), device="cpu")
