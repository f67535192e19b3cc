"""The animated frame loop and the alpha paths of the PyTorch port against
`pt`, on the CPU.

* Skinning (`world_vertices`) and `update_seg_transforms` on the two-bone
  scene of tests/test_skinning.py: rtol=1e-5 against `pt`.
* The in-memory texture pool (`build_scene_textures`) bit-equal to `pt`'s,
  with the budget downscale and `pt`'s `paired`/`quad` behaviour; a texture
  given as encoded bytes raises, naming the decoders' slice.
* The alpha loops on the same structure as `pt` walks: `pt`'s Morton tree
  converted, `pt` tracing it through its Pallas kernel in interpret mode.
  Hit ids, decals and occlusion are equal off the near-edge budget (≤ 1% of
  rays: the bf16 leaf product). The split loops against `pt`'s split over
  its brute backend: exact ids.
* The slice as a whole: a small animated alpha scene, 32², 1 spp, 3 bounces,
  two frames, same-RNG film MSE < 1e-3 against `pt`'s Renderer for each
  frame; the static split variant alike; and the static v4 fallback.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from pt.accel import pallas_bvh as jbvh
from pt.render import integrator as jint
from pt.run.renderer import Renderer as JRenderer
from pt.scene import textures as jstex
from pt.scene.flatten import flatten_scene as j_flatten
from pt.scene.flatten import update_seg_transforms as j_update
from pt.scene.flatten import world_vertices as j_world_vertices
from pt_torch import convert
from pt_torch.accel import bvh8 as tbvh
from pt_torch.core.config import Config
from pt_torch.render import integrator as tint
from pt_torch.run.renderer import Renderer
from pt_torch.scene import textures as tstex
from pt_torch.scene.flatten import flatten_scene as t_flatten
from pt_torch.scene.flatten import update_seg_transforms as t_update
from pt_torch.scene.flatten import world_vertices as t_world_vertices

from test_torch_accel import T, _fields, pallas_interpret  # noqa: F401
from test_torch_scene import _bits, _torch_bits
from torch_threads import one_torch_thread  # noqa: F401


def _ns(pkg):
    """The scene-building names of package `pkg` ("pt" or "pt_torch")."""
    import importlib
    m = {k: importlib.import_module(f"{pkg}.scene.{k}")
         for k in ("builder", "examples", "graph", "types")}
    return types.SimpleNamespace(
        SceneBuilder=m["builder"].SceneBuilder,
        create_heightfield_scene=m["examples"].create_heightfield_scene,
        Animation=m["graph"].Animation,
        AnimationNode=m["graph"].AnimationNode,
        KeySequence=m["graph"].KeySequence, Geometry=m["types"].Geometry,
        MeshInfo=m["types"].MeshInfo,
        MetallicRoughnessMaterial=m["types"].MetallicRoughnessMaterial,
        TextureInfo=m["types"].TextureInfo,
        TextureType=m["types"].TextureType)


def _skinned_scene(ns):
    """The two-bone chain of tests/test_skinning.py: verts 0,1 bound to bone
    A (identity), verts 2,3 half to A and half to bone B, whose node is
    animated (a translation of +2 in x over one second)."""
    b = ns.SceneBuilder("skin")
    root = b.add_scene_node(0, np.eye(4))
    node_a = b.add_scene_node(root, np.eye(4))
    node_b = b.add_scene_node(root, np.eye(4))
    bone_a = b.add_bone("A", node_a, np.eye(4))
    bone_b = b.add_bone("B", node_b, np.eye(4))
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    tan = np.tile(np.array([[1, 0, 0]], np.float32), (4, 1))
    bit = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    bone_idx = np.array([[bone_a, 0, 0, 0]] * 2 + [[bone_b, bone_a, 0, 0]] * 2,
                        np.int32)
    bone_w = np.array([[1, 0, 0, 0]] * 2 + [[0.75, 0.25, 0, 0]] * 2,
                      np.float32)
    vbase = b.add_animated_vertices(pos, np.zeros((4, 2), np.float32), nrm,
                                    tan, bit, bone_idx, bone_w)
    ibase = b.add_animated_indices([0, 1, 2, 2, 3, 0])
    geo = b.add_geometry(ns.Geometry(vbase, 4, ibase, 6, True,
                                     is_animated=True))
    mid = b.add_material("m", ns.MetallicRoughnessMaterial())
    b.add_model_instance(b.add_model([ns.MeshInfo(geo, mid)]), root)
    b.add_animation(ns.Animation(
        nodes=[ns.AnimationNode(
            scene_node_index=node_b,
            positions=ns.KeySequence(np.array([0.0, 1.0]),
                                     np.array([[0, 0, 0], [2, 0, 0.]])),
            rotations=ns.KeySequence(np.array([0.0, 1.0]),
                                     np.array([[1, 0, 0, 0.],
                                               [0.9, 0.0, 0.0, 0.43589]]),
                                     is_rotation=True),
            scales=ns.KeySequence(np.array([0.0]), np.array([[1, 1, 1.]])))],
        ticks_per_second=1.0, duration=1.0))
    return b.create_scene()


# ------------------------------------------------------------- skinning

def test_skinning_and_seg_transforms_match_pt():
    ts, js = _skinned_scene(_ns("pt_torch")), _skinned_scene(_ns("pt"))
    assert ts.has_skinned_geometry
    tds, jds = t_flatten(ts, device="cpu"), j_flatten(js)
    assert tds.has_skinning and jds.has_skinning
    for f in ("bone_idx", "bone_weight", "bone_palette", "seg_transform"):
        np.testing.assert_array_equal(getattr(tds, f).numpy(),
                                      np.asarray(getattr(jds, f)), err_msg=f)
    rest = t_world_vertices(tds)[0].numpy()
    np.testing.assert_allclose(rest[2], [0, 1, 0], atol=1e-6)
    for step in range(2):
        ts.update(0.3)
        js.update(0.3)
        tds, jds = t_update(tds, ts), j_update(jds, js)
        for f in ("bone_palette", "seg_transform", "point_light_pos",
                  "dir_light_dir"):
            np.testing.assert_array_equal(getattr(tds, f).numpy(),
                                          np.asarray(getattr(jds, f)),
                                          err_msg=f)
        for got, want in zip(t_world_vertices(tds), j_world_vertices(jds)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
    moved = t_world_vertices(tds)[0].numpy()
    np.testing.assert_allclose(moved[0], [0, 0, 0], atol=1e-6)  # bone A still
    assert np.abs(moved[2] - rest[2]).max() > 0.5               # bone B moved


def test_update_seg_transforms_moves_instances_and_lights():
    """An animated instance node and a light on an animated node: the
    refreshed transforms and light positions equal `pt`'s."""
    def scene(ns, PointLight):
        b = ns.SceneBuilder("moving")
        ns.create_heightfield_scene(b, 8)
        node = b.add_scene_node(0, np.eye(4))
        b.add_point_light(PointLight(color=(1, 1, 1), position=(0, 2, 0)),
                          node_index=node)
        key = lambda v: ns.KeySequence(np.array([0.0]), np.array([v]))  # noqa: E731
        move = ns.KeySequence(np.array([0.0, 10.0]),
                              np.array([[0, 0, 0], [3, 1, 0.]]))
        b.add_animation(ns.Animation(
            nodes=[ns.AnimationNode(n, move, dataclasses.replace(
                key([1, 0, 0, 0.]), is_rotation=True), key([1, 1, 1.]))
                for n in (0, node)], ticks_per_second=10.0, duration=10.0))
        return b.create_scene()
    from pt.scene.types import PointLight as JPointLight
    from pt_torch.scene.types import PointLight as TPointLight
    ts, js = scene(_ns("pt_torch"), TPointLight), scene(_ns("pt"), JPointLight)
    assert ts.has_animated_instances and not ts.has_skinned_geometry
    tds, jds = t_flatten(ts, device="cpu"), j_flatten(js)
    before = tds.seg_transform.clone()
    assert ts.update(0.5) and js.update(0.5)
    tds, jds = t_update(tds, ts), j_update(jds, js)
    assert not torch.equal(tds.seg_transform, before)
    for f in ("seg_transform", "point_light_pos", "point_light_count",
              "bone_palette"):
        np.testing.assert_array_equal(getattr(tds, f).numpy(),
                                      np.asarray(getattr(jds, f)), err_msg=f)
    ts.instances.append(ts.instances[0])
    ts.instance_transforms = np.concatenate([ts.instance_transforms] * 2)
    with pytest.raises(ValueError, match="structure changed"):
        t_update(tds, ts)


# ------------------------------------------------------------- textures

def _texture_infos(ns):
    rng = np.random.default_rng(3)
    TT = ns.TextureType
    return [
        ns.TextureInfo("rgba8", TT.COLOR, is_srgb=True,
                       pixels=rng.integers(0, 256, (16, 8, 4), dtype=np.uint8)),
        ns.TextureInfo("gray16", TT.ROUGHNESS,
                       pixels=rng.integers(0, 65536, (4, 4),
                                           dtype=np.uint16)),
        ns.TextureInfo("rgbf", TT.NORMAL,
                       pixels=rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)),
        ns.TextureInfo("ga8", TT.EMISSIVE, is_srgb=True,
                       pixels=rng.integers(0, 256, (2, 6, 2), dtype=np.uint8)),
        ns.TextureInfo("big", TT.COLOR,
                       pixels=rng.uniform(0, 1, (256, 128, 4))
                       .astype(np.float32)),
    ]


@pytest.mark.parametrize("layout", [{}, {"paired": True},
                                    {"paired": True, "quad": False},
                                    {"budget": 600_000}],
                         ids=["quad", "paired-ignored", "paired", "budget"])
def test_scene_texture_pool_bit_equal_to_pt(layout):
    from pt.core.config import Config as JConfig
    layout = dict(layout)
    budget = layout.pop("budget", 2 << 30)
    tscene = types.SimpleNamespace(textures=_texture_infos(_ns("pt_torch")))
    jscene = types.SimpleNamespace(textures=_texture_infos(_ns("pt")))
    tp = tstex.build_scene_textures(
        tscene, Config(texture_memory_budget=budget), device="cpu", **layout)
    jp = jstex.build_scene_textures(
        jscene, JConfig(texture_memory_budget=budget, loader_thread_count=1),
        **layout)
    assert tp.count == jp.count == 9 + 5
    np.testing.assert_array_equal(_torch_bits(tp.data), _bits(jp.data))
    for name in ("offsets", "sizes", "mip_counts"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    assert (tp.all_constant, tp.paired, tp.quad) == (jp.all_constant,
                                                     jp.paired, jp.quad)
    # pt ignores paired=True unless quad=False goes with it
    assert tp.quad == (layout.get("quad") is not False)
    big = tp.sizes[9 + 4, 0].tolist()           # (w, h) of the 256x128 one
    assert (big == [128, 256]) == (budget > 1 << 20) and big[1] == 2 * big[0]
    for info in tscene.textures:
        assert (info.height, info.width) == info.pixels.shape[:2]


def test_encoded_texture_raises_naming_the_decoder_slice(tmp_path):
    """The DDS decoder has come (queue 1, item 6): a DDS texture, as bytes
    or as a file, decodes as in `pt`, and one whose header holds no format
    becomes `pt`'s placeholder (None from the loader, a magenta texel in
    the pool) instead of raising. A PNG cut short becomes the placeholder
    too."""
    from tests.test_dds import RED565, bc1_block, make_dds
    ns = _ns("pt_torch")
    bad = b"DDS " + bytes(124)
    info = ns.TextureInfo("file.dds", ns.TextureType.COLOR, data=bad)
    assert tstex.load_texture_pixels(info) is None
    pool = tstex.build_texture_pool([info], quad=False, device="cpu")
    np.testing.assert_array_equal(pool.data[-1].float().numpy(),
                                  [1.0, 0.0, 1.0, 1.0])
    path = tmp_path / "x.dds"
    path.write_bytes(make_dds(4, 4, b"DXT1",
                              bc1_block(RED565, RED565, [0] * 16)))
    px = tstex.load_texture_pixels(ns.TextureInfo("x", ns.TextureType.COLOR,
                                                  path=str(path)))
    want = jstex.load_texture_pixels(_ns("pt").TextureInfo(
        "x", _ns("pt").TextureType.COLOR, path=str(path)))
    np.testing.assert_array_equal(px, want)
    np.testing.assert_array_equal(px[0, 0], [1.0, 0.0, 0.0, 1.0])
    cut = ns.TextureInfo("file.png", ns.TextureType.COLOR,
                         data=b"\x89PNG\r\n\x1a\n")
    assert tstex.load_texture_pixels(cut) is None


# ------------------------------------------------------- the alpha loops

def _alpha_state(n=12, cards=60, animate=True):
    """The small alpha scene flattened by both packages, with textures."""
    ts = chip_smoke.build_animated_scene(_ns("pt_torch"), n, cards, animate)
    js = chip_smoke.build_animated_scene(_ns("pt"), n, cards, animate)
    tds, jds = t_flatten(ts, device="cpu"), j_flatten(js)
    ttex = tstex.build_scene_textures(ts, device="cpu")
    jtex = jstex.build_scene_textures(js)
    assert tds.has_alpha and jds.has_alpha and not ttex.all_constant
    return ts, tds, ttex, js, jds, jtex


def _camera_rays(scene, w=32):
    cam = scene.cameras[0]
    cam.on_resize(w, w)
    ys, xs = np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
    px, py = T(xs.reshape(-1)), T(ys.reshape(-1))
    iv = T(np.asarray(cam.inv_view, np.float32))
    ip = T(np.asarray(cam.inv_proj, np.float32))
    state = tint.init_rng_state(px, py, w, 0)
    _, o, d, _ = tint.raygen(px, py, w, w, iv, ip, state,
                             tint.PathTracingSettings())
    return o.numpy(), d.numpy()


def test_single_tree_alpha_loops_match_pt_on_its_tree(pallas_interpret):
    """`pt`'s Morton tree, walked by `pt` through its Pallas kernel
    (interpret mode) and by the port through K3's plain version. `pt`'s
    loops run under one `jax.jit` each, as its renderer runs them: called
    eagerly, the main thread's dispatches and the interpreter's callback
    threads can wait for each other for ever."""
    import jax
    ts, tds, ttex, js, jds, jtex = _alpha_state()
    o, d = _camera_rays(ts)
    n = o.shape[0]
    jset = jint.PathTracingSettings(backend="pallas")
    wpos = j_world_vertices(jds)[0]
    jacc = jint.prepare_accel(jds, dataclasses.replace(jset, backend="brute"))
    jacc = jacc._replace(bvh=jbvh.build_packet_bvh(
        wpos, jds.tri_idx, tri_opaque=jds.tri_opaque))
    tacc = tint.prepare_attribs(tds)._replace(
        bvh=convert.packet_bvh(_fields(jacc.bvh), device="cpu"))
    alive = np.ones(n, bool)
    alive[::7] = False
    jh, jdc, jda, jhas = jax.block_until_ready(
        jax.jit(jint.trace_closest_alpha)(
            jds, jtex, jacc, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(alive)))
    th, tdc, tda, thas = tint.trace_closest_alpha(
        tds, ttex, tacc, T(o), T(d), T(alive))
    live = alive
    differ = (th.tri.numpy() != np.asarray(jh.tri)) & live
    assert differ.mean() <= 0.01, differ.mean()
    same = live & ~differ
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same],
                               rtol=1e-2, atol=1e-3)
    assert ((thas.numpy() != np.asarray(jhas)) & live).mean() <= 0.01
    both = same & thas.numpy() & np.asarray(jhas)
    assert both.sum() > 0                          # decals do occur
    np.testing.assert_allclose(tdc.numpy()[both], np.asarray(jdc)[both],
                               atol=2e-2)
    np.testing.assert_allclose(tda.numpy()[both], np.asarray(jda)[both],
                               atol=2e-2)
    on_alpha = th.is_hit.numpy() & ~tds.tri_opaque.numpy()[
        np.maximum(th.tri.numpy(), 0)]
    assert (on_alpha & live).sum() > 0             # and accepted alpha hits
    # shadow rays from the hit points toward the sun
    hit = same & th.is_hit.numpy()
    so = (o + d * (th.t.numpy()[:, None] - 1e-3)).astype(np.float32)
    sd = np.tile(-np.asarray(tds.dir_light_dir.numpy(), np.float32)
                 / np.linalg.norm(tds.dir_light_dir.numpy()), (n, 1))
    dist = np.full(n, 50.0, np.float32)
    jocc = jax.block_until_ready(jax.jit(jint.trace_occluded_alpha)(
        jds, jtex, jacc, jnp.asarray(so), jnp.asarray(sd), jnp.asarray(dist),
        jnp.asarray(hit)))
    tocc = tint.trace_occluded_alpha(tds, ttex, tacc, T(so), T(sd), T(dist),
                                     T(hit))
    assert ((tocc.numpy() != np.asarray(jocc)) & hit).mean() <= 0.01
    assert 0 < (tocc.numpy() & hit).sum() < hit.sum()


def test_split_alpha_loops_match_pt_brute_split():
    """The static split: the port's SBVH→BF8 subset trees against `pt`'s
    split over its brute backend, the same loop semantics."""
    ts, tds, ttex, js, jds, jtex = _alpha_state(animate=False)
    o, d = _camera_rays(ts)
    n = o.shape[0]
    r = Renderer(device="cpu")
    r.set_scene(ts, stream_textures=False)
    r._ensure_accel()
    tacc = r.accel
    sp = tacc.alpha_split
    assert sp is not None and isinstance(sp.bvh_alpha, tbvh.BF8BVH)
    assert len(sp.sel_opaque) + len(sp.sel_alpha) == tds.num_triangles
    jset = jint.PathTracingSettings(backend="brute")
    jacc = jint.prepare_accel(jds, jset)._replace(
        alpha_split=jint.make_alpha_split_brute(jds))
    alive = np.ones(n, bool)
    jh, jdc, jda, jhas = jint.trace_closest_alpha(
        jds, jtex, jacc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive))
    th, tdc, tda, thas = tint.trace_closest_alpha(
        tds, ttex, tacc, T(o), T(d), T(alive))
    np.testing.assert_array_equal(th.tri.numpy(), np.asarray(jh.tri))
    np.testing.assert_array_equal(thas.numpy(), np.asarray(jhas))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tdc.numpy(), np.asarray(jdc), atol=1e-4)
    np.testing.assert_allclose(tda.numpy(), np.asarray(jda), atol=1e-4)
    assert thas.sum() > 0
    hit = th.is_hit.numpy()
    so = (o + d * (th.t.numpy()[:, None] - 1e-3)).astype(np.float32)
    sd = np.tile(-np.asarray(tds.dir_light_dir.numpy(), np.float32)
                 / np.linalg.norm(tds.dir_light_dir.numpy()), (n, 1))
    dist = np.full(n, 50.0, np.float32)
    for reverse in (None, np.arange(n) % 2 == 0):
        jrev = None if reverse is None else jnp.asarray(reverse)
        trev = None if reverse is None else T(reverse)
        jocc = jint.trace_occluded_alpha(jds, jtex, jacc, jnp.asarray(so),
                                         jnp.asarray(sd), jnp.asarray(dist),
                                         jnp.asarray(hit), reverse=jrev)
        tocc = tint.trace_occluded_alpha(tds, ttex, tacc, T(so), T(sd),
                                         T(dist), T(hit), reverse=trev)
        assert ((tocc.numpy() != np.asarray(jocc)) & hit).mean() <= 0.002
    # an AlphaSplit made from pt's selections keeps them
    conv = convert.alpha_split(sp.bvh_opaque, np.asarray(
        jacc.alpha_split.sel_opaque), sp.bvh_alpha, np.asarray(
        jacc.alpha_split.sel_alpha), device="cpu")
    assert torch.equal(conv.sel_alpha, sp.sel_alpha)
    assert torch.equal(conv.sel_opaque, sp.sel_opaque)


# ----------------------------------------------------- the slice as a whole

@pytest.mark.parametrize("animate", [True, False],
                         ids=["animated", "static-split"])
def test_alpha_film_matches_pt_renderer(animate):
    """32², 1 spp, 3 bounces, two frames of scene.update → update_scene_data
    → render: each frame's film against `pt`'s Renderer (its brute backend
    on the CPU, with its brute split on the static scene)."""
    ts = chip_smoke.build_animated_scene(_ns("pt_torch"), 12, 40, animate)
    js = chip_smoke.build_animated_scene(_ns("pt"), 12, 40, animate)
    r = Renderer(tint.PathTracingSettings(sample_count=1, bounce_count=3),
                 device="cpu")
    r.set_scene(ts, stream_textures=False)
    r.on_resize(32, 32)
    jr = JRenderer(jint.PathTracingSettings(sample_count=1, bounce_count=3,
                                            backend="brute"))
    jr.set_scene(js, stream_textures=False)
    jr.on_resize(32, 32)
    films = []
    for frame in range(2):
        changed = ts.update(1 / 24)
        assert changed == js.update(1 / 24) == animate
        r.update_scene_data(scene_changed=changed)
        jr.update_scene_data(scene_changed=changed)
        assert r.total_samples == (0 if animate else frame)
        assert r.render() == jr.render()
        film, jfilm = r.film_mean(), jr.film_mean()
        assert np.isfinite(film).all() and film.max() > 0
        mse = float(np.mean((film - jfilm) ** 2))
        assert mse < 1e-3, (frame, mse)
        assert abs(r.rays_traced - jr.rays_traced) <= 0.01 * jr.rays_traced
        films.append(film)
    if animate:
        assert isinstance(r.accel.bvh, tbvh.PacketBVH)
        assert r.accel.alpha_split is None
        assert np.abs(films[0] - films[1]).max() > 1e-3   # the scene moved
    else:
        assert isinstance(r.accel.bvh, tbvh.BF8BVH)
        assert r.accel.alpha_split is not None
        assert jr.accel.alpha_split is not None
    snap = r.snapshot()
    assert snap.shape == (32, 32, 3) and (0 <= snap).all() and (snap <= 1).all()


def test_animated_rebuild_changes_the_tree_and_resets_the_film():
    ts = chip_smoke.build_animated_scene(_ns("pt_torch"), 16, 0, True)
    r = Renderer(tint.PathTracingSettings(bounce_count=2), device="cpu")
    r.set_scene(ts, stream_textures=False)
    r.on_resize(16, 16)
    r.render(2)
    first = r.accel.bvh
    assert isinstance(first, tbvh.PacketBVH) and r.total_samples == 2
    r.update_scene_data(scene_changed=False)       # nothing moved: no reset
    assert r.total_samples == 2 and r.accel.bvh is first
    r.update_scene_data(scene_changed=ts.update(1 / 24))
    assert r.total_samples == 0 and float(r.accum.abs().sum()) == 0.0
    r.render(1)
    second = r.accel.bvh
    assert second is not first
    assert not torch.equal(first.top_hi[0], second.top_hi[0])
    assert not torch.equal(first.pages, second.pages)
    # the skip links are the per-leaf-count tensors, shared between frames
    assert second.top_miss is first.top_miss
    with pytest.raises(RuntimeError, match="no scene"):
        Renderer(device="cpu").update_scene_data(True)


def test_static_scene_without_bf8_falls_back_to_v4():
    """A scene that fits one leaf has no BF8 collapse: the static path takes
    the binary tree and K3/K4 (plain versions here), and still matches
    `pt`."""
    def tiny(ns):
        b = ns.SceneBuilder("tiny")
        ns.create_heightfield_scene(b, 4)           # 18 triangles
        return b.create_scene()
    r = Renderer(tint.PathTracingSettings(bounce_count=3), device="cpu")
    r.set_scene(tiny(_ns("pt_torch")), stream_textures=False)
    r.on_resize(16, 16)
    r.render(1)
    assert isinstance(r.accel.bvh, tbvh.PacketBVH) and r.accel.bvh.n_top == 1
    jr = JRenderer(jint.PathTracingSettings(bounce_count=3, backend="brute"))
    jr.set_scene(tiny(_ns("pt")))
    jr.on_resize(16, 16)
    jr.render(1)
    assert float(np.mean((r.film_mean() - jr.film_mean()) ** 2)) < 1e-3
    assert r.film_mean().max() > 0
