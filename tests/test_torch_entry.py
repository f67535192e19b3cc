"""The single-call render and the three newer Test Scenes of the PyTorch
port against `pt` on the CPU.

* `render_image_stats` (`pt_torch/render/integrator.py`) against `pt`'s on
  its brute backend: the Default scene at `__graft_entry__.entry()`'s
  settings (32², 1 spp, 3 bounces) and a 16² Heightfield (n=16) at 2 spp,
  where the RNG state carried from one sample to the next matters. The
  port traces the Morton tree (K3/K4's plain versions here). Bar: film MSE
  < 1e-3, the project's film contract; ray counts within the near-edge
  budget of 1%.
* Without a device argument `render_image_stats` takes the card: on a host
  with none it raises, and it never renders a scene that lies elsewhere.
* The Roughness Test Cubes, MetallicRoughness Cubes and Reuse Mesh scenes:
  a same-RNG 32² film through `Renderer` (1 spp, 3 bounces) within MSE
  1e-3 of `pt`'s; the MetallicRoughness light follows its keyframed node
  as `pt`'s does (`tests/test_animated_light.py`), and moving it changes
  the film.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pt.render import integrator as jint
from pt.render.textures import default_texture_pool as j_default_pool
from pt.run.renderer import Renderer as JRenderer
from pt.scene import examples as jex
from pt.scene.flatten import flatten_scene as j_flatten
from pt.scene.textures import build_scene_textures as j_textures
from pt_torch.render import integrator as tint
from pt_torch.render.textures import default_texture_pool
from pt_torch.run.renderer import Renderer
from pt_torch.scene import examples as tex_
from pt_torch.scene.flatten import flatten_scene
from pt_torch.scene.textures import build_scene_textures

FILM_MSE = 1e-3


def _port_stats(scene, width, spp, bounces, device="cpu"):
    cam = scene.cameras[0]
    cam.on_resize(width, width)
    tex = (build_scene_textures(scene, device="cpu") if scene.textures
           else default_texture_pool(device="cpu"))
    img, rays = tint.render_image_stats(
        flatten_scene(scene, device="cpu"), tex, cam.inv_view, cam.inv_proj,
        width, width, 0,
        tint.PathTracingSettings(sample_count=spp, bounce_count=bounces),
        device=device)
    return img.numpy(), int(rays)


def _pt_stats(scene, width, spp, bounces):
    cam = scene.cameras[0]
    cam.on_resize(width, width)
    tex = j_textures(scene) if scene.textures else j_default_pool()
    img, rays = jint.render_image_stats(
        j_flatten(scene), tex, jnp.asarray(cam.inv_view, jnp.float32),
        jnp.asarray(cam.inv_proj, jnp.float32), width, width, jnp.uint32(0),
        jint.PathTracingSettings(sample_count=spp, bounce_count=bounces,
                                 backend="brute"))
    return np.asarray(img), int(rays)


STATS_CASES = {
    "default_entry": (tex_.make_default_scene, jex.make_default_scene, 32, 1),
    "heightfield_2spp": (lambda: tex_.make_heightfield_scene(16),
                         lambda: jex.make_heightfield_scene(16), 16, 2),
}


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_render_image_stats_matches_pt(case):
    t_fn, j_fn, width, spp = STATS_CASES[case]
    img, rays = _port_stats(t_fn(), width, spp, 3)
    jimg, jrays = _pt_stats(j_fn(), width, spp, 3)
    assert img.shape == jimg.shape == (width, width, 3)
    assert np.isfinite(img).all() and img.max() > 0
    mse = float(np.mean((img / spp - jimg / spp) ** 2))
    assert mse < FILM_MSE, mse
    assert abs(rays - jrays) <= 0.01 * jrays, (rays, jrays)
    if spp == 2:
        # the second sample continues the first one's RNG stream: a render
        # that seeds sample 2 afresh from frame 1 gives another film
        reseeded = sum(_port_frame(t_fn(), width, f) for f in (0, 1))
        assert not np.allclose(img, reseeded)


def _port_frame(scene, width, frame):
    cam = scene.cameras[0]
    cam.on_resize(width, width)
    img, _ = tint.render_image_stats(
        flatten_scene(scene, device="cpu"), default_texture_pool(device="cpu"),
        cam.inv_view, cam.inv_proj, width, width, frame,
        tint.PathTracingSettings(sample_count=1, bounce_count=3),
        device="cpu")
    return img.numpy()


def test_render_image_stats_is_trilinear_and_row_major():
    """`render_flat` samples every bounce trilinearly, whatever the
    settings' tail flag, and returns rows of pixels in film order."""
    scene = tex_.make_default_scene()
    cam = scene.cameras[0]
    cam.on_resize(8, 8)
    args = (flatten_scene(scene, device="cpu"),
            build_scene_textures(scene, device="cpu"), cam.inv_view,
            cam.inv_proj, 8, 8, 0)
    a, _ = tint.render_image_stats(
        *args, tint.PathTracingSettings(bounce_count=3), device="cpu")
    b, _ = tint.render_image_stats(
        *args, tint.PathTracingSettings(bounce_count=3,
                                        tex_nearest_tail=False),
        device="cpu")
    assert torch.equal(a, b)
    ys, xs = torch.meshgrid(torch.arange(8), torch.arange(8), indexing="ij")
    flat, _ = tint.render_flat(
        args[0], args[1], torch.as_tensor(cam.inv_view, dtype=torch.float32),
        torch.as_tensor(cam.inv_proj, dtype=torch.float32), xs.reshape(-1),
        ys.reshape(-1), 8, 8, 0, tint.PathTracingSettings(bounce_count=3))
    assert torch.equal(flat.reshape(8, 8, 3), a)


def test_render_image_stats_takes_the_card():
    scene = tex_.make_default_scene()
    cam = scene.cameras[0]
    cam.on_resize(4, 4)
    ds = flatten_scene(scene, device="cpu")
    tex = build_scene_textures(scene, device="cpu")
    settings = tint.PathTracingSettings(bounce_count=1)
    if torch.cuda.is_available():
        # a scene on the CPU is not rendered on the card, nor moved there
        with pytest.raises(ValueError, match="scene is on cpu"):
            tint.render_image_stats(ds, tex, cam.inv_view, cam.inv_proj, 4,
                                    4, 0, settings)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tint.render_image_stats(ds, tex, cam.inv_view, cam.inv_proj, 4,
                                    4, 0, settings)
    elsewhere = dataclasses.replace(tex, data=tex.data.to("meta"))
    with pytest.raises(ValueError, match="texture pool is on meta"):
        tint.render_image_stats(ds, elsewhere, cam.inv_view, cam.inv_proj, 4,
                                4, 0, settings, device="cpu")


# ------------------------------------------------------- the new scenes

NEW_SCENES = {
    "roughness": (tex_.make_roughness_test_scene,
                  jex.make_roughness_test_scene),
    "metallic_roughness": (tex_.make_metallic_roughness_cubes_scene,
                           jex.make_metallic_roughness_cubes_scene),
    "reuse_mesh": (tex_.make_reuse_mesh_scene, jex.make_reuse_mesh_scene),
}


@pytest.mark.parametrize("which", list(NEW_SCENES))
def test_new_scene_film_matches_pt_renderer(which):
    t_fn, j_fn = NEW_SCENES[which]
    r = Renderer(tint.PathTracingSettings(sample_count=1, bounce_count=3),
                 device="cpu")
    r.set_scene(t_fn(), stream_textures=False)
    r.on_resize(32, 32)
    r.render()
    # Reuse Mesh: 16 instances of 12 triangles, far below "auto"'s
    # shared-BLAS threshold, so it is flattened (K1/K2 on the card)
    assert type(r.accel.bvh).__name__ == "BF8BVH"
    film = r.film_mean()
    jr = JRenderer(jint.PathTracingSettings(sample_count=1, bounce_count=3,
                                            backend="brute"))
    jr.set_scene(j_fn(), stream_textures=False)
    jr.on_resize(32, 32)
    jr.render()
    jfilm = jr.film_mean()
    assert np.isfinite(film).all() and film.max() > 0
    mse = float(np.mean((film - jfilm) ** 2))
    assert mse < FILM_MSE, mse
    assert abs(r.rays_traced - jr.rays_traced) <= 0.01 * jr.rays_traced


def test_metallic_roughness_light_follows_its_node():
    ts = tex_.make_metallic_roughness_cubes_scene()
    js = jex.make_metallic_roughness_cubes_scene()
    assert ts.graph.has_animations and len(ts.textures) == 12
    assert ts.point_lights[0].position[0] == -1.0
    for want in (1.0, -1.0):                   # tick 90, then 180 → 0
        assert ts.update(3.0) and js.update(3.0)
        assert ts.point_lights[0].position[0] == want
        np.testing.assert_array_equal(ts.point_lights[0].position,
                                      js.point_lights[0].position)
    # the moving light reaches the device scene and changes the film
    scene = tex_.make_metallic_roughness_cubes_scene()
    r = Renderer(tint.PathTracingSettings(sample_count=1, bounce_count=2),
                 device="cpu")
    r.set_scene(scene, stream_textures=False)
    r.on_resize(24, 24)
    r.render(1)
    img0 = r.snapshot()
    assert scene.update(3.0)                   # light to x = +1
    r.update_scene_data(scene_changed=True)
    assert float(r.ds.point_light_pos[0, 0]) == 1.0
    assert r.total_samples == 0
    r.render(1)
    img1 = r.snapshot()
    assert np.isfinite(img1).all()
    assert np.abs(img1 - img0).max() > 1e-3
