"""Procedural example scenes.

Port of `pt.scene.examples`: the built-in "Default" Cornell-box-like scene
with glass and mirror cubes, an area light and the four embedded textures
(≙ ExampleScenes.cpp:320-545), the shared cube mesh helper (≙ AddCube,
ExampleScenes.cpp:265-318), the roughness/metalness grid, the textured
MetallicRoughness cubes with their animated node-attached point light and
equirect sky, the Reuse Mesh grid of one cube model under a cube skybox,
the Heightfield (the procedural stress scene of the static main path) and,
through `pt_torch.scene.standin`, the Courtyard and its flythrough.
`TEST_SCENES` is `pt`'s catalog of seven, in `pt`'s order. Vertex data,
transforms, materials and the default input camera (fov 45, near/far
100/0.1: the reference's reversed-argument quirk is kept; pos (3,1,0), dir
(-1,0,0)) match `pt`'s exactly.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np

from pt_torch.core.camera import InputCamera
from pt_torch.scene.builder import Scene, SceneBuilder
from pt_torch.scene.graph import Animation, AnimationNode, KeySequence
from pt_torch.scene.types import (DirectionalLight, Geometry, MeshInfo,
                                  MetallicRoughnessMaterial, PointLight,
                                  Skybox, SkyboxKind, TextureInfo,
                                  TextureType)


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _scale(s):
    m = np.eye(4)
    m[0, 0] = m[1, 1] = m[2, 2] = s
    return m


def _rotate_y(deg):
    r = math.radians(deg)
    m = np.eye(4)
    m[0, 0] = math.cos(r)
    m[0, 2] = math.sin(r)
    m[2, 0] = -math.sin(r)
    m[2, 2] = math.cos(r)
    return m


# quad helper: 4 verts (pos, uv, normal, tangent, bitangent) + 2 tris
def _add_quad_list(builder: SceneBuilder, verts) -> int:
    """verts: list of (pos, uv, normal, tangent, bitangent). Adds one
    4-vertex geometry with indices 0,1,2, 2,3,0."""
    pos = [v[0] for v in verts]
    uv = [v[1] for v in verts]
    nrm = [v[2] for v in verts]
    tan = [v[3] for v in verts]
    bit = [v[4] for v in verts]
    vbase = builder.add_vertices(pos, uv, nrm, tan, bit)
    ibase = builder.add_indices([0, 1, 2, 2, 3, 0])
    return builder.add_geometry(Geometry(vbase, 4, ibase, 6, True))


def add_cube(builder: SceneBuilder) -> List[int]:
    """Unit cube as 6 quad geometries (≙ AddCube, ExampleScenes.cpp:265-318).
    Returns the 6 geometry indices (+z, -z, -x, +x, +y, -y faces)."""
    faces = [
        # +z
        [((-1, -1, 1), (0, 1), (0, 0, 1), (1, 0, 0), (0, 1, 0)),
         ((1, -1, 1), (1, 1), (0, 0, 1), (1, 0, 0), (0, 1, 0)),
         ((1, 1, 1), (1, 0), (0, 0, 1), (1, 0, 0), (0, 1, 0)),
         ((-1, 1, 1), (0, 0), (0, 0, 1), (1, 0, 0), (0, 1, 0))],
        # -z
        [((1, -1, -1), (0, 1), (0, 0, -1), (-1, 0, 0), (0, 1, 0)),
         ((-1, -1, -1), (1, 1), (0, 0, -1), (-1, 0, 0), (0, 1, 0)),
         ((-1, 1, -1), (1, 0), (0, 0, -1), (-1, 0, 0), (0, 1, 0)),
         ((1, 1, -1), (0, 0), (0, 0, -1), (-1, 0, 0), (0, 1, 0))],
        # -x
        [((-1, -1, -1), (0, 1), (-1, 0, 0), (0, 0, 1), (0, 1, 0)),
         ((-1, -1, 1), (1, 1), (-1, 0, 0), (0, 0, 1), (0, 1, 0)),
         ((-1, 1, 1), (1, 0), (-1, 0, 0), (0, 0, 1), (0, 1, 0)),
         ((-1, 1, -1), (0, 0), (-1, 0, 0), (0, 0, 1), (0, 1, 0))],
        # +x
        [((1, -1, 1), (0, 1), (1, 0, 0), (0, 0, -1), (0, 1, 0)),
         ((1, -1, -1), (1, 1), (1, 0, 0), (0, 0, -1), (0, 1, 0)),
         ((1, 1, -1), (1, 0), (1, 0, 0), (0, 0, -1), (0, 1, 0)),
         ((1, 1, 1), (0, 0), (1, 0, 0), (0, 0, -1), (0, 1, 0))],
        # +y
        [((-1, 1, 1), (0, 1), (0, 1, 0), (1, 0, 0), (0, 0, -1)),
         ((1, 1, 1), (1, 1), (0, 1, 0), (1, 0, 0), (0, 0, -1)),
         ((1, 1, -1), (1, 0), (0, 1, 0), (1, 0, 0), (0, 0, -1)),
         ((-1, 1, -1), (0, 0), (0, 1, 0), (1, 0, 0), (0, 0, -1))],
        # -y
        [((-1, -1, -1), (0, 1), (0, -1, 0), (1, 0, 0), (0, 0, 1)),
         ((1, -1, -1), (1, 1), (0, -1, 0), (1, 0, 0), (0, 0, 1)),
         ((1, -1, 1), (1, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1)),
         ((-1, -1, 1), (0, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1))],
    ]
    return [_add_quad_list(builder, f) for f in faces]


def create_default_scene(builder: SceneBuilder) -> None:
    """≙ CreateDefaultScene (ExampleScenes.cpp:320-545): open Cornell box
    (red/green/white walls), a mirror cube, a glass cube, and an emissive
    area light quad near the ceiling; black directional light."""
    default = dict(roughness=1.0, metalness=0.0, ior=1.5,
                   attenuation_color=(1.0, 1.0, 1.0), attenuation_distance=1e32)
    white = builder.add_material("White Material", MetallicRoughnessMaterial(**default))
    green = builder.add_material("Green Material", MetallicRoughnessMaterial(
        color=(0, 1, 0, 1), **default))
    red = builder.add_material("Red Material", MetallicRoughnessMaterial(
        color=(1, 0, 0, 1), **default))
    # the four embedded textures, wired as the reference does
    # (ExampleScenes.cpp:338-383: logo wall reuses the placeholder art,
    # glass cube shows authors, mirror cube the engine banner, floor the
    # press-space texture); they are PNG bytes, decoded when the texture
    # pool is built
    from pt_torch import resources

    def _embedded(asset: str, name: str) -> int:
        return builder.add_texture(TextureInfo(
            name=name, type=TextureType.COLOR,
            data=resources.texture_bytes(asset), is_srgb=True))

    logo_tex = _embedded("placeholder", "Logo Color Texture")
    banner_tex = _embedded("logo", "TPU Path-Tracing Texture")
    authors_tex = _embedded("authors", "Authors Texture")
    space_tex = _embedded("press_space", "Press Space Texture")
    logo = builder.add_material("Logo Material", MetallicRoughnessMaterial(
        color_idx=logo_tex, **default))
    light_mat = builder.add_material("Light Material", MetallicRoughnessMaterial(
        emissive_color=(1, 1, 1), emissive_intensity=1.0, **default))
    glass = builder.add_material("Glass Material", MetallicRoughnessMaterial(
        color=(0.70, 0.81, 0.85, 1.0), roughness=0.0, metalness=0.0,
        ior=1.5, transmission=1.0,
        attenuation_color=(1, 1, 1), attenuation_distance=1e32))
    glass_tex = builder.add_material("Glass Textured Material", MetallicRoughnessMaterial(
        color=(0.70, 0.81, 0.85, 1.0), roughness=0.0, metalness=0.0,
        ior=1.5, transmission=1.0, color_idx=authors_tex,
        attenuation_color=(1, 1, 1), attenuation_distance=1e32))
    mirror = builder.add_material("Mirror Material", MetallicRoughnessMaterial(
        roughness=0.0, metalness=1.0, ior=1.5,
        attenuation_color=(1, 1, 1), attenuation_distance=1e32))
    mirror_tex = builder.add_material("Mirror Textured Material", MetallicRoughnessMaterial(
        roughness=0.0, metalness=1.0, ior=1.5, color_idx=banner_tex,
        attenuation_color=(1, 1, 1), attenuation_distance=1e32))
    floor = builder.add_material("Floor Material", MetallicRoughnessMaterial(
        color_idx=space_tex, **default))

    # 5 box walls (ExampleScenes.cpp vertex table, ±1.1 x/y, z ±1)
    walls = [
        # back wall (z=-1, normal +z)  — red
        [((-1.1, -1.1, -1), (0, 1), (0, 0, 1), (1, 0, 0), (0, 1, 0)),
         ((1.1, -1.1, -1), (1, 1), (0, 0, 1), (1, 0, 0), (0, 1, 0)),
         ((1.1, 1.1, -1), (1, 0), (0, 0, 1), (1, 0, 0), (0, 1, 0)),
         ((-1.1, 1.1, -1), (0, 0), (0, 0, 1), (1, 0, 0), (0, 1, 0))],
        # front wall (z=1, normal -z) — green
        [((1.1, -1.1, 1), (0, 1), (0, 0, -1), (-1, 0, 0), (0, 1, 0)),
         ((-1.1, -1.1, 1), (1, 1), (0, 0, -1), (-1, 0, 0), (0, 1, 0)),
         ((-1.1, 1.1, 1), (1, 0), (0, 0, -1), (-1, 0, 0), (0, 1, 0)),
         ((1.1, 1.1, 1), (0, 0), (0, 0, -1), (-1, 0, 0), (0, 1, 0))],
        # left wall (x=-1.1, normal +x) — logo
        [((-1.1, -1.1, 1), (0, 1), (1, 0, 0), (0, 0, -1), (0, 1, 0)),
         ((-1.1, -1.1, -1), (1, 1), (1, 0, 0), (0, 0, -1), (0, 1, 0)),
         ((-1.1, 1.1, -1), (1, 0), (1, 0, 0), (0, 0, -1), (0, 1, 0)),
         ((-1.1, 1.1, 1), (0, 0), (1, 0, 0), (0, 0, -1), (0, 1, 0))],
        # floor (y=-1.1, normal +y) — "press space"
        [((-1.1, -1.1, 1), (0, 0), (0, 1, 0), (1, 0, 0), (0, 0, -1)),
         ((1.1, -1.1, 1), (0, 1), (0, 1, 0), (1, 0, 0), (0, 0, -1)),
         ((1.1, -1.1, -1), (1, 1), (0, 1, 0), (1, 0, 0), (0, 0, -1)),
         ((-1.1, -1.1, -1), (1, 0), (0, 1, 0), (1, 0, 0), (0, 0, -1))],
        # ceiling (y=1.1, normal -y) — white
        [((-1.1, 1.1, -1), (0, 1), (0, -1, 0), (1, 0, 0), (0, 0, 1)),
         ((1.1, 1.1, -1), (1, 1), (0, -1, 0), (1, 0, 0), (0, 0, 1)),
         ((1.1, 1.1, 1), (1, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1)),
         ((-1.1, 1.1, 1), (0, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1))],
    ]
    wall_geos = [_add_quad_list(builder, w) for w in walls]
    wall_mats = [red, green, logo, floor, white]
    box_meshes = [MeshInfo(g, m) for g, m in zip(wall_geos, wall_mats)]

    cube_geos = add_cube(builder)
    glass_meshes = [MeshInfo(g, glass_tex if i == 3 else glass)
                    for i, g in enumerate(cube_geos)]
    mirror_meshes = [MeshInfo(g, mirror_tex if i == 3 else mirror)
                     for i, g in enumerate(cube_geos)]

    # emissive light quad (normal -y, pointing at the floor)
    light_geo = _add_quad_list(builder, [
        ((0.2, 0.0, 0.2), (1, 1), (0, -1, 0), (1, 0, 0), (0, 0, 1)),
        ((-0.2, 0.0, 0.2), (0, 1), (0, -1, 0), (1, 0, 0), (0, 0, 1)),
        ((-0.2, 0.0, -0.2), (0, 1), (0, -1, 0), (1, 0, 0), (0, 0, 1)),
        ((0.2, 0.0, -0.2), (1, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ])

    box = builder.add_model(box_meshes)
    metallic_cube = builder.add_model(mirror_meshes)
    glass_cube = builder.add_model(glass_meshes)
    light = builder.add_model([MeshInfo(light_geo, light_mat)])

    root = builder.add_scene_node(0, np.eye(4))
    # reference: transpose(translate(scale(I,2), (-2.25,.5,0))) i.e.
    # M = S(2) @ T(-2.25, 0.5, 0)
    box_node = builder.add_scene_node(root, _scale(2.0) @ _translate(-2.25, 0.5, 0.0))
    builder.add_model_instance(box, box_node)

    left_node = builder.add_scene_node(
        box_node, _translate(-0.4, -0.795, 0.5) @ _rotate_y(25.0) @ _scale(0.3))
    right_node = builder.add_scene_node(
        box_node, _translate(0.2, -0.795, -0.6) @ _rotate_y(-20.0) @ _scale(0.3))
    builder.add_model_instance(metallic_cube, left_node)
    builder.add_model_instance(glass_cube, right_node)

    light_node = builder.add_scene_node(box_node, _translate(0.0, 1.099, 0.0))
    builder.add_model_instance(light, light_node)

    builder.set_directional_light(DirectionalLight(color=(0, 0, 0),
                                                   direction=(0, -1, 0)))


def create_roughness_test_scene(builder: SceneBuilder) -> None:
    """6x6 grid of cubes sweeping roughness (x) and metalness (y)
    (≙ CreateRoughnessTestCubesScene) plus a point light — textureless
    material/BSDF test scene."""
    cube_geos = add_cube(builder)
    root = builder.add_scene_node(0, np.eye(4))
    for iy in range(6):
        for ix in range(6):
            m = builder.add_material(
                f"rm-{ix}-{iy}",
                MetallicRoughnessMaterial(
                    color=(0.8, 0.2, 0.2, 1.0),
                    roughness=ix / 5.0, metalness=iy / 5.0, ior=1.5))
            model = builder.add_model([MeshInfo(g, m) for g in cube_geos])
            node = builder.add_scene_node(
                root, _translate(ix * 2.5 - 6.25, iy * 2.5 - 6.25, 0.0) @ _scale(0.9))
            builder.add_model_instance(model, node)
    builder.add_point_light(PointLight(color=(200.0, 200.0, 200.0),
                                       position=(0.0, 0.0, -12.0)))
    builder.set_directional_light(DirectionalLight())
    builder.add_camera(InputCamera(45.0, 100.0, 0.1, (0.0, 0.0, -20.0),
                                   (0.0, 0.0, 1.0)))


def _procedural_pbr_textures(builder: SceneBuilder, name: str, seed: int):
    """Noise-generated color/normal/roughness/metallic texture quartet —
    stand-in for the ambientcg JPG sets the reference downloads at
    configure time (unavailable here, cmake/DownloadAssets.cmake); keeps
    the full 4-slot texture sampling path exercised."""
    rng = np.random.default_rng(seed)
    n = 64
    base = rng.uniform(0.2, 0.9, 3)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pattern = (0.5 + 0.5 * np.sin(xx * 0.4 + seed) * np.cos(yy * 0.3)
               + 0.15 * rng.standard_normal((n, n))).clip(0, 1)
    color = (base[None, None] * (0.4 + 0.6 * pattern[..., None]))
    color = np.concatenate([color, np.ones((n, n, 1))], -1).astype(np.float32)
    # normal map: slopes of the pattern, encoded [0,1]
    gx = np.gradient(pattern, axis=1)
    gy = np.gradient(pattern, axis=0)
    nrm = np.stack([-gx, -gy, np.ones_like(gx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normal = np.concatenate([(nrm * 0.5 + 0.5),
                             np.ones((n, n, 1))], -1).astype(np.float32)
    rough = np.repeat((0.3 + 0.6 * pattern)[..., None], 4,
                      -1).astype(np.float32)

    def add(px, ttype, srgb):
        return builder.add_texture(TextureInfo(
            name=f"{name}-{ttype.name.lower()}", type=ttype,
            pixels=px, is_srgb=srgb))

    return dict(
        color_idx=add(color, TextureType.COLOR, True),
        normal_idx=add(normal, TextureType.NORMAL, False),
        roughness_idx=add(rough, TextureType.ROUGHNESS, False),
        metallic_idx=add(rough, TextureType.METALLIC, False))


def create_metallic_roughness_cubes_scene(builder: SceneBuilder) -> None:
    """Textured cubes with a node-attached ANIMATED point light
    (≙ CreateMetallicRoughnessCubesScene, ExampleScenes.cpp:547-658):
    two cube models (3 materials / 1 material), three instances, a white
    quadratic-falloff point light on a scene node keyframed x: −1→1→−1
    over 180 ticks at 30 tps, and an equirect skybox. The only scene
    exercising animated node-attached lights end-to-end."""
    mats = []
    for i, name in enumerate(("Metal", "PavingStones", "Logs")):
        tex = _procedural_pbr_textures(builder, name, seed=7 + i)
        mats.append(builder.add_material(name, MetallicRoughnessMaterial(
            color=(1.0, 1.0, 1.0, 1.0), roughness=1.0, metalness=1.0,
            ior=1.5, **tex)))

    geos = add_cube(builder)
    # cube1: faces (0,1)->Metal, (2,3)->PavingStones, (4,5)->Logs
    m1 = [MeshInfo(geos[f], mats[f // 2]) for f in range(6)]
    m2 = [MeshInfo(g, mats[0]) for g in geos]
    cube1 = builder.add_model(m1)
    cube2 = builder.add_model(m2)

    root = builder.add_scene_node(0, np.eye(4))
    n_inst1 = builder.add_scene_node(root, _translate(1.0, 1.0, 1.0))
    n_inst2 = builder.add_scene_node(root, _translate(-1.0, -1.0, -1.0))
    n_cube2 = builder.add_scene_node(
        root, _translate(0.5, -1.0, -3.0) @ np.diag([2.0, 1.0, 0.3, 1.0]))
    builder.add_model_instance(cube1, n_inst1)
    builder.add_model_instance(cube1, n_inst2)
    builder.add_model_instance(cube2, n_cube2)

    light_node = builder.add_scene_node(root, _translate(-1.0, 3.0, 0.0))
    builder.add_point_light(
        PointLight(color=(1.0, 1.0, 1.0), position=(0.0, 0.0, 0.0),
                   attenuation_constant=0.0, attenuation_linear=0.0,
                   attenuation_quadratic=1.0),
        node_index=light_node)

    anim_node = AnimationNode(
        scene_node_index=light_node,
        positions=KeySequence(
            ticks=np.asarray([0.0, 90.0, 180.0]),
            values=np.asarray([[-1.0, 3.0, 0.0], [1.0, 3.0, 0.0],
                               [-1.0, 3.0, 0.0]])),
        rotations=KeySequence(ticks=np.asarray([0.0]),
                              values=np.asarray([[1.0, 0.0, 0.0, 0.0]]),
                              is_rotation=True),
        scales=KeySequence(ticks=np.asarray([0.0]),
                           values=np.asarray([[1.0, 1.0, 1.0]])))
    builder.add_animation(Animation(nodes=[anim_node], ticks_per_second=30.0,
                                    duration=180.0))

    # procedural equirect sky gradient (≙ the sky_42_2k.png 2D skybox)
    h, w = 32, 64
    v = np.linspace(0.0, 1.0, h)[:, None]
    sky = np.stack([0.35 + 0.3 * v, 0.5 + 0.3 * v, 0.8 + 0.2 * v],
                   axis=-1).astype(np.float32)
    sky = np.broadcast_to(sky, (h, w, 3)).copy()
    builder.set_skybox(Skybox(kind=SkyboxKind.EQUIRECT, image=sky))
    builder.set_directional_light(DirectionalLight())
    builder.add_camera(InputCamera(45.0, 100.0, 0.1, (6.0, 1.0, 2.0),
                                   (-0.9, -0.15, -0.35)))


def make_metallic_roughness_cubes_scene() -> Scene:
    b = SceneBuilder("MetallicRoughness Cubes")
    create_metallic_roughness_cubes_scene(b)
    return b.create_scene()


def create_heightfield_scene(builder: SceneBuilder, n: int = 224) -> None:
    """Procedural stress scene (no reference counterpart): an n×n wavy
    heightfield (2·(n−1)² triangles) with a diffuse material, a sun
    directional light, and a fly camera. Used to benchmark BVH traversal at
    realistic triangle counts without needing imported assets."""
    xs = np.linspace(-10, 10, n, dtype=np.float32)
    zs = np.linspace(-10, 10, n, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = (np.sin(gx * 1.3) * np.cos(gz * 1.1) * 0.8
          + 0.25 * np.sin(gx * 4.7) * np.sin(gz * 3.9)).astype(np.float32)
    pos = np.stack([gx, -gy, gz], axis=-1).reshape(-1, 3)
    # analytic-ish normals via central differences
    dy_dx = np.gradient(gy, axis=0)
    dy_dz = np.gradient(gy, axis=1)
    nrm = np.stack([dy_dx, np.ones_like(gy), dy_dz], axis=-1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = np.stack([(gx + 10) / 20, (gz + 10) / 20], axis=-1).reshape(-1, 2)

    idx = np.arange(n * n).reshape(n, n)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[:-1, 1:].ravel()
    # winding chosen so the geometric normal matches the +y vertex normals
    tris = np.concatenate([np.stack([a, c, b], -1), np.stack([c, a, d], -1)])

    vbase = builder.add_vertices(pos, uv, nrm)
    ibase = builder.add_indices((tris + 0).ravel())
    geo = builder.add_geometry(Geometry(vbase, n * n, ibase, len(tris) * 3, True))
    mat = builder.add_material("ground", MetallicRoughnessMaterial(
        color=(0.55, 0.5, 0.45, 1.0), roughness=0.9))
    model = builder.add_model([MeshInfo(geo, mat)])
    node = builder.add_scene_node(0, np.eye(4))
    builder.add_model_instance(model, node)
    builder.set_directional_light(DirectionalLight(color=(3.0, 2.9, 2.7),
                                                   direction=(0.4, -0.8, 0.3)))
    builder.add_camera(InputCamera(45.0, 100.0, 0.1, (0.0, 4.0, -14.0),
                                   (0.0, -0.25, 1.0)))


def create_reuse_mesh_scene(builder: SceneBuilder) -> None:
    """Grid of instances sharing ONE cube model with a cubemap skybox
    (≙ the "Reuse Mesh" catalog entry, ExampleScenes.cpp:248 — exercises
    instancing/geometry reuse and the cube-skybox miss path)."""
    cube_geos = add_cube(builder)
    mat = builder.add_material("reuse", MetallicRoughnessMaterial(
        color=(0.7, 0.7, 0.75, 1.0), roughness=0.35, metalness=0.8))
    model = builder.add_model([MeshInfo(g, mat) for g in cube_geos])
    root = builder.add_scene_node(0, np.eye(4))
    for iy in range(4):
        for ix in range(4):
            node = builder.add_scene_node(
                root, _translate(ix * 3.0 - 4.5, iy * 3.0 - 4.5, 0.0)
                @ _rotate_y(ix * 20 + iy * 10) @ _scale(0.8))
            builder.add_model_instance(model, node)
    # procedural gradient cubemap (6, H, W, 3)
    faces = np.zeros((6, 16, 16, 3), np.float32)
    tints = np.asarray([[1, .6, .4], [.4, .6, 1], [.9, .9, .5],
                        [.3, .3, .35], [.6, 1, .6], [.5, .4, .6]])
    grad = np.linspace(0.4, 1.0, 16)[:, None]
    for f in range(6):
        faces[f] = tints[f] * grad[..., None]
    builder.set_skybox(Skybox(kind=SkyboxKind.CUBE, image=faces))
    builder.set_directional_light(DirectionalLight(color=(2.0, 2.0, 1.9),
                                                   direction=(0.3, 0.8, 0.4)))
    builder.add_camera(InputCamera(45.0, 100.0, 0.1, (0.0, 0.0, -14.0),
                                   (0.0, 0.0, 1.0)))


def make_reuse_mesh_scene() -> Scene:
    b = SceneBuilder("Reuse Mesh")
    create_reuse_mesh_scene(b)
    return b.create_scene()


def make_heightfield_scene(n: int = 224) -> Scene:
    b = SceneBuilder("Heightfield")
    create_heightfield_scene(b, n)
    return b.create_scene()


def make_default_scene() -> Scene:
    b = SceneBuilder("Default")
    create_default_scene(b)
    b.add_camera(InputCamera(45.0, 100.0, 0.1, (3.0, 1.0, 0.0), (-1.0, 0.0, 0.0)))
    return b.create_scene()


def make_roughness_test_scene() -> Scene:
    b = SceneBuilder("Roughness Test Cubes")
    create_roughness_test_scene(b)
    return b.create_scene()


# scene catalog (≙ AddScenes / SceneGroup registry, ExampleScenes.cpp:238-258)
def _make_courtyard():
    from pt_torch.scene.standin import make_courtyard_scene
    return make_courtyard_scene()


def _make_courtyard_flythrough():
    from pt_torch.scene.standin import make_courtyard_flythrough_scene
    return make_courtyard_flythrough_scene()


TEST_SCENES: Dict[str, Callable[[], Scene]] = {
    "Default": make_default_scene,
    "MetallicRoughness Cubes": make_metallic_roughness_cubes_scene,
    "Roughness Test Cubes": make_roughness_test_scene,
    "Heightfield": make_heightfield_scene,
    "Reuse Mesh": make_reuse_mesh_scene,
    "Courtyard": _make_courtyard,
    "Courtyard Flythrough": _make_courtyard_flythrough,
}
