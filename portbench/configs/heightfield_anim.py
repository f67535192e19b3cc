"""Configuration `heightfield_anim`: the n = 224 Heightfield, node-animated.

Frozen copy of the port's `create_heightfield_scene`
(`pt_torch/scene/examples.py`, from `pt`'s bench scene) with its instance
node keyframed in rotation about y and in translation at 24 ticks a second
(`chip_smoke.build_animated_scene` with no alpha cards), numpy only. Every
`scene.update(1 / 24)` moves all of it, so every frame of a video rebuilds
the Morton tree on the card and traces it with kernels K3/K4. 99,458
triangles, one diffuse material, a directional light, its own camera. The
clip loops every 48 ticks (2 s). A stand-in: the grid is `pt`'s own
synthetic bench scene and the animation is assumed (`ASSUMED`); no public
source bears out either.
"""

from __future__ import annotations

import numpy as np

NAME = "heightfield_anim"
SOURCE = ("Procedural stand-in: pt's bench Heightfield (bench.py:217-222), "
          "its animation assumed; BLAS rebuilt a frame as "
          "github.com/piotrprzybyszdev/Path-Tracing "
          "AccelerationStructure.cpp:251-257")
REDUCED: list = []
ASSUMED = {"film": "1920x1080 video, 1 sample a frame",
           "animation": "0.5 rad turn about y and a 0.5/0.2 shift, 48 ticks"}
PARAMS = {"n": 224}
SETTINGS: dict = {}
# ticks of the clip, and its rate: a seed starts the video at a tick of it
CLIP_TICKS = 48
TICKS_PER_SECOND = 24.0


def generate(builder, ns, n: int = 224) -> None:
    xs = np.linspace(-10, 10, n, dtype=np.float32)
    zs = np.linspace(-10, 10, n, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = (np.sin(gx * 1.3) * np.cos(gz * 1.1) * 0.8
          + 0.25 * np.sin(gx * 4.7) * np.sin(gz * 3.9)).astype(np.float32)
    pos = np.stack([gx, -gy, gz], axis=-1).reshape(-1, 3)
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
    tris = np.concatenate([np.stack([a, c, b], -1), np.stack([c, a, d], -1)])

    vbase = builder.add_vertices(pos, uv, nrm)
    ibase = builder.add_indices((tris + 0).ravel())
    geo = builder.add_geometry(ns.Geometry(vbase, n * n, ibase,
                                           len(tris) * 3, True))
    mat = builder.add_material("ground", ns.MetallicRoughnessMaterial(
        color=(0.55, 0.5, 0.45, 1.0), roughness=0.9))
    model = builder.add_model([ns.MeshInfo(geo, mat)])
    node = builder.add_scene_node(0, np.eye(4))
    builder.add_model_instance(model, node)
    builder.set_directional_light(ns.DirectionalLight(
        color=(3.0, 2.9, 2.7), direction=(0.4, -0.8, 0.3)))
    builder.add_camera(ns.InputCamera(45.0, 100.0, 0.1, (0.0, 4.0, -14.0),
                                      (0.0, -0.25, 1.0)))

    half = 0.25                       # half of a 0.5 rad turn about y
    builder.add_animation(ns.Animation(nodes=[ns.AnimationNode(
        scene_node_index=node,
        positions=ns.KeySequence(
            ticks=np.asarray([0.0, 24.0, 48.0]),
            values=np.asarray([[0.0, 0.0, 0.0], [0.5, 0.2, 0.0],
                               [0.0, 0.0, 0.0]])),
        rotations=ns.KeySequence(
            ticks=np.asarray([0.0, 24.0, 48.0]),
            values=np.asarray([[1.0, 0.0, 0.0, 0.0],
                               [np.cos(half), 0.0, np.sin(half), 0.0],
                               [1.0, 0.0, 0.0, 0.0]]),
            is_rotation=True),
        scales=ns.KeySequence(ticks=np.asarray([0.0]),
                              values=np.asarray([[1.0, 1.0, 1.0]])))],
        ticks_per_second=TICKS_PER_SECOND, duration=float(CLIP_TICKS)))
