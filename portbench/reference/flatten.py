"""Plain reference: a frozen copy of pt_torch/scene/flatten.py
(without the shared-BLAS layout),
which the port may change without moving the yardstick.

Host Scene → device SoA tensors (DeviceScene).

Port of `pt.scene.flatten`: every (instance, mesh) pair becomes a segment
with its own transform slot, object-space vertices are duplicated per
segment, and the three material models pack into one unified table.
World-space vertices are one batched transform per frame
(`world_vertices`), with linear-blend skinning over a ≤4-bone palette for
vertices that carry bone weights. `update_seg_transforms` refreshes the
per-frame state of an animated scene (segment transforms, bone palette,
lights): one small upload, the only data that crosses the bus in a frame.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from portbench.reference.device import default_device
from portbench.reference.builder import Scene
from portbench.reference.types import (MAX_LIGHT_COUNT, MaterialType,
                                  MetallicRoughnessMaterial, SkyboxKind)

# Unified material float-field layout (columns of DeviceScene.mat_params).
F_EMISSIVE = 0          # ..3  emissive rgb
F_EMISSIVE_INT = 3
F_COLOR = 4             # ..8  base color rgba
F_IOR = 8
F_TRANSMISSION = 9
F_ATTEN_COLOR = 10      # ..13 attenuation rgb
F_ATTEN_DIST = 13
F_ROUGHNESS = 14        # MR roughness factor
F_METALNESS = 15        # MR metalness factor
F_SPECULAR = 16         # ..19 SG/Phong specular rgb
F_GLOSS = 19            # SG glossiness / Phong shininess factor
NUM_MAT_FIELDS = 20

# Texture-slot columns of DeviceScene.mat_tex.
T_EMISSIVE, T_COLOR, T_NORMAL, T_A, T_B = 0, 1, 2, 3, 4
NUM_MAT_TEX = 5

@dataclasses.dataclass
class DeviceScene:
    """Device-resident flattened scene. Tensor fields mirror
    `pt.scene.flatten.DeviceScene`; the integer/bool tails are host
    metadata."""

    # object-space duplicated-per-segment vertex SoA
    obj_positions: torch.Tensor        # (V, 3) f32
    obj_normals: torch.Tensor          # (V, 3) f32
    obj_tangents: torch.Tensor         # (V, 3) f32
    obj_bitangents: torch.Tensor       # (V, 3) f32
    tex_coords: torch.Tensor           # (V, 2) f32
    vert_seg: torch.Tensor             # (V,) i32 segment id per vertex

    tri_idx: torch.Tensor              # (T, 3) i32 absolute vertex indices
    tri_mat: torch.Tensor              # (T,) i32 unified material row
    tri_opaque: torch.Tensor           # (T,) bool

    seg_transform: torch.Tensor        # (S, 4, 4) f32 world transform per segment
    seg_instance: torch.Tensor         # (S,) i32 owning instance id

    # unified material table
    mat_params: torch.Tensor           # (M, NUM_MAT_FIELDS) f32
    mat_tex: torch.Tensor              # (M, NUM_MAT_TEX) i32 texture-table indices
    mat_type: torch.Tensor             # (M,) i32 MaterialType

    # lights
    point_light_color: torch.Tensor    # (MAX_LIGHT_COUNT, 3) f32
    point_light_pos: torch.Tensor      # (MAX_LIGHT_COUNT, 3) f32
    point_light_atten: torch.Tensor    # (MAX_LIGHT_COUNT, 3) f32 const/lin/quad
    point_light_count: torch.Tensor    # () i32
    dir_light_color: torch.Tensor      # (3,) f32
    dir_light_dir: torch.Tensor        # (3,) f32

    # skinning: zero weights = unskinned
    bone_idx: torch.Tensor             # (V, 4) i32
    bone_weight: torch.Tensor          # (V, 4) f32 (rows sum to 1 or 0)
    bone_palette: torch.Tensor         # (B, 4, 4) f32 world @ inverse-bind

    skybox_color: torch.Tensor         # (3,) f32 (CLEAR kind)
    skybox_image: torch.Tensor         # EQUIRECT: (H, W, 3); CUBE: (6, H, W, 3);
                                       # (1, 1, 3) dummy otherwise

    skybox_kind: int = int(SkyboxKind.CLEAR)
    flip_normal_y: bool = False
    has_skinning: bool = False
    # any non-opaque triangles → the integrator runs the alpha-test/decal
    # re-trace loops
    has_alpha: bool = False

    @property
    def num_triangles(self) -> int:
        return self.tri_idx.shape[0]


def world_vertices(ds: DeviceScene):
    """Per-frame world-space flatten: positions via point transform, normal
    frame via the cofactor normal matrix (≙ closest-hit `transform`,
    Shaders/sampling.glsl:5-15), with linear-blend skinning for vertices
    that carry bone weights (≙ skinning.comp:21-50; glTF semantics: a
    skinned vertex ignores its node transform). Returns (positions,
    normals, tangents, bitangents), each (V, 3) f32."""
    seg = ds.vert_seg.long()
    t = ds.seg_transform[seg]                             # (V, 4, 4)
    m = t[:, :3, :3]

    def xfr(mat, v):
        return torch.sum(mat * v[:, None, :], dim=-1)

    pos = xfr(m, ds.obj_positions) + t[:, :3, 3]
    nt = _normal_matrices(ds.seg_transform)[seg]
    nrm = xfr(nt, ds.obj_normals)
    tan = xfr(m, ds.obj_tangents)
    bit = xfr(m, ds.obj_bitangents)

    if ds.has_skinning:
        # blended bone matrix per vertex: (V, 4, 4) = Σ_k w_k palette[idx_k]
        mats = ds.bone_palette[ds.bone_idx.long()]        # (V, 4, 4, 4)
        blend = torch.sum(ds.bone_weight[:, :, None, None] * mats, dim=1)
        sel = (torch.sum(ds.bone_weight, dim=1) > 0.0)[:, None]
        bm = blend[:, :3, :3]
        pos = torch.where(sel, xfr(bm, ds.obj_positions) + blend[:, :3, 3],
                          pos)
        nrm = torch.where(sel, xfr(bm, ds.obj_normals), nrm)
        tan = torch.where(sel, xfr(bm, ds.obj_tangents), tan)
        bit = torch.where(sel, xfr(bm, ds.obj_bitangents), bit)

    def unit(v):
        n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        return v / torch.clamp(n, min=1e-20)
    return pos, unit(nrm), unit(tan), unit(bit)


def _normal_matrices(transforms: torch.Tensor) -> torch.Tensor:
    """Normal matrix of the upper-left 3x3 of each 4x4: the cofactor
    matrix times sign(det) — the inverse-transpose direction after unit
    normalisation, but finite for singular transforms."""
    a = transforms[:, :3, :3]
    r0, r1, r2 = a[:, 0], a[:, 1], a[:, 2]
    cr = lambda x, y: torch.linalg.cross(x, y, dim=-1)  # noqa: E731
    cof = torch.stack([cr(r1, r2), cr(r2, r0), cr(r0, r1)], dim=1)
    det = torch.sum(r0 * cof[:, 0], dim=-1)
    return torch.where(det[:, None, None] < 0, -cof, cof)


def flatten_scene(scene: Scene, device=None) -> DeviceScene:
    """Flatten a host Scene into device tensors
    (≙ Renderer::UpdateSceneData's buffer building, Renderer.cpp:250-399).
    """
    dev = default_device(device)

    positions, normals, tangents, bitangents, uvs = [], [], [], [], []
    vert_seg, tri_idx, tri_mat, tri_opaque = [], [], [], []
    seg_instances: List[int] = []

    mat_rows, mid_to_row = _build_material_table(scene)

    bone_idx, bone_weight = [], []
    n_bones = int(np.asarray(scene.bone_transforms).shape[0])
    vbase = 0
    for inst_i, inst in enumerate(scene.instances):
        model = scene.models[inst.model_index]
        for mesh in model.meshes:
            geo = scene.geometries[mesh.geometry_index]
            seg = len(seg_instances)
            seg_instances.append(inst_i)
            v = scene.animated_vertices if geo.is_animated else scene.vertices
            indices_src = (scene.animated_indices if geo.is_animated
                           else scene.indices)
            s, n = geo.vertex_offset, geo.vertex_count
            positions.append(v.positions[s:s + n])
            normals.append(v.normals[s:s + n])
            tangents.append(v.tangents[s:s + n])
            bitangents.append(v.bitangents[s:s + n])
            uvs.append(v.tex_coords[s:s + n])
            if geo.is_animated:
                bi = np.asarray(v.bone_indices[s:s + n], np.int32)
                # a tensor gather raises (CPU) or faults (card) on an index
                # past the palette, where JAX would clamp: refuse it here
                if bi.size and (bi.min() < 0 or bi.max() >= n_bones):
                    raise ValueError(
                        f"geometry {mesh.geometry_index}: bone index "
                        f"outside the palette of {n_bones} bones")
                bone_idx.append(bi)
                bone_weight.append(v.bone_weights[s:s + n])
            else:
                bone_idx.append(np.zeros((n, 4), np.int32))
                bone_weight.append(np.zeros((n, 4), np.float32))
            vert_seg.append(np.full(n, seg, np.int32))
            idx = indices_src[geo.index_offset:geo.index_offset + geo.index_count]
            tris = np.asarray(idx, np.int64).reshape(-1, 3) + vbase
            tri_idx.append(tris.astype(np.int32))
            row = mid_to_row[mesh.material_id]
            tri_mat.append(np.full(len(tris), row, np.int32))
            tri_opaque.append(np.full(len(tris), geo.is_opaque, bool))
            vbase += n

    if vbase == 0:
        raise ValueError("scene has no instanced geometry")

    cat = lambda xs: np.concatenate(xs, axis=0)  # noqa: E731
    t = lambda a: torch.as_tensor(np.array(a, order="C"), device=dev)  # noqa: E731
    lights = _build_lights(scene)
    opaque = cat(tri_opaque)

    return DeviceScene(
        obj_positions=t(cat(positions)),
        obj_normals=t(cat(normals)),
        obj_tangents=t(cat(tangents)),
        obj_bitangents=t(cat(bitangents)),
        tex_coords=t(cat(uvs)),
        vert_seg=t(cat(vert_seg)),
        tri_idx=t(cat(tri_idx)),
        tri_mat=t(cat(tri_mat)),
        tri_opaque=t(opaque),
        seg_transform=t(_seg_transforms(scene)),
        seg_instance=t(np.asarray(seg_instances, np.int32)),
        mat_params=t(mat_rows["params"]),
        mat_tex=t(mat_rows["tex"]),
        mat_type=t(mat_rows["type"]),
        **{k: t(v) for k, v in lights.items()},
        bone_idx=t(cat(bone_idx)),
        bone_weight=t(cat(bone_weight)),
        bone_palette=t(np.asarray(scene.bone_transforms, np.float32)),
        skybox_color=t(np.asarray(scene.skybox.color, np.float32)),
        skybox_image=t(_skybox_image(scene)),
        skybox_kind=int(scene.skybox.kind),
        flip_normal_y=bool(scene.texture_mapping.get("dx_normals", False)),
        has_skinning=any(g.is_animated for g in scene.geometries),
        has_alpha=bool((~opaque).any()),
    )


def _seg_transforms(scene: Scene) -> np.ndarray:
    """(S, 4, 4) f32 world transform of every (instance, mesh) segment, in
    flatten order, from the scene graph's current state."""
    out = []
    for inst_i, inst in enumerate(scene.instances):
        inst_t = scene.instance_transforms[inst_i].astype(np.float64)
        for mesh in scene.models[inst.model_index].meshes:
            out.append((inst_t @ np.asarray(mesh.transform, np.float64))
                       .astype(np.float32))
    return np.stack(out)


def update_seg_transforms(ds: DeviceScene, scene: Scene) -> DeviceScene:
    """Per-frame refresh of the segment transforms, the bone palette and the
    lights from the host scene graph (a small upload; ≙ the transform-buffer
    update for animated instances). Only valid while the instance/mesh
    structure is unchanged."""
    dev = ds.seg_transform.device
    t = lambda a: torch.as_tensor(np.array(a, order="C"), device=dev)  # noqa: E731
    seg = _seg_transforms(scene)
    if seg.shape != tuple(ds.seg_transform.shape):
        raise ValueError("the scene's instance/mesh structure changed; "
                         "flatten it again")
    return dataclasses.replace(
        ds, seg_transform=t(seg),
        bone_palette=t(np.asarray(scene.bone_transforms, np.float32)),
        **{k: t(v) for k, v in _build_lights(scene).items()})


def _skybox_image(scene: Scene) -> np.ndarray:
    img = scene.skybox.image
    if img is None:
        return np.zeros((1, 1, 3), np.float32)
    return np.asarray(img, np.float32)[..., :3]


def _build_material_table(scene: Scene):
    """Pack all three material pools into the unified table; returns the
    table plus the packed-MaterialId → row lookup."""
    params, tex, types = [], [], []
    mid_to_row = {}

    def add(m, mtype: MaterialType, index: int):
        row = np.zeros(NUM_MAT_FIELDS, np.float32)
        trow = np.zeros(NUM_MAT_TEX, np.int32)
        row[F_EMISSIVE:F_EMISSIVE + 3] = m.emissive_color
        row[F_EMISSIVE_INT] = m.emissive_intensity
        row[F_COLOR:F_COLOR + 4] = m.color
        row[F_IOR] = m.ior
        row[F_TRANSMISSION] = m.transmission
        row[F_ATTEN_COLOR:F_ATTEN_COLOR + 3] = m.attenuation_color
        row[F_ATTEN_DIST] = m.attenuation_distance
        trow[T_EMISSIVE] = m.emissive_idx
        trow[T_COLOR] = m.color_idx
        trow[T_NORMAL] = m.normal_idx
        if mtype == MaterialType.METALLIC_ROUGHNESS:
            row[F_ROUGHNESS] = m.roughness
            row[F_METALNESS] = m.metalness
            trow[T_A] = m.roughness_idx
            trow[T_B] = m.metallic_idx
        else:
            row[F_SPECULAR:F_SPECULAR + 3] = m.specular
            row[F_GLOSS] = (m.glossiness if mtype == MaterialType.SPECULAR_GLOSSINESS
                            else m.shininess)
            trow[T_A] = m.specular_idx
            trow[T_B] = (m.glossiness_idx if mtype == MaterialType.SPECULAR_GLOSSINESS
                         else m.shininess_idx)
        mid = (index << 8) | int(mtype)
        mid_to_row[mid] = len(params)
        params.append(row)
        tex.append(trow)
        types.append(int(mtype))

    for i, m in enumerate(scene.materials_mr):
        add(m, MaterialType.METALLIC_ROUGHNESS, i)
    for i, m in enumerate(scene.materials_sg):
        add(m, MaterialType.SPECULAR_GLOSSINESS, i)
    for i, m in enumerate(scene.materials_ph):
        add(m, MaterialType.PHONG, i)
    if not params:  # default white diffuse
        add(MetallicRoughnessMaterial(), MaterialType.METALLIC_ROUGHNESS, 0)

    return ({"params": np.stack(params), "tex": np.stack(tex),
             "type": np.asarray(types, np.int32)}, mid_to_row)


def _build_lights(scene: Scene):
    colors = np.zeros((MAX_LIGHT_COUNT, 3), np.float32)
    pos = np.zeros((MAX_LIGHT_COUNT, 3), np.float32)
    atten = np.ones((MAX_LIGHT_COUNT, 3), np.float32)
    n = min(len(scene.point_lights), MAX_LIGHT_COUNT)
    for i in range(n):
        light = scene.point_lights[i]
        colors[i] = light.color
        pos[i] = light.position
        atten[i] = (light.attenuation_constant, light.attenuation_linear,
                    light.attenuation_quadratic)
    d = scene.directional_light
    return dict(
        point_light_color=colors,
        point_light_pos=pos,
        point_light_atten=atten,
        point_light_count=np.asarray(n, np.int32),
        dir_light_color=np.asarray(d.color if d else (0, 0, 0), np.float32),
        dir_light_dir=np.asarray(d.direction if d else (0, -1, 0), np.float32),
    )
