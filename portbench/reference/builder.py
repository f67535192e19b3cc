"""Plain reference: a frozen copy of pt_torch/scene/builder.py,
which the port may change without moving the yardstick.

Scene container + mutating SceneBuilder.

Counterpart of the reference's `Scene.{h,cpp}`: an immutable flattened SoA
scene (vertices/indices, transform table with identity at index 0, three
material arrays, texture list, models/instances, bones, graph, lights,
skybox, cameras — Scene.h:160-361) built through a mutating builder with
name-deduplicating Add* methods (AddTexture/AddMaterial dedup by name,
per-mesh transform dedup vs identity in CreateModel, Scene.cpp:337-355;
instance resolution in CreateSceneShared, Scene.cpp:267-335).

`Scene.update(dt)` advances the graph, then refreshes per-instance world
transforms, bone palettes, and node-attached light positions
(≙ Scene::Update, Scene.cpp:52-83).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from portbench.reference.camera import Camera
from portbench.reference.graph import Animation, SceneGraph
from portbench.reference.types import (AnyMaterial, Bone, DirectionalLight, Geometry,
                            MATERIAL_TYPE_OF, MeshInfo, Model, ModelInstance,
                            PointLight, Skybox, TextureInfo,
                            create_material_id)


@dataclasses.dataclass
class VertexArrays:
    """SoA vertex storage (≙ Vertex / packed vec2-array layout,
    Shaders/common.glsl:27-91 — here plain (N,K) arrays, no packing games)."""
    positions: np.ndarray     # (N, 3) f32
    tex_coords: np.ndarray    # (N, 2) f32
    normals: np.ndarray       # (N, 3) f32
    tangents: np.ndarray      # (N, 3) f32
    bitangents: np.ndarray    # (N, 3) f32

    @staticmethod
    def empty() -> "VertexArrays":
        z = lambda k: np.zeros((0, k), dtype=np.float32)
        return VertexArrays(z(3), z(2), z(3), z(3), z(3))

    def __len__(self) -> int:
        return len(self.positions)


@dataclasses.dataclass
class AnimatedVertexArrays(VertexArrays):
    """Adds skinning attributes (≙ AnimatedVertex, ShaderTypes.incl:52-59)."""
    bone_indices: np.ndarray = None   # (N, 4) i32
    bone_weights: np.ndarray = None   # (N, 4) f32

    @staticmethod
    def empty() -> "AnimatedVertexArrays":
        z = lambda k: np.zeros((0, k), dtype=np.float32)
        return AnimatedVertexArrays(z(3), z(2), z(3), z(3), z(3),
                                    np.zeros((0, 4), np.int32), z(4))


class Scene:
    """Flattened immutable scene; constructed only by SceneBuilder."""

    def __init__(self, builder: "SceneBuilder"):
        b = builder
        self.name: str = b.name
        self.vertices: VertexArrays = b.vertices
        self.indices: np.ndarray = np.asarray(b.indices, dtype=np.uint32)
        self.animated_vertices: AnimatedVertexArrays = b.animated_vertices
        self.animated_indices: np.ndarray = np.asarray(b.animated_indices, dtype=np.uint32)
        self.transforms: np.ndarray = np.stack(b.transforms).astype(np.float32)
        self.geometries: List[Geometry] = list(b.geometries)
        self.materials_mr = list(b.materials_mr)
        self.materials_sg = list(b.materials_sg)
        self.materials_ph = list(b.materials_ph)
        self.textures: List[TextureInfo] = list(b.textures)
        self.models: List[Model] = list(b.models)
        self.instances: List[ModelInstance] = list(b.instances)
        self.bones: List[Bone] = list(b.bones)
        self.graph: SceneGraph = SceneGraph(
            np.asarray(b.node_parents, dtype=np.int64),
            np.stack(b.node_transforms) if b.node_transforms else np.zeros((0, 4, 4)),
            np.asarray(b.node_is_relative, dtype=bool) if b.node_is_relative else None,
            b.animations)
        self.point_lights: List[PointLight] = list(b.point_lights)
        self.point_light_nodes: List[Optional[int]] = list(b.point_light_nodes)
        self._light_base_positions = [np.asarray(l.position, np.float64)
                                      for l in self.point_lights]
        self.directional_light: Optional[DirectionalLight] = b.directional_light
        self.skybox: Skybox = b.skybox
        # deferred importer cameras bind to the built graph here
        # (≙ scene cameras constructed against node CurrentTransform,
        # Scene.cpp:41-46)
        self.cameras: List[Camera] = [
            c.resolve(self.graph) if hasattr(c, "resolve") else c
            for c in b.cameras]
        self.texture_mapping: Dict = dict(b.texture_mapping)

        # resolved per-instance world transforms (refreshed by update())
        self.instance_transforms = np.zeros((len(self.instances), 4, 4), np.float32)
        # bone palette: world @ inverse-bind per bone (refreshed by update())
        self.bone_transforms = np.zeros((max(len(self.bones), 1), 4, 4), np.float32)

        self.has_animated_instances = self.graph.has_animations and any(
            self._node_is_animated(inst.scene_node_index) for inst in self.instances)
        self.animation_paused = False
        self._refresh_derived()

    # -- queries ---------------------------------------------------------
    def _node_is_animated(self, node_index: int) -> bool:
        animated = {n.scene_node_index for a in self.graph.animations for n in a.nodes}
        while True:
            if node_index in animated:
                return True
            if node_index == 0:
                return False
            node_index = int(self.graph.parents[node_index])

    @property
    def has_skinned_geometry(self) -> bool:
        return len(self.animated_vertices) > 0

    # -- per-frame update --------------------------------------------------
    def update(self, dt: float) -> bool:
        """Advance animations; returns True when anything moved
        (≙ Scene::Update, Scene.cpp:52-83)."""
        cam_changed, anim_changed = self.update_split(dt)
        return cam_changed or anim_changed

    def update_split(self, dt: float):
        """Like update() but reports (camera_changed, geometry_changed)
        separately: a camera move only resets accumulation, while animated
        nodes/bones also require transform re-upload + accel rebuild
        (≙ the reference's distinct camera/scene update paths,
        Renderer::UpdateSceneData same-scene branch)."""
        cam_changed = False
        for cam in self.cameras:
            cam_changed |= cam.on_update(dt)
        anim_changed = False
        if self.graph.has_animations and not self.animation_paused:
            self.graph.update(dt)
            self._refresh_derived()
            anim_changed = True
        return cam_changed, anim_changed

    def _refresh_derived(self) -> None:
        current = self.graph.current
        for i, inst in enumerate(self.instances):
            self.instance_transforms[i] = current[inst.scene_node_index]
        for i, bone in enumerate(self.bones):
            self.bone_transforms[i] = (current[bone.node_index] @ bone.offset)
        for i, node in enumerate(self.point_light_nodes):
            if node is not None:
                p = current[node] @ np.append(self._light_base_positions[i], 1.0)
                self.point_lights[i].position = tuple(p[:3])


class SceneBuilder:
    """Mutating builder (≙ SceneBuilder, Scene.h:160-270)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.vertices = VertexArrays.empty()
        self.indices: List[int] = []
        self.animated_vertices = AnimatedVertexArrays.empty()
        self.animated_indices: List[int] = []
        self.transforms: List[np.ndarray] = [np.eye(4, dtype=np.float32)]  # 0 = identity
        self.geometries: List[Geometry] = []
        self.materials_mr: List[AnyMaterial] = []
        self.materials_sg: List[AnyMaterial] = []
        self.materials_ph: List[AnyMaterial] = []
        self._material_names: Dict[str, int] = {}
        self.textures: List[TextureInfo] = []
        self._texture_names: Dict[str, int] = {}
        self.models: List[Model] = []
        self.instances: List[ModelInstance] = []
        self.bones: List[Bone] = []
        self._bone_names: Dict[str, int] = {}
        self.node_parents: List[int] = []
        self.node_transforms: List[np.ndarray] = []
        self.node_is_relative: List[bool] = []
        self.animations: List[Animation] = []
        self.point_lights: List[PointLight] = []
        self.point_light_nodes: List[Optional[int]] = []
        self.directional_light: Optional[DirectionalLight] = None
        self.skybox = Skybox()
        self.cameras: List[Camera] = []
        self.texture_mapping: Dict = {}

    # -- geometry ----------------------------------------------------------
    def add_vertices(self, positions, tex_coords, normals, tangents=None,
                     bitangents=None) -> int:
        """Append vertices; returns the base vertex offset."""
        base = len(self.vertices)
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        n = len(positions)
        tex_coords = np.asarray(tex_coords, np.float32).reshape(n, 2)
        normals = np.asarray(normals, np.float32).reshape(n, 3)
        if tangents is None or bitangents is None:
            tangents, bitangents = _make_tangents(normals)
        v = self.vertices
        v.positions = np.concatenate([v.positions, positions])
        v.tex_coords = np.concatenate([v.tex_coords, tex_coords])
        v.normals = np.concatenate([v.normals, normals])
        v.tangents = np.concatenate([v.tangents, np.asarray(tangents, np.float32).reshape(n, 3)])
        v.bitangents = np.concatenate([v.bitangents, np.asarray(bitangents, np.float32).reshape(n, 3)])
        return base

    def add_indices(self, indices: Sequence[int]) -> int:
        base = len(self.indices)
        self.indices.extend(int(i) for i in indices)
        return base

    def add_animated_vertices(self, positions, tex_coords, normals,
                              tangents, bitangents, bone_indices,
                              bone_weights) -> int:
        """Append skinned vertices (≙ AnimatedVertex with ≤4 bone
        influences, ShaderTypes.incl:52-59). Returns the base offset into
        the animated arrays."""
        base = len(self.animated_vertices)
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        n = len(positions)
        v = self.animated_vertices
        v.positions = np.concatenate([v.positions, positions])
        v.tex_coords = np.concatenate(
            [v.tex_coords, np.asarray(tex_coords, np.float32).reshape(n, 2)])
        v.normals = np.concatenate(
            [v.normals, np.asarray(normals, np.float32).reshape(n, 3)])
        v.tangents = np.concatenate(
            [v.tangents, np.asarray(tangents, np.float32).reshape(n, 3)])
        v.bitangents = np.concatenate(
            [v.bitangents, np.asarray(bitangents, np.float32).reshape(n, 3)])
        v.bone_indices = np.concatenate(
            [v.bone_indices, np.asarray(bone_indices, np.int32).reshape(n, 4)])
        w = np.asarray(bone_weights, np.float32).reshape(n, 4)
        wsum = np.maximum(w.sum(axis=1, keepdims=True), 1e-8)
        v.bone_weights = np.concatenate([v.bone_weights, w / wsum])
        return base

    def add_animated_indices(self, indices: Sequence[int]) -> int:
        base = len(self.animated_indices)
        self.animated_indices.extend(int(i) for i in indices)
        return base

    def add_geometry(self, geometry: Geometry) -> int:
        self.geometries.append(geometry)
        return len(self.geometries) - 1

    # -- materials / textures -----------------------------------------------
    def add_material(self, name: str, material: AnyMaterial) -> int:
        """Returns a packed MaterialId; dedups by name
        (≙ SceneBuilder::AddMaterial, Scene.cpp name-dedup)."""
        if name in self._material_names:
            return self._material_names[name]
        mtype = MATERIAL_TYPE_OF[type(material)]
        pool = (self.materials_mr, self.materials_sg, self.materials_ph)[int(mtype)]
        pool.append(material)
        mid = create_material_id(len(pool) - 1, mtype)
        self._material_names[name] = mid
        return mid

    def add_texture(self, info: TextureInfo) -> int:
        """Returns an absolute texture-table index (scene textures start at
        SCENE_TEXTURE_OFFSET like the reference's texture map,
        Renderer.cpp:127-173)."""
        from portbench.reference.types import SCENE_TEXTURE_OFFSET
        # dedup by (name, role, colorspace): the same image used as both
        # color and normal map must be two entries (different sRGB
        # decode), and two roles sharing a bare filename must not collapse
        key = (info.name, int(info.type), bool(info.is_srgb))
        if key in self._texture_names:
            return self._texture_names[key]
        self.textures.append(info)
        idx = SCENE_TEXTURE_OFFSET + len(self.textures) - 1
        self._texture_names[key] = idx
        return idx

    # -- models / instances ---------------------------------------------------
    def add_transform(self, transform: np.ndarray) -> int:
        """Dedup identity to slot 0 (≙ CreateModel, Scene.cpp:337-355)."""
        t = np.asarray(transform, np.float32).reshape(4, 4)
        if np.allclose(t, np.eye(4)):
            return 0
        self.transforms.append(t)
        return len(self.transforms) - 1

    def add_model(self, meshes: Sequence[MeshInfo]) -> int:
        self.models.append(Model(list(meshes)))
        return len(self.models) - 1

    def add_model_instance(self, model_index: int, scene_node_index: int) -> int:
        self.instances.append(ModelInstance(model_index, scene_node_index))
        return len(self.instances) - 1

    # -- graph / animation -----------------------------------------------------
    def add_scene_node(self, parent: int, transform: np.ndarray,
                       is_relative: bool = True) -> int:
        self.node_parents.append(int(parent))
        self.node_transforms.append(np.asarray(transform, np.float64).reshape(4, 4))
        self.node_is_relative.append(bool(is_relative))
        return len(self.node_parents) - 1

    def add_animation(self, animation: Animation) -> int:
        self.animations.append(animation)
        return len(self.animations) - 1

    def add_bone(self, name: str, node_index: int, offset: np.ndarray) -> int:
        if name in self._bone_names:
            return self._bone_names[name]
        self.bones.append(Bone(node_index, np.asarray(offset, np.float64).reshape(4, 4)))
        idx = len(self.bones) - 1
        self._bone_names[name] = idx
        return idx

    # -- lights / camera / skybox -------------------------------------------
    def add_point_light(self, light: PointLight, node_index: Optional[int] = None) -> int:
        self.point_lights.append(light)
        self.point_light_nodes.append(node_index)
        return len(self.point_lights) - 1

    def set_directional_light(self, light: DirectionalLight) -> None:
        self.directional_light = light

    def set_skybox(self, skybox: Skybox) -> None:
        self.skybox = skybox

    def add_camera(self, camera: Camera) -> int:
        self.cameras.append(camera)
        return len(self.cameras) - 1

    # -- finalize -------------------------------------------------------------
    def create_scene(self) -> Scene:
        """≙ SceneBuilder::CreateSceneShared (Scene.cpp:267-335)."""
        if not self.node_parents:
            self.add_scene_node(0, np.eye(4))
        if not self.cameras:
            # the reference's built-in input camera (Scene.h:259-260; note
            # the swapped near/far quirk preserved for matrix parity)
            from portbench.reference.camera import InputCamera
            self.cameras.append(InputCamera(45.0, 100.0, 0.1,
                                            (3.0, 1.0, 0.0), (-1.0, 0.0, 0.0)))
        return Scene(self)


def _make_tangents(normals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Arbitrary-but-stable tangent frame for normals lacking authored
    tangents (≙ computeTangentSpace, Shaders/common.glsl:188-197)."""
    n = np.asarray(normals, np.float64)
    t1 = np.cross(n, np.array([1.0, 0.0, 0.0]))
    t2 = np.cross(n, np.array([0.0, 1.0, 0.0]))
    use1 = (np.linalg.norm(t1, axis=-1) > np.linalg.norm(t2, axis=-1))[:, None]
    t = np.where(use1, t1, t2)
    t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    b = np.cross(n, t)
    b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return t.astype(np.float32), b.astype(np.float32)
