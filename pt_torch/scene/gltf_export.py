"""Minimal glTF 2.0 / GLB writer for the port's scenes.

Port of `pt.scene.gltf_export`. Exports a built `Scene`
(`pt_torch.scene.builder`) to a self-contained .glb:
geometry primitives, MetallicRoughness materials with embedded PNG
textures, alpha modes, scene-graph nodes/instances, KHR_lights_punctual
point/directional lights, and a perspective camera.

No reference counterpart (the reference only imports via assimp); this
exists so imported-scene code paths can be exercised end-to-end on files
the importer did not synthesize itself (scene → .glb →
`pt_torch.scene.gltf` → render), and as a general interchange surface.

Textures are embedded as PNG through the port's own encoder
(`pt_torch.out.saver.encode_png`) and read back through its decoder, so a
scene whose textures are pixels or PNG exports without Pillow. The JSON is
`pt`'s (generator "pt" included); the PNG bytes differ from `pt`'s, which
come from Pillow's encoder, but decode to the same pixels.
"""

from __future__ import annotations

import json
import math
import struct
from typing import List, Optional

import numpy as np

from pt_torch.out.saver import encode_png
from pt_torch.scene.builder import Scene
from pt_torch.scene.textures import decode_image_u8
from pt_torch.scene.types import MetallicRoughnessMaterial, TextureInfo

_COMPONENT_F32 = 5126
_COMPONENT_U32 = 5125


class _BinWriter:
    def __init__(self):
        self.buf = bytearray()
        self.views: List[dict] = []
        self.accessors: List[dict] = []

    def _add_view(self, data: bytes, target: Optional[int] = None) -> int:
        while len(self.buf) % 4:
            self.buf.append(0)
        view = {"buffer": 0, "byteOffset": len(self.buf),
                "byteLength": len(data)}
        if target:
            view["target"] = target
        self.buf.extend(data)
        self.views.append(view)
        return len(self.views) - 1

    def add_f32(self, arr: np.ndarray, gltf_type: str) -> int:
        arr = np.ascontiguousarray(arr, np.float32)
        view = self._add_view(arr.tobytes(), target=34962)
        self.accessors.append({
            "bufferView": view, "componentType": _COMPONENT_F32,
            "count": arr.shape[0], "type": gltf_type,
            "min": arr.min(axis=0).tolist() if arr.ndim > 1 else
                   [float(arr.min())],
            "max": arr.max(axis=0).tolist() if arr.ndim > 1 else
                   [float(arr.max())]})
        return len(self.accessors) - 1

    def add_indices(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr, np.uint32).reshape(-1)
        view = self._add_view(arr.tobytes(), target=34963)
        self.accessors.append({
            "bufferView": view, "componentType": _COMPONENT_U32,
            "count": int(arr.shape[0]), "type": "SCALAR"})
        return len(self.accessors) - 1

    def add_image_png(self, pixels: np.ndarray) -> int:
        arr = np.asarray(pixels)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        return self._add_view(encode_png(arr))


def _texture_pixels(info: TextureInfo) -> Optional[np.ndarray]:
    """The texture as an array: its `pixels`, or its bytes or file decoded
    to (H, W, 4) uint8 (PNG by the port's decoder, other formats by
    Pillow); None if it cannot be read."""
    if info.pixels is not None:
        return np.asarray(info.pixels)
    try:
        if info.data is not None:
            return decode_image_u8(info.data)
        if info.path is not None:
            with open(info.path, "rb") as f:
                return decode_image_u8(f.read())
    except Exception:
        return None
    return None


def export_glb(scene: Scene, path: str) -> None:
    """Write `scene` as a single self-contained .glb file."""
    w = _BinWriter()
    g: dict = {"asset": {"version": "2.0", "generator": "pt"},
               "scenes": [{"nodes": []}], "scene": 0,
               "nodes": [], "meshes": [], "materials": [],
               "accessors": [], "bufferViews": [], "buffers": []}

    # ---- textures (referenced ones only) ----------------------------------
    tex_map = {}
    images, textures = [], []
    for ti, info in enumerate(scene.textures):
        px = _texture_pixels(info)
        if px is None:
            continue
        view = w.add_image_png(px)
        images.append({"bufferView": view, "mimeType": "image/png"})
        textures.append({"source": len(images) - 1})
        tex_map[ti] = len(textures) - 1
    if textures:
        g["images"] = images
        g["textures"] = textures

    # ---- materials ---------------------------------------------------------
    # material tables: scene.materials_mr / _sg / _phong with names; the
    # packed MaterialId = index<<8 | type selects the table
    from pt_torch.scene.types import SCENE_TEXTURE_OFFSET

    def tex_ref(idx):
        scene_idx = idx - SCENE_TEXTURE_OFFSET
        if scene_idx in tex_map:
            return {"index": tex_map[scene_idx]}
        return None

    def export_mr(name: str, m: MetallicRoughnessMaterial, alpha_mask: bool):
        pbr = {"baseColorFactor": list(map(float, m.color)),
               "roughnessFactor": float(m.roughness),
               "metallicFactor": float(m.metalness)}
        for key, idx in (("baseColorTexture", m.color_idx),
                         ("metallicRoughnessTexture", m.metallic_idx)):
            r = tex_ref(idx)
            if r:
                pbr[key] = r
        mat = {"name": name, "pbrMetallicRoughness": pbr}
        nrm = tex_ref(m.normal_idx)
        if nrm:
            mat["normalTexture"] = nrm
        emi = tex_ref(m.emissive_idx)
        if emi:
            mat["emissiveTexture"] = emi
        if m.emissive_intensity > 0:
            mat["emissiveFactor"] = [
                float(c) for c in np.asarray(m.emissive_color)
                * min(1.0, m.emissive_intensity)]
            if m.emissive_intensity > 1.0:
                mat.setdefault("extensions", {})[
                    "KHR_materials_emissive_strength"] = {
                        "emissiveStrength": float(m.emissive_intensity)}
        if m.transmission > 0:
            ext = mat.setdefault("extensions", {})
            ext["KHR_materials_transmission"] = {
                "transmissionFactor": float(m.transmission)}
            ext["KHR_materials_ior"] = {"ior": float(m.ior)}
            if m.attenuation_distance < 1e30:
                ext["KHR_materials_volume"] = {
                    "attenuationColor": list(map(float, m.attenuation_color)),
                    "attenuationDistance": float(m.attenuation_distance)}
        if alpha_mask:
            mat["alphaMode"] = "MASK"
            mat["alphaCutoff"] = 0.5
        return mat

    # which materials are used by non-opaque geometry (alpha MASK export)
    alpha_materials = set()
    for model in scene.models:
        for mesh in model.meshes:
            geo = scene.geometries[mesh.geometry_index]
            if not geo.is_opaque:
                alpha_materials.add(mesh.material_id)

    from pt_torch.scene.types import MaterialType, create_material_id
    mat_index = {}                  # packed MaterialId -> gltf material index
    pools = ((MaterialType.METALLIC_ROUGHNESS, scene.materials_mr),
             (MaterialType.SPECULAR_GLOSSINESS, scene.materials_sg),
             (MaterialType.PHONG, scene.materials_ph))
    for mtype, pool in pools:
        for i, mat in enumerate(pool):
            mid = create_material_id(i, mtype)
            name = f"{mtype.name.lower()}-{i}"
            if isinstance(mat, MetallicRoughnessMaterial):
                g["materials"].append(export_mr(name, mat,
                                                mid in alpha_materials))
            else:
                # approximate SG/Phong: export as MR with the diffuse
                # color (the field is `color` on both dataclasses — a
                # getattr fallback here once exported everything white)
                g["materials"].append(export_mr(
                    name, MetallicRoughnessMaterial(color=tuple(mat.color)),
                    mid in alpha_materials))
            mat_index[mid] = len(g["materials"]) - 1

    # ---- meshes: one glTF mesh per model, one primitive per MeshInfo -------
    positions = np.asarray(scene.vertices.positions, np.float32)
    normals = np.asarray(scene.vertices.normals, np.float32)
    uvs = np.asarray(scene.vertices.tex_coords, np.float32)
    indices = np.asarray(scene.indices, np.uint32)
    # skinned geometries index the ANIMATED pools (flatten.py switches on
    # geo.is_animated); slicing them out of the static pools exported
    # other meshes' vertices (or crashed on an empty slice)
    a_positions = np.asarray(scene.animated_vertices.positions, np.float32)
    a_normals = np.asarray(scene.animated_vertices.normals, np.float32)
    a_uvs = np.asarray(scene.animated_vertices.tex_coords, np.float32)
    a_indices = np.asarray(scene.animated_indices, np.uint32)

    for model in scene.models:
        prims = []
        for mesh in model.meshes:
            geo = scene.geometries[mesh.geometry_index]
            vs, vc = geo.vertex_offset, geo.vertex_count
            is_, ic = geo.index_offset, geo.index_count
            if geo.is_animated:
                local_idx = a_indices[is_:is_ + ic]
            else:
                local_idx = indices[is_:is_ + ic]
            xform = np.asarray(mesh.transform, np.float64)
            if geo.is_animated:
                pos = a_positions[vs:vs + vc]
                nrm = a_normals[vs:vs + vc]
            else:
                pos = positions[vs:vs + vc]
                nrm = normals[vs:vs + vc]
            if not np.allclose(xform, np.eye(4)):
                pos = (pos @ xform[:3, :3].T + xform[:3, 3]).astype(np.float32)
                nrm = (nrm @ np.linalg.inv(xform[:3, :3])).astype(np.float32)
                n = np.linalg.norm(nrm, axis=-1, keepdims=True)
                nrm = nrm / np.maximum(n, 1e-12)
            uv = (a_uvs if geo.is_animated else uvs)[vs:vs + vc]
            prim = {"attributes": {
                        "POSITION": w.add_f32(pos, "VEC3"),
                        "NORMAL": w.add_f32(nrm, "VEC3"),
                        "TEXCOORD_0": w.add_f32(uv, "VEC2")},
                    "indices": w.add_indices(local_idx),
                    "material": mat_index[mesh.material_id]}
            prims.append(prim)
        g["meshes"].append({"primitives": prims})

    # ---- nodes: the scene graph, with instances/lights/camera attached ----
    n_nodes = len(scene.graph.parents)
    node_children: List[List[int]] = [[] for _ in range(n_nodes)]
    for i in range(1, n_nodes):
        node_children[scene.graph.parents[i]].append(i)
    inst_of_node = {}
    for inst in scene.instances:
        inst_of_node[inst.scene_node_index] = inst.model_index

    lights = []
    light_of_node = {}
    free_lights = []                # lights without a scene node
    for li, light in enumerate(scene.point_lights):
        lights.append({"type": "point", "color": list(map(float, light.color)),
                       "intensity": 1.0})
        node = scene.point_light_nodes[li]
        if node is not None:
            light_of_node[node] = li
        else:
            free_lights.append((li, light))

    for i in range(n_nodes):
        node = {"matrix": np.asarray(scene.graph.local[i], np.float64)
                .T.reshape(-1).tolist()}
        if node_children[i]:
            node["children"] = node_children[i]
        if i in inst_of_node:
            node["mesh"] = inst_of_node[i]
        if i in light_of_node:
            node.setdefault("extensions", {})["KHR_lights_punctual"] = {
                "light": light_of_node[i]}
        g["nodes"].append(node)
    g["scenes"][0]["nodes"] = [0] if n_nodes else []

    # node-less point lights get standalone nodes at their world position
    for li, light in free_lights:
        m = np.eye(4)
        m[:3, 3] = np.asarray(light.position, np.float64)
        g["nodes"].append({
            "matrix": m.T.reshape(-1).tolist(),
            "extensions": {"KHR_lights_punctual": {"light": li}}})
        g["scenes"][0]["nodes"].append(len(g["nodes"]) - 1)

    dl = scene.directional_light
    if dl is not None and np.any(np.asarray(dl.color) > 0):
        lights.append({"type": "directional",
                       "color": list(map(float, dl.color)),
                       "intensity": 1.0})
        d = np.asarray(dl.direction, np.float64)
        d = d / max(np.linalg.norm(d), 1e-12)
        # KHR directional lights emit along node -Z; build a rotation
        z = np.asarray([0.0, 0.0, -1.0])
        axis = np.cross(z, d)
        s = np.linalg.norm(axis)
        c = float(np.dot(z, d))
        m = np.eye(4)
        if s > 1e-9:
            k = axis / s
            kk = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                           [-k[1], k[0], 0]])
            m[:3, :3] = np.eye(3) + s * kk + (1 - c) * (kk @ kk)
        elif c < 0:
            m[:3, :3] = np.diag([1.0, -1.0, -1.0])
        g["nodes"].append({
            "matrix": m.T.reshape(-1).tolist(),
            "extensions": {"KHR_lights_punctual":
                           {"light": len(lights) - 1}}})
        g["scenes"][0]["nodes"].append(len(g["nodes"]) - 1)

    if lights:
        g.setdefault("extensions", {})["KHR_lights_punctual"] = {
            "lights": lights}
        g["extensionsUsed"] = ["KHR_lights_punctual",
                               "KHR_materials_transmission",
                               "KHR_materials_ior",
                               "KHR_materials_emissive_strength",
                               "KHR_materials_volume"]

    # camera (first scene camera, placed on its own node)
    if scene.cameras:
        cam = scene.cameras[0]
        g["cameras"] = [{"type": "perspective", "perspective": {
            "yfov": math.radians(cam.vertical_fov),
            "znear": min(cam.near_clip, cam.far_clip),
            "zfar": max(cam.near_clip, cam.far_clip)}}]
        pos = np.asarray(cam.position, np.float64)
        fwd = np.asarray(cam.direction, np.float64)
        fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
        up = -np.asarray(cam.up_direction, np.float64)   # camera-up is -Y;
        # world up is +Y (the Vulkan y-down raster cancels the camera flip)
        right = np.cross(up, fwd)
        right /= max(np.linalg.norm(right), 1e-12)
        up2 = np.cross(fwd, right)
        m = np.eye(4)
        m[:3, 0] = right
        m[:3, 1] = up2
        m[:3, 2] = -fwd                       # glTF camera looks along -Z
        m[:3, 3] = pos
        g["nodes"].append({"camera": 0,
                           "matrix": m.T.reshape(-1).tolist()})
        g["scenes"][0]["nodes"].append(len(g["nodes"]) - 1)

    g["accessors"] = w.accessors
    g["bufferViews"] = w.views
    g["buffers"] = [{"byteLength": len(w.buf)}]
    write_glb(path, g, w.buf)


def write_glb(path: str, g: dict, buf: bytes) -> None:
    """Write the glTF JSON `g` and its binary buffer `buf` as a .glb, each
    chunk padded to 4 bytes."""
    json_bytes = json.dumps(g, separators=(",", ":")).encode()
    json_bytes += b" " * ((-len(json_bytes)) % 4)
    bin_bytes = bytes(buf) + b"\0" * ((-len(buf)) % 4)
    total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(json_bytes), b"JSON"))
        f.write(json_bytes)
        f.write(struct.pack("<I4s", len(bin_bytes), b"BIN\0"))
        f.write(bin_bytes)
