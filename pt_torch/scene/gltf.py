"""glTF 2.0 scene importer (.gltf / .glb), dependency-free.

Port of `pt.scene.gltf`, which is the counterpart of the reference's assimp-based SceneImporter
(SceneImporter.{h,cpp}): loads node hierarchies, meshes (with tangent
repair), materials (MetallicRoughness + the KHR specular-glossiness
extension → the reference's material-model choice, ChooseMaterialType
SceneImporter.cpp:300-319), textures, keyframe animations, skins (≤4
weights per vertex, SceneImporter.cpp:420-453), punctual lights
(KHR_lights_punctual ≙ assimp light import, SceneImporter.cpp:918+) and
cameras, feeding everything through the same SceneBuilder API.

The reference reaches other formats through assimp; here OBJ and FBX
have importers of their own (`pt_torch.scene.obj`, `pt_torch.scene.fbx`).

Parser notes: JSON + external/embedded buffers, GLB binary container,
sparse accessors, and the core attribute set (POSITION, NORMAL, TANGENT,
TEXCOORD_0, JOINTS_0, WEIGHTS_0). Images decode at texture upload time
(`pt_torch.scene.textures`); the importer only records metadata
(≙ TextureImporter::GetTextureInfo — metadata without pixel load,
SceneImporter.cpp:69-101).
"""

from __future__ import annotations

import base64
import json
import pathlib
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from pt_torch.scene.builder import SceneBuilder
from pt_torch.scene.graph import Animation, AnimationNode, KeySequence
from pt_torch.scene.types import (DirectionalLight, Geometry, MeshInfo,
                            MetallicRoughnessMaterial, PointLight,
                            SpecularGlossinessMaterial, TextureInfo,
                            TextureType)

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


class GLTFFile:
    """Parsed glTF container: JSON + resolved binary buffers."""

    def __init__(self, path: pathlib.Path):
        self.path = pathlib.Path(path)
        self.dir = self.path.parent
        data = self.path.read_bytes()
        if data[:4] == b"glTF":
            self.json, self._glb_bin = self._parse_glb(data)
        else:
            self.json = json.loads(data)
            self._glb_bin = None
        self._buffers: Dict[int, bytes] = {}

    @staticmethod
    def _parse_glb(data: bytes):
        magic, version, _length = struct.unpack_from("<III", data, 0)
        assert magic == 0x46546C67, "not a GLB file"
        offset = 12
        json_chunk = None
        bin_chunk = None
        while offset < len(data):
            clen, ctype = struct.unpack_from("<II", data, offset)
            chunk = data[offset + 8:offset + 8 + clen]
            if ctype == 0x4E4F534A:       # 'JSON'
                json_chunk = json.loads(chunk)
            elif ctype == 0x004E4942:     # 'BIN'
                bin_chunk = bytes(chunk)
            offset += 8 + clen
        return json_chunk, bin_chunk

    def buffer(self, index: int) -> bytes:
        if index in self._buffers:
            return self._buffers[index]
        spec = self.json["buffers"][index]
        uri = spec.get("uri")
        if uri is None:
            data = self._glb_bin
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            from urllib.parse import unquote
            data = (self.dir / unquote(uri)).read_bytes()
        self._buffers[index] = data
        return data

    def accessor(self, index: int) -> np.ndarray:
        """Decode an accessor to (count, components) numpy (handles strides
        and sparse substitution)."""
        acc = self.json["accessors"][index]
        count = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize * ncomp
        # guard against allocation bombs from corrupt/hostile counts: a
        # zero-filled or sparse accessor has no backing buffer to bound it
        if count < 0 or count * itemsize > 2 ** 31:
            raise ValueError(f"accessor {index}: implausible count {count}")

        if "bufferView" in acc:
            bv = self.json["bufferViews"][acc["bufferView"]]
            raw = self.buffer(bv["buffer"])
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", itemsize)
            if stride == itemsize:
                out = np.frombuffer(raw, dtype, count * ncomp, start)
                out = out.reshape(count, ncomp).copy()
            else:
                out = np.zeros((count, ncomp), dtype)
                for i in range(count):
                    out[i] = np.frombuffer(raw, dtype, ncomp,
                                           start + i * stride)
        else:
            out = np.zeros((count, ncomp), dtype)

        sparse = acc.get("sparse")
        if sparse:
            sc = sparse["count"]
            iv = self.json["bufferViews"][sparse["indices"]["bufferView"]]
            idt = _COMPONENT_DTYPES[sparse["indices"]["componentType"]]
            ioff = iv.get("byteOffset", 0) + sparse["indices"].get("byteOffset", 0)
            idx = np.frombuffer(self.buffer(iv["buffer"]), idt, sc, ioff)
            vv = self.json["bufferViews"][sparse["values"]["bufferView"]]
            voff = vv.get("byteOffset", 0) + sparse["values"].get("byteOffset", 0)
            vals = np.frombuffer(self.buffer(vv["buffer"]), dtype,
                                 sc * ncomp, voff).reshape(sc, ncomp)
            out[idx] = vals
        if acc.get("normalized") and np.issubdtype(dtype, np.integer):
            # quantized attributes (gltfpack / KHR_mesh_quantization):
            # integer data maps to [0,1] (unsigned) or [-1,1] (signed)
            info = np.iinfo(dtype)
            out = np.maximum(out.astype(np.float32) / float(info.max), -1.0)
        return out


def _node_local_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    t = node.get("translation", [0, 0, 0])
    r = node.get("rotation", [0, 0, 0, 1])       # glTF xyzw
    s = node.get("scale", [1, 1, 1])
    from pt_torch.scene.graph import trs_matrix
    quat_wxyz = np.asarray([r[3], r[0], r[1], r[2]], np.float64)
    n = np.linalg.norm(quat_wxyz)
    if n > 0:
        quat_wxyz /= n
    return trs_matrix(np.asarray(t, np.float64), quat_wxyz,
                      np.asarray(s, np.float64))


def _make_tangent_frame(normals, tangents4=None):
    """Tangent/bitangent from glTF VEC4 tangents (w = handedness) or
    regenerated (≙ degenerate-tangent regeneration,
    SceneImporter.cpp:516-590)."""
    from pt_torch.scene.builder import _make_tangents
    if tangents4 is None:
        return _make_tangents(normals)
    t = tangents4[:, :3]
    w = tangents4[:, 3:4]
    lens = np.linalg.norm(t, axis=-1, keepdims=True)
    degenerate = (lens < 1e-6)[:, 0]
    t = np.where(lens < 1e-6, 1.0, t / np.maximum(lens, 1e-12))
    b = np.cross(normals, t[:, :3] if t.shape[1] == 3 else t) * w
    if degenerate.any():
        rt, rb = _make_tangents(normals[degenerate])
        t[degenerate] = rt
        b[degenerate] = rb
    return t.astype(np.float32), b.astype(np.float32)


class GLTFImporter:
    """Imports one glTF file into a SceneBuilder (≙ SceneImporter::AddFile,
    SceneImporter.cpp:1048-1116)."""

    def __init__(self, builder: SceneBuilder,
                 texture_mapping: Optional[Dict[TextureType, TextureType]] = None):
        self.b = builder
        self.texture_mapping = texture_mapping or {}

    def add_file(self, path, progress=None) -> None:
        gltf = GLTFFile(pathlib.Path(path))
        g = gltf.json
        self._gltf = gltf
        self._progress = progress

        self._texture_cache: Dict[Tuple[int, TextureType], int] = {}
        self._material_ids = [self._load_material(i, m)
                              for i, m in enumerate(g.get("materials", []))]
        self._default_material = self.b.add_material(
            f"{gltf.path.name}:default", MetallicRoughnessMaterial())

        # nodes: map glTF node ids → builder pre-order node ids
        self._node_map: Dict[int, int] = {}
        scene_idx = g.get("scene", 0)
        roots = g.get("scenes", [{}])[scene_idx].get("nodes", [])
        base = self.b.add_scene_node(0, np.eye(4))
        for r in roots:
            self._load_node(r, base)

        # skins first: primitives with JOINTS_0 need the joint → global
        # bone mapping (≙ LoadBones before mesh loading)
        self._skin_bones: Dict[int, List[int]] = {}
        for skin_idx, skin in enumerate(g.get("skins", [])):
            self._register_skin_bones(skin_idx, skin)

        self._geometry_cache: Dict[Tuple[int, int, int], Tuple[int, int]] = {}
        for gltf_node, builder_node in self._node_map.items():
            node = g["nodes"][gltf_node]
            if "mesh" in node:
                self._instance_mesh(node["mesh"], builder_node,
                                    node.get("skin"))
            if "camera" in node:
                self._load_camera(node["camera"], builder_node)
            ext = node.get("extensions", {})
            if "KHR_lights_punctual" in ext:
                self._load_light(ext["KHR_lights_punctual"]["light"],
                                 builder_node)

        for anim in g.get("animations", []):
            self._load_animation(anim)

    # ------------------------------------------------------------------
    def _load_node(self, idx: int, parent: int) -> None:
        node = self._gltf.json["nodes"][idx]
        bid = self.b.add_scene_node(parent, _node_local_matrix(node))
        self._node_map[idx] = bid
        for child in node.get("children", []):
            self._load_node(child, bid)

    # ------------------------------------------------------------------
    def _texture(self, tex_index: Optional[int], ttype: TextureType) -> int:
        """Register a glTF texture source (≙ LoadMaterialTexture with the
        per-scene TextureMapping override, SceneImporter.cpp:69-101)."""
        from pt_torch.scene.types import default_texture_index
        ttype = self.texture_mapping.get(ttype, ttype)
        if tex_index is None:
            return default_texture_index(ttype)
        key = (tex_index, ttype)
        if key in self._texture_cache:
            return self._texture_cache[key]
        g = self._gltf.json
        tex = g["textures"][tex_index]
        src = tex.get("source")
        if src is None:
            return default_texture_index(ttype)
        image = g["images"][src]
        name = f"{self._gltf.path.name}:image{src}:{int(ttype)}"
        info = TextureInfo(name=name, type=ttype,
                           is_srgb=ttype in (TextureType.COLOR,
                                             TextureType.EMISSIVE))
        if "uri" in image and not image["uri"].startswith("data:"):
            from urllib.parse import unquote
            info.path = str(self._gltf.dir / unquote(image["uri"]))
        elif "uri" in image:
            info.data = base64.b64decode(image["uri"].split(",", 1)[1])
        elif "bufferView" in image:
            bv = g["bufferViews"][image["bufferView"]]
            raw = self._gltf.buffer(bv["buffer"])
            off = bv.get("byteOffset", 0)
            info.data = raw[off:off + bv["byteLength"]]
        idx = self.b.add_texture(info)
        self._texture_cache[key] = idx
        return idx

    def _load_material(self, i: int, m: dict) -> int:
        """MetallicRoughness by default; the specular-glossiness extension
        selects the reference's second material model
        (≙ ChooseMaterialType, SceneImporter.cpp:300-319)."""
        name = (f"{self._gltf.path.stem}:"
                + m.get("name", f"material{i}") + f"#{i}")
        ext = m.get("extensions", {})
        emissive = tuple(m.get("emissiveFactor", [0, 0, 0]))
        emissive_strength = ext.get("KHR_materials_emissive_strength", {}) \
            .get("emissiveStrength", 1.0)
        has_emissive_tex = "emissiveTexture" in m
        emissive_intensity = (emissive_strength
                              if (any(emissive) or has_emissive_tex) else 0.0)
        transmission = ext.get("KHR_materials_transmission", {}) \
            .get("transmissionFactor", 0.0)
        ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5)
        vol = ext.get("KHR_materials_volume", {})
        atten_color = tuple(vol.get("attenuationColor", [1, 1, 1]))
        atten_dist = vol.get("attenuationDistance", 1e32)
        emissive_idx = self._texture(
            m.get("emissiveTexture", {}).get("index"), TextureType.EMISSIVE)
        normal_idx = self._texture(
            m.get("normalTexture", {}).get("index"), TextureType.NORMAL)

        if "KHR_materials_pbrSpecularGlossiness" in ext:
            sg = ext["KHR_materials_pbrSpecularGlossiness"]
            mat = SpecularGlossinessMaterial(
                emissive_color=emissive, emissive_intensity=emissive_intensity,
                color=tuple(sg.get("diffuseFactor", [1, 1, 1, 1])),
                specular=tuple(sg.get("specularFactor", [1, 1, 1])),
                glossiness=sg.get("glossinessFactor", 1.0),
                attenuation_color=atten_color, attenuation_distance=atten_dist,
                ior=ior, transmission=transmission,
                emissive_idx=emissive_idx, normal_idx=normal_idx,
                color_idx=self._texture(
                    sg.get("diffuseTexture", {}).get("index"),
                    TextureType.COLOR),
                specular_idx=self._texture(
                    sg.get("specularGlossinessTexture", {}).get("index"),
                    TextureType.SPECULAR),
                glossiness_idx=self._texture(
                    sg.get("specularGlossinessTexture", {}).get("index"),
                    TextureType.GLOSSINESS),
            )
            return self.b.add_material(name, mat)

        pbr = m.get("pbrMetallicRoughness", {})
        mr_tex = pbr.get("metallicRoughnessTexture", {}).get("index")
        mat = MetallicRoughnessMaterial(
            emissive_color=emissive, emissive_intensity=emissive_intensity,
            color=tuple(pbr.get("baseColorFactor", [1, 1, 1, 1])),
            roughness=pbr.get("roughnessFactor", 1.0),
            metalness=pbr.get("metallicFactor", 1.0),
            ior=ior, transmission=transmission,
            attenuation_color=atten_color, attenuation_distance=atten_dist,
            emissive_idx=emissive_idx, normal_idx=normal_idx,
            color_idx=self._texture(
                pbr.get("baseColorTexture", {}).get("index"),
                TextureType.COLOR),
            roughness_idx=self._texture(mr_tex, TextureType.ROUGHNESS),
            metallic_idx=self._texture(mr_tex, TextureType.METALLIC),
        )
        return self.b.add_material(name, mat)

    # ------------------------------------------------------------------
    def _load_primitive(self, mesh_idx: int, prim_idx: int, prim: dict,
                        skin: Optional[int] = None) -> Tuple[int, bool]:
        """Load one primitive → geometry index (cached by identity,
        ≙ FindSameGeometry mesh dedup, SceneImporter.cpp:403-413).
        Returns (geometry_index, is_opaque). Primitives with JOINTS_0 and
        a skin become animated geometries (skinned on device)."""
        key = (mesh_idx, prim_idx, skin if skin is not None else -1)
        if key in self._geometry_cache:
            return self._geometry_cache[key]
        gltf = self._gltf
        attrs = prim["attributes"]
        pos = gltf.accessor(attrs["POSITION"]).astype(np.float32)
        n = len(pos)
        if "NORMAL" in attrs:
            nrm = gltf.accessor(attrs["NORMAL"]).astype(np.float32)
        else:
            nrm = np.tile(np.array([[0, 1, 0]], np.float32), (n, 1))
        uv = (gltf.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
              if "TEXCOORD_0" in attrs else np.zeros((n, 2), np.float32))
        tan4 = (gltf.accessor(attrs["TANGENT"]).astype(np.float32)
                if "TANGENT" in attrs else None)
        tan, bit = _make_tangent_frame(nrm, tan4)

        if "indices" in prim:
            idx = gltf.accessor(prim["indices"]).astype(np.uint32)[:, 0]
        else:
            idx = np.arange(n, dtype=np.uint32)
        mode = prim.get("mode", 4)
        if mode != 4:
            raise NotImplementedError(f"primitive mode {mode} (triangles only)")

        # material alpha mode → opaque flag (≙ IsOpaque from alpha usage)
        mat_idx = prim.get("material")
        alpha_mode = "OPAQUE"
        if mat_idx is not None:
            alpha_mode = self._gltf.json["materials"][mat_idx] \
                .get("alphaMode", "OPAQUE")
        is_opaque = alpha_mode == "OPAQUE"

        skinned = (skin is not None and "JOINTS_0" in attrs
                   and "WEIGHTS_0" in attrs and skin in self._skin_bones)
        if skinned:
            joints = gltf.accessor(attrs["JOINTS_0"]).astype(np.int64)
            # weights may arrive unnormalized (a classic exporter bug);
            # SceneBuilder.add_animated_vertices normalizes centrally
            # (≙ assimp LimitBoneWeights, SceneImporter.cpp:420-453)
            weights = gltf.accessor(attrs["WEIGHTS_0"]).astype(np.float32)
            bone_map = np.asarray(self._skin_bones[skin], np.int64)
            safe = np.clip(joints, 0, len(bone_map) - 1)
            global_bones = bone_map[safe].astype(np.int32)
            vbase = self.b.add_animated_vertices(pos, uv, nrm, tan, bit,
                                                 global_bones, weights)
            ibase = self.b.add_animated_indices(idx.tolist())
            geo = self.b.add_geometry(Geometry(vbase, n, ibase, len(idx),
                                               is_opaque, is_animated=True))
        else:
            vbase = self.b.add_vertices(pos, uv, nrm, tan, bit)
            ibase = self.b.add_indices(idx.tolist())
            geo = self.b.add_geometry(Geometry(vbase, n, ibase, len(idx),
                                               is_opaque))
        self._geometry_cache[key] = (geo, is_opaque)
        if self._progress:
            self._progress(f"mesh {mesh_idx}.{prim_idx}")
        return geo, is_opaque

    def _instance_mesh(self, mesh_idx: int, builder_node: int,
                       skin: Optional[int]) -> None:
        mesh = self._gltf.json["meshes"][mesh_idx]
        meshes = []
        for pi, prim in enumerate(mesh.get("primitives", [])):
            geo, _ = self._load_primitive(mesh_idx, pi, prim, skin)
            mat = prim.get("material")
            mid = (self._material_ids[mat] if mat is not None
                   else self._default_material)
            meshes.append(MeshInfo(geo, mid))
        model = self.b.add_model(meshes)
        self.b.add_model_instance(model, builder_node)

    # ------------------------------------------------------------------
    def _load_animation(self, anim: dict) -> None:
        """≙ LoadAnimations (SceneImporter.cpp:839-917)."""
        gltf = self._gltf
        nodes: Dict[int, AnimationNode] = {}
        max_time = 0.0
        for ch in anim.get("channels", []):
            target = ch.get("target", {})
            node_idx = target.get("node")
            path = target.get("path")
            if node_idx is None or node_idx not in self._node_map:
                continue
            sampler = anim["samplers"][ch["sampler"]]
            times = gltf.accessor(sampler["input"]).astype(np.float64)[:, 0]
            values = gltf.accessor(sampler["output"]).astype(np.float64)
            max_time = max(max_time, float(times[-1]) if len(times) else 0.0)
            bid = self._node_map[node_idx]
            if bid not in nodes:
                # defaults from the node's current TRS
                node = gltf.json["nodes"][node_idx]
                t0 = np.asarray(node.get("translation", [0, 0, 0]), np.float64)
                r0 = node.get("rotation", [0, 0, 0, 1])
                q0 = np.asarray([r0[3], r0[0], r0[1], r0[2]], np.float64)
                s0 = np.asarray(node.get("scale", [1, 1, 1]), np.float64)
                nodes[bid] = AnimationNode(
                    scene_node_index=bid,
                    positions=KeySequence(np.zeros(1), t0[None]),
                    rotations=KeySequence(np.zeros(1), q0[None],
                                          is_rotation=True),
                    scales=KeySequence(np.zeros(1), s0[None]))
            an = nodes[bid]
            if path == "translation":
                an.positions = KeySequence(times, values[:, :3])
            elif path == "rotation":
                quat = values[:, [3, 0, 1, 2]]     # xyzw → wxyz
                an.rotations = KeySequence(times, quat, is_rotation=True)
            elif path == "scale":
                an.scales = KeySequence(times, values[:, :3])

        if nodes:
            self.b.add_animation(Animation(
                nodes=list(nodes.values()), ticks_per_second=1.0,
                duration=max(max_time, 1e-6),
                name=anim.get("name", "")))

    def _register_skin_bones(self, skin_idx: int, skin: dict) -> None:
        """≙ LoadBones (SceneImporter.cpp:420-453): joints + inverse binds.
        Records the joint → builder-bone mapping for JOINTS_0 remapping."""
        gltf = self._gltf
        joints = skin.get("joints", [])
        if "inverseBindMatrices" in skin:
            ibms = gltf.accessor(skin["inverseBindMatrices"]) \
                .astype(np.float64).reshape(-1, 4, 4).transpose(0, 2, 1)
        else:
            ibms = np.tile(np.eye(4), (len(joints), 1, 1))
        mapping = []
        for j, joint in enumerate(joints):
            if joint in self._node_map:
                mapping.append(self.b.add_bone(
                    f"{self._gltf.path.stem}:skin{skin_idx}:joint{joint}",
                    self._node_map[joint], ibms[j]))
            else:
                mapping.append(0)
        self._skin_bones[skin_idx] = mapping

    def _load_camera(self, cam_idx: int, builder_node: int) -> None:
        """≙ LoadCameras (SceneImporter.cpp:990-1021)."""
        import math
        from pt_torch.core.camera import AnimatedCamera
        cam = self._gltf.json["cameras"][cam_idx]
        if cam.get("type") != "perspective":
            return
        p = cam.get("perspective", {})
        fov = math.degrees(p.get("yfov", math.radians(45.0)))
        near = p.get("znear", 0.1)
        far = p.get("zfar", 1000.0)
        # deferred: Scene construction binds it to the built graph
        self.b.cameras.append(_DeferredGltfCamera(fov, near, far,
                                                  builder_node))

    def _load_light(self, light_idx: int, builder_node: int) -> None:
        g = self._gltf.json
        lights = g.get("extensions", {}).get("KHR_lights_punctual", {}) \
            .get("lights", [])
        if light_idx >= len(lights):
            return
        light = lights[light_idx]
        color = tuple(np.asarray(light.get("color", [1, 1, 1]))
                      * light.get("intensity", 1.0))
        if light["type"] == "directional":
            # KHR punctual lights emit along the node's -Z in world space;
            # walk the builder's parent chain for the world rotation
            m = np.eye(4)
            node = builder_node
            while node != 0:
                m = np.asarray(self.b.node_transforms[node]) @ m
                node = int(self.b.node_parents[node])
            d = -(m[:3, :3] @ np.asarray([0.0, 0.0, 1.0]))
            n = np.linalg.norm(d)
            d = d / n if n > 1e-12 else np.asarray([0.0, -1.0, 0.0])
            self.b.set_directional_light(DirectionalLight(
                color=color, direction=tuple(d)))
        elif light["type"] in ("point", "spot"):
            self.b.add_point_light(
                PointLight(color=color, position=(0.0, 0.0, 0.0),
                           attenuation_constant=0.0, attenuation_linear=0.0,
                           attenuation_quadratic=1.0),
                node_index=builder_node)


class _DeferredGltfCamera:
    """Placeholder resolved by Scene: a camera rigidly attached to a node
    (≙ AnimatedCamera bound to the node's CurrentTransform, Scene.cpp:41-46).
    glTF cameras look toward -Z with +Y up in node space."""

    def __init__(self, fov_deg, near, far, node_index):
        self.fov_deg = fov_deg
        self.near = near
        self.far = far
        self.node_index = node_index

    def resolve(self, graph):
        from pt_torch.core.camera import AnimatedCamera
        return AnimatedCamera(self.fov_deg, self.near, self.far,
                              (0.0, 0.0, 0.0), (0.0, 0.0, -1.0),
                              (0.0, 1.0, 0.0),
                              lambda: graph.current[self.node_index])


def import_gltf(builder: SceneBuilder, path,
                texture_mapping=None, progress=None) -> None:
    """Import one glTF/GLB file into the builder."""
    GLTFImporter(builder, texture_mapping).add_file(path, progress)
