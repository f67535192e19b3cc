"""Wavefront OBJ/MTL importer (dependency-free).

Port of `pt.scene.obj`, a partial counterpart of the reference's
assimp multi-format import (SceneImporter.cpp:1060-1075 reads
glTF/FBX/OBJ/... through assimp): glTF/GLB import natively
(`pt_torch.scene.gltf`), FBX through `pt_torch.scene.fbx`, and OBJ/MTL
here.

Supported: v/vn/vt, polygonal f with negative indices (fan-triangulated),
g/o object grouping, usemtl/mtllib, MTL Kd/Ks/Ke/Ns/d/Tr/Ni and
map_Kd/map_Ks/map_Ke/map_bump/bump/map_d. Materials map to Phong
(matching the reference's assimp OBJ behavior — aiShadingMode_Phong).
Missing normals are generated flat per face.
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from pt_torch.scene.builder import SceneBuilder
from pt_torch.scene.types import (Geometry, MeshInfo, PhongMaterial, TextureInfo,
                            TextureType)


def _parse_mtl(path: pathlib.Path) -> Dict[str, dict]:
    mats: Dict[str, dict] = {}
    cur: Optional[dict] = None
    try:
        lines = path.read_text(errors="replace").splitlines()
    except OSError:
        return mats
    for line in lines:
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        key = parts[0].lower()
        if key == "newmtl":
            cur = mats.setdefault(" ".join(parts[1:]), {})
        elif cur is None:
            continue
        elif key in ("kd", "ks", "ke") and len(parts) >= 4:
            cur[key] = tuple(float(x) for x in parts[1:4])
        elif key == "ns":
            cur["ns"] = float(parts[1])
        elif key == "d":
            cur["d"] = float(parts[1])
        elif key == "tr":
            cur["d"] = 1.0 - float(parts[1])
        elif key == "ni":
            cur["ni"] = float(parts[1])
        elif key in ("map_kd", "map_ks", "map_ke", "map_bump", "bump",
                     "map_d"):
            # the texture path is the last token (options are skipped)
            cur[key.replace("bump", "map_bump") if key == "bump" else key] \
                = parts[-1]
    return mats


def import_obj(builder: SceneBuilder, path) -> None:
    """Parse an .obj (+ .mtl) into the builder as one model instance per
    usemtl/object group."""
    path = pathlib.Path(path)
    base = path.parent
    vs: List[Tuple[float, float, float]] = []
    vts: List[Tuple[float, float]] = []
    vns: List[Tuple[float, float, float]] = []
    mtl_defs: Dict[str, dict] = {}
    # group faces by active material: list of (vi, ti, ni) triples
    groups: Dict[str, List[Tuple]] = {}
    active = "__default__"

    def resolve(idx: int, count: int) -> int:
        return idx - 1 if idx > 0 else count + idx

    for raw in path.read_text(errors="replace").splitlines():
        parts = raw.split()
        if not parts or parts[0].startswith("#"):
            continue
        tag = parts[0]
        if tag == "v" and len(parts) >= 4:
            vs.append(tuple(float(x) for x in parts[1:4]))
        elif tag == "vt" and len(parts) >= 3:
            vts.append((float(parts[1]), 1.0 - float(parts[2])))
        elif tag == "vn" and len(parts) >= 4:
            vns.append(tuple(float(x) for x in parts[1:4]))
        elif tag == "mtllib" and len(parts) >= 2:
            mtl_defs.update(_parse_mtl(base / " ".join(parts[1:])))
        elif tag == "usemtl" and len(parts) >= 2:
            active = " ".join(parts[1:])
        elif tag == "f" and len(parts) >= 4:
            corners = []
            for spec in parts[1:]:
                bits = spec.split("/")
                vi = resolve(int(bits[0]), len(vs))
                ti = resolve(int(bits[1]), len(vts)) \
                    if len(bits) > 1 and bits[1] else -1
                ni = resolve(int(bits[2]), len(vns)) \
                    if len(bits) > 2 and bits[2] else -1
                corners.append((vi, ti, ni))
            tris = groups.setdefault(active, [])
            for k in range(1, len(corners) - 1):     # fan triangulation
                tris.append((corners[0], corners[k], corners[k + 1]))

    if not groups:
        raise ValueError(f"no faces in {path}")
    vs_np = np.asarray(vs, np.float32) if vs else np.zeros((0, 3), np.float32)
    vts_np = np.asarray(vts, np.float32) if vts \
        else np.zeros((0, 2), np.float32)
    vns_np = np.asarray(vns, np.float32) if vns \
        else np.zeros((0, 3), np.float32)

    def add_texture(name: Optional[str], ttype: TextureType) -> Optional[int]:
        if not name:
            return None
        p = base / name
        if not p.exists():
            return None
        return builder.add_texture(TextureInfo(
            name=name, type=ttype, path=str(p),
            is_srgb=ttype in (TextureType.COLOR, TextureType.EMISSIVE)))

    meshes = []
    for mat_name, tris in groups.items():
        d = mtl_defs.get(mat_name, {})
        kwargs = dict(
            color=tuple(d.get("kd", (0.8, 0.8, 0.8))) + (d.get("d", 1.0),),
            specular=tuple(d.get("ks", (0.0, 0.0, 0.0))),
            shininess=float(d.get("ns", 0.0)),
            emissive_color=tuple(d.get("ke", (0.0, 0.0, 0.0))),
            emissive_intensity=1.0 if any(d.get("ke", (0, 0, 0))) else 0.0,
            ior=float(d.get("ni", 1.5)))
        tex = add_texture(d.get("map_kd"), TextureType.COLOR)
        if tex is not None:
            kwargs["color_idx"] = tex
        tex = add_texture(d.get("map_ks"), TextureType.SPECULAR)
        if tex is not None:
            kwargs["specular_idx"] = tex
        tex = add_texture(d.get("map_ke"), TextureType.EMISSIVE)
        if tex is not None:
            kwargs["emissive_idx"] = tex
        tex = add_texture(d.get("map_bump"), TextureType.NORMAL)
        if tex is not None:
            kwargs["normal_idx"] = tex
        mid = builder.add_material(f"{path.stem}:{mat_name}",
                                   PhongMaterial(**kwargs))

        # de-duplicate (v, vt, vn) corners into a local vertex pool
        pool: Dict[Tuple, int] = {}
        pos, uv, nrm, idx = [], [], [], []
        flat_normals = []
        for tri in tris:
            p0 = vs_np[tri[0][0]]
            p1 = vs_np[tri[1][0]]
            p2 = vs_np[tri[2][0]]
            fn = np.cross(p1 - p0, p2 - p0)
            ln = np.linalg.norm(fn)
            fn = fn / ln if ln > 1e-20 else np.asarray([0, 1, 0], np.float32)
            for corner in tri:
                # flat-shaded corners get a sentinel that can never equal
                # an authored vn index (a plain counter collided with
                # real normal indices, silently reusing another corner's
                # normal)
                key = corner if corner[2] >= 0 else (
                    corner[0], corner[1], -2 - len(flat_normals))
                if key not in pool:
                    pool[key] = len(pos)
                    pos.append(vs_np[corner[0]])
                    uv.append(vts_np[corner[1]] if corner[1] >= 0
                              else (0.0, 0.0))
                    nrm.append(vns_np[corner[2]] if corner[2] >= 0 else fn)
                idx.append(pool[key])
            flat_normals.append(fn)

        vbase = builder.add_vertices(np.asarray(pos, np.float32),
                                     np.asarray(uv, np.float32),
                                     np.asarray(nrm, np.float32))
        ibase = builder.add_indices(np.asarray(idx, np.uint32))
        geo = builder.add_geometry(Geometry(
            vbase, len(pos), ibase, len(idx),
            is_opaque=d.get("d", 1.0) >= 1.0 and "map_d" not in d))
        meshes.append(MeshInfo(geo, mid))

    model = builder.add_model(meshes)
    node = builder.add_scene_node(0, np.eye(4))
    builder.add_model_instance(model, node)
