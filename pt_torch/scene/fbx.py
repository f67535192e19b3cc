"""Binary FBX importer (dependency-free, static-mesh subset).

Port of `pt.scene.fbx`, the counterpart of the reference's assimp FBX
path (SceneImporter.cpp:1060-1075 reads FBX through assimp; materials
arrive as Phong, SceneImporter.cpp:~300 material-type inference): the
binary FBX container is read natively. Supported subset — the same things the reference's
scenes actually use from FBX:

* node records (32-bit ≤7.4 and 64-bit ≥7.5 layouts), zlib-compressed
  array properties
* Objects/Geometry meshes: Vertices, PolygonVertexIndex (fan
  triangulation), LayerElementNormal / LayerElementUV in every
  mapping/reference combination (ByPolygonVertex, ByVertice, ByPolygon,
  AllSame × Direct, IndexToDirect), LayerElementMaterial ByPolygon
  (multi-material meshes split into one geometry per material)
* Objects/Model transform: Lcl Translation / Rotation (euler XYZ,
  degrees) / Scaling, PreRotation, nested model hierarchy via OO
  connections
* Objects/Material: DiffuseColor/SpecularColor/EmissiveColor,
  Shininess, Opacity → PhongMaterial (assimp reports FBX surface
  materials as Phong)
* Objects/Texture → material DiffuseColor/NormalMap/... via OP
  connections; file paths resolved relative to the .fbx

Both container flavors parse: the binary format above and ASCII FBX
(`Name: props { children }` records with `*N`/`a:` array blocks).
Also supported: skin deformers (≤4 influences/vertex → bones + LBS) and
animation curves (AnimationCurveNode/AnimationCurve → TRS keyframe
clips).
"""

from __future__ import annotations

import pathlib
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from pt_torch.scene.builder import SceneBuilder
from pt_torch.scene.types import (Geometry, MeshInfo, PhongMaterial, TextureInfo,
                            TextureType)

_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"


class FbxNode:
    __slots__ = ("name", "props", "children")

    def __init__(self, name: str, props: list, children: list):
        self.name = name
        self.props = props
        self.children = children

    def find(self, name: str) -> Optional["FbxNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["FbxNode"]:
        return [c for c in self.children if c.name == name]


def _read_props(buf: memoryview, pos: int, count: int) -> Tuple[list, int]:
    props = []
    for _ in range(count):
        code = chr(buf[pos])
        pos += 1
        if code == "Y":
            props.append(struct.unpack_from("<h", buf, pos)[0]); pos += 2
        elif code == "C":
            props.append(bool(buf[pos])); pos += 1
        elif code == "I":
            props.append(struct.unpack_from("<i", buf, pos)[0]); pos += 4
        elif code == "F":
            props.append(struct.unpack_from("<f", buf, pos)[0]); pos += 4
        elif code == "D":
            props.append(struct.unpack_from("<d", buf, pos)[0]); pos += 8
        elif code == "L":
            props.append(struct.unpack_from("<q", buf, pos)[0]); pos += 8
        elif code in "fdlib":
            n, enc, clen = struct.unpack_from("<III", buf, pos)
            pos += 12
            raw = bytes(buf[pos:pos + clen])
            pos += clen
            if enc == 1:
                raw = zlib.decompress(raw)
            dtype = {"f": "<f4", "d": "<f8", "l": "<i8", "i": "<i4",
                     "b": "b"}[code]
            props.append(np.frombuffer(raw, dtype=dtype, count=n))
        elif code == "S":
            n = struct.unpack_from("<I", buf, pos)[0]
            props.append(bytes(buf[pos + 4:pos + 4 + n]).decode(
                "utf-8", errors="replace"))
            pos += 4 + n
        elif code == "R":
            n = struct.unpack_from("<I", buf, pos)[0]
            props.append(bytes(buf[pos + 4:pos + 4 + n]))
            pos += 4 + n
        else:
            raise ValueError(f"unknown FBX property type {code!r}")
    return props, pos


def _read_node(buf: memoryview, pos: int,
               wide: bool) -> Tuple[Optional[FbxNode], int]:
    start = pos
    if wide:
        end, nprops, _plen = struct.unpack_from("<QQQ", buf, pos)
        pos += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", buf, pos)
        pos += 12
    name_len = buf[pos]
    pos += 1
    if end == 0 and nprops == 0 and name_len == 0:
        return None, pos          # null record (child-list terminator)
    # `end` is the absolute offset one past this record. A malformed file
    # whose end points at or before the record start would rewind the
    # caller's scan loop (`while pos < end` / the top-level loop) into an
    # infinite re-parse cycle — reject instead of spinning.
    if end <= start or end > len(buf):
        raise ValueError(
            f"FBX record at {start} has invalid end offset {end}")
    name = bytes(buf[pos:pos + name_len]).decode("ascii", errors="replace")
    pos += name_len
    props, pos = _read_props(buf, pos, nprops)
    children = []
    while pos < end:
        child, pos = _read_node(buf, pos, wide)
        if child is None:
            break
        children.append(child)
    return FbxNode(name, props, children), end


class _AsciiScanner:
    """Recursive-descent parser for ASCII FBX (the text twin of the
    binary container: `Name: prop, prop { children }` records, `*N`
    array markers with `a:` payload blocks)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)

    def _skip_ws(self):
        t, n = self.text, self.n
        while self.pos < n:
            c = t[self.pos]
            if c == ";":
                while self.pos < n and t[self.pos] != "\n":
                    self.pos += 1
            elif c.isspace():
                self.pos += 1
            else:
                break

    def parse_nodes(self) -> List[FbxNode]:
        nodes = []
        while True:
            self._skip_ws()
            if self.pos >= self.n or self.text[self.pos] == "}":
                return nodes
            nodes.append(self._parse_node())

    @staticmethod
    def _value(tok: str):
        tok = tok.strip()
        if not tok:
            return None
        if tok.startswith('"'):
            s = tok[1:-1] if tok.endswith('"') else tok[1:]
            # "Class::name" convention mirrors the binary's
            # "name\x00\x01Class"; keep the full string (importer splits)
            return s
        try:
            return int(tok)
        except ValueError:
            try:
                return float(tok)
            except ValueError:
                return tok           # bare word (T, W, Y, ...)

    def _scan_props(self) -> Tuple[list, Optional[int]]:
        """Props up to '{' or end-of-line. Returns (props, array_len)."""
        t, n = self.text, self.n
        props: list = []
        buf = ""
        array_len = None
        in_str = False
        while self.pos < n:
            c = t[self.pos]
            if in_str:
                buf += c
                if c == '"':
                    in_str = False
                self.pos += 1
                continue
            if c == '"':
                in_str = True
                buf += c
                self.pos += 1
            elif c == ",":
                props.append(self._value(buf))
                buf = ""
                self.pos += 1
            elif c in "{\n}":
                break
            else:
                buf += c
                self.pos += 1
        if buf.strip():
            v = buf.strip()
            if v.startswith("*"):
                array_len = int(v[1:])
            else:
                props.append(self._value(buf))
        return props, array_len

    def _parse_array(self, count: int) -> np.ndarray:
        """`{ a: csv... }` payload (may span lines)."""
        t = self.text
        self._skip_ws()
        if t[self.pos] != "{":
            raise ValueError("FBX ASCII: expected array block")
        self.pos += 1
        self._skip_ws()
        if t[self.pos:self.pos + 2] == "a:":
            self.pos += 2
        end = t.index("}", self.pos)
        payload = t[self.pos:end]
        self.pos = end + 1
        is_float = any(ch in payload for ch in ".eE")
        vals = np.asarray([float(x) for x in payload.replace("\n", ",")
                           .split(",") if x.strip()],
                          np.float64 if is_float else np.int64)
        return vals[:count] if len(vals) > count else vals

    def _parse_node(self) -> FbxNode:
        t = self.text
        start = self.pos
        while t[self.pos] != ":":
            self.pos += 1
        name = t[start:self.pos].strip()
        self.pos += 1
        props, array_len = self._scan_props()
        children: List[FbxNode] = []
        self._skip_ws()
        if self.pos < self.n and t[self.pos] == "{":
            if array_len is not None:
                props.append(self._parse_array(array_len))
            else:
                self.pos += 1
                children = self.parse_nodes()
                self._skip_ws()
                if self.pos < self.n and t[self.pos] == "}":
                    self.pos += 1
        return FbxNode(name, props, children)


def _parse_ascii(text: str) -> Tuple[List[FbxNode], int]:
    nodes = _AsciiScanner(text).parse_nodes()
    version = 7400
    for node in nodes:
        if node.name == "FBXHeaderExtension":
            v = node.find("FBXVersion")
            if v is not None and v.props:
                version = int(v.props[0])
    return nodes, version


def parse_fbx(data: bytes) -> Tuple[List[FbxNode], int]:
    """Parse the top-level node list of a binary or ASCII FBX. Returns
    (nodes, version)."""
    if not data.startswith(_MAGIC):
        head = data[:4096].lstrip()
        if head.startswith(b";") or b"FBXHeaderExtension" in data[:65536]:
            return _parse_ascii(data.decode("utf-8", errors="replace"))
        raise ValueError("not a binary or ASCII FBX file")
    version = struct.unpack_from("<I", data, len(_MAGIC))[0]
    wide = version >= 7500
    buf = memoryview(data)
    pos = len(_MAGIC) + 4
    nodes = []
    while pos < len(data):
        node, pos = _read_node(buf, pos, wide)
        if node is None:
            break
        nodes.append(node)
    return nodes, version


def _p70(node: Optional[FbxNode]) -> Dict[str, list]:
    """Properties70 → {name: [values...]}. Each P: name, type, label,
    flags, values..."""
    out: Dict[str, list] = {}
    if node is None:
        return out
    p70 = node.find("Properties70")
    if p70 is None:
        return out
    for p in p70.find_all("P"):
        if p.props:
            out[p.props[0]] = p.props[4:]
    return out


def _rot_xyz(deg) -> np.ndarray:
    rx, ry, rz = np.radians(np.asarray(deg, np.float64))
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    # FBX default rotation order eEulerXYZ: X applied first
    return mz @ my @ mx


def _local_matrix(props: Dict[str, list]) -> np.ndarray:
    t = np.asarray(props.get("Lcl Translation", [0, 0, 0])[:3], np.float64)
    r = props.get("Lcl Rotation", [0, 0, 0])[:3]
    pre = props.get("PreRotation")
    s = np.asarray(props.get("Lcl Scaling", [1, 1, 1])[:3], np.float64)
    rot = _rot_xyz(r)
    if pre is not None:
        rot = _rot_xyz(pre[:3]) @ rot
    m = np.eye(4)
    m[:3, :3] = rot * s[None, :]
    m[:3, 3] = t
    return m


def _layer_attr(geo: FbxNode, layer_name: str, data_name: str,
                index_name: str, poly_vidx: np.ndarray,
                tri_corners: np.ndarray, width: int) -> Optional[np.ndarray]:
    """Resolve a layer element (normals/uv) to per-triangle-corner values.

    poly_vidx: raw PolygonVertexIndex (negatives mark polygon ends);
    tri_corners: (K,) indices into poly_vidx for each emitted corner."""
    layer = geo.find(layer_name)
    if layer is None:
        return None
    data_node = layer.find(data_name)
    if data_node is None or not data_node.props:
        return None
    data = np.asarray(data_node.props[0], np.float32).reshape(-1, width)
    mapping = (layer.find("MappingInformationType").props[0]
               if layer.find("MappingInformationType") else "ByPolygonVertex")
    ref = (layer.find("ReferenceInformationType").props[0]
           if layer.find("ReferenceInformationType") else "Direct")
    idx_node = layer.find(index_name)
    indices = (np.asarray(idx_node.props[0], np.int64)
               if ref == "IndexToDirect" and idx_node is not None
               and idx_node.props else None)

    vert_of_corner = np.where(poly_vidx < 0, -poly_vidx - 1, poly_vidx)
    if mapping == "ByPolygonVertex":
        per = np.arange(len(poly_vidx))
    elif mapping in ("ByVertice", "ByVertex"):
        per = vert_of_corner
    elif mapping == "ByPolygon":
        poly_id = np.cumsum(np.concatenate([[0], (poly_vidx[:-1] < 0)]))
        per = poly_id
    elif mapping == "AllSame":
        per = np.zeros(len(poly_vidx), np.int64)
    else:
        return None
    if indices is not None:
        per = indices[np.minimum(per, len(indices) - 1)]
    per = np.minimum(per, len(data) - 1)
    return data[per[tri_corners]]


def import_fbx(builder: SceneBuilder, path) -> None:
    """Parse a binary .fbx into the builder: one model per FBX Model node
    (world transform from the OO hierarchy), one mesh per connected
    geometry+material."""
    path = pathlib.Path(path)
    nodes, _version = parse_fbx(path.read_bytes())
    top = {n.name: n for n in nodes}
    objects = top.get("Objects")
    connections = top.get("Connections")
    if objects is None:
        raise ValueError(f"no Objects section in {path}")

    geoms: Dict[int, FbxNode] = {}
    models: Dict[int, FbxNode] = {}
    materials: Dict[int, FbxNode] = {}
    textures: Dict[int, FbxNode] = {}
    skins: Dict[int, FbxNode] = {}      # Deformer "Skin"
    clusters: Dict[int, FbxNode] = {}   # Deformer "Cluster" (SubDeformer)
    curve_nodes: Dict[int, FbxNode] = {}
    curves: Dict[int, FbxNode] = {}
    for o in objects.children:
        if not o.props:
            continue
        oid = int(o.props[0])
        if o.name == "Geometry":
            geoms[oid] = o
        elif o.name == "Model":
            models[oid] = o
        elif o.name == "Material":
            materials[oid] = o
        elif o.name == "Texture":
            textures[oid] = o
        elif o.name in ("Deformer", "SubDeformer"):
            kind = str(o.props[-1]) if len(o.props) >= 2 else ""
            (skins if kind == "Skin" else clusters)[oid] = o
        elif o.name == "AnimationCurveNode":
            curve_nodes[oid] = o
        elif o.name == "AnimationCurve":
            curves[oid] = o

    # connections: child → parent (OO), child → (parent, property) (OP)
    oo_parent: Dict[int, List[int]] = {}
    op_links: List[Tuple[int, int, str]] = []
    if connections is not None:
        for c in connections.find_all("C"):
            kind = c.props[0]
            child, parent = int(c.props[1]), int(c.props[2])
            if kind == "OO":
                oo_parent.setdefault(child, []).append(parent)
            elif kind == "OP" and len(c.props) >= 4:
                op_links.append((child, parent, str(c.props[3])))

    def children_of(parent: int, pool: dict) -> List[int]:
        return [c for c, ps in oo_parent.items()
                if parent in ps and c in pool]

    # scene nodes for EVERY Model (bones and animation channels target
    # nodes, so the full hierarchy must exist — local transforms compose
    # through the scene graph like the reference's assimp node import)
    node_of_model: Dict[int, int] = {}

    def ensure_node(mid: int) -> int:
        if mid in node_of_model:
            return node_of_model[mid]
        parent_node = 0
        for p in oo_parent.get(mid, []):
            if p in models:
                parent_node = ensure_node(p)
                break
        n = builder.add_scene_node(parent_node,
                                   _local_matrix(_p70(models[mid])))
        node_of_model[mid] = n
        return n

    # material build (assimp maps FBX surface materials to Phong)
    tex_of_mat: Dict[int, Dict[str, int]] = {}
    for tex_id, parent, prop in op_links:
        if tex_id in textures and parent in materials:
            tex_of_mat.setdefault(parent, {})[prop] = tex_id

    def add_texture(tex_id: Optional[int],
                    ttype: TextureType) -> Optional[int]:
        if tex_id is None:
            return None
        tn = textures[tex_id]
        fn = None
        for key in ("RelativeFilename", "FileName"):
            node = tn.find(key)
            if node is not None and node.props and node.props[0]:
                fn = str(node.props[0]).replace("\\", "/")
                p = path.parent / pathlib.Path(fn).name
                if not p.exists():
                    p = path.parent / fn
                if p.exists():
                    return builder.add_texture(TextureInfo(
                        name=pathlib.Path(fn).name, type=ttype, path=str(p),
                        is_srgb=ttype in (TextureType.COLOR,
                                          TextureType.EMISSIVE)))
        return None

    mat_index: Dict[int, int] = {}

    def build_material(mat_id: Optional[int]) -> int:
        if mat_id is None:
            return builder.add_material(f"{path.stem}:default",
                                        PhongMaterial())
        if mat_id in mat_index:
            return mat_index[mat_id]
        p = _p70(materials[mat_id])
        links = tex_of_mat.get(mat_id, {})
        kwargs = dict(
            color=tuple(float(x) for x in
                        p.get("DiffuseColor", [0.8, 0.8, 0.8])[:3])
            + (float(p.get("Opacity", [1.0])[0]),),
            specular=tuple(float(x) for x in
                           p.get("SpecularColor", [0, 0, 0])[:3]),
            shininess=float(p.get("Shininess", [0.0])[0]),
            emissive_color=tuple(float(x) for x in
                                 p.get("EmissiveColor", [0, 0, 0])[:3]),
        )
        kwargs["emissive_intensity"] = \
            1.0 if any(kwargs["emissive_color"]) else 0.0
        tex = add_texture(links.get("DiffuseColor"), TextureType.COLOR)
        if tex is not None:
            kwargs["color_idx"] = tex
        tex = add_texture(links.get("SpecularColor"), TextureType.SPECULAR)
        if tex is not None:
            kwargs["specular_idx"] = tex
        tex = add_texture(links.get("NormalMap") or links.get("Bump"),
                          TextureType.NORMAL)
        if tex is not None:
            kwargs["normal_idx"] = tex
        tex = add_texture(links.get("EmissiveColor"), TextureType.EMISSIVE)
        if tex is not None:
            kwargs["emissive_idx"] = tex
        name_prop = materials[mat_id].props
        name = (str(name_prop[1]).split("\x00")[0]
                if len(name_prop) > 1 else str(mat_id))
        idx = builder.add_material(f"{path.stem}:{name}",
                                   PhongMaterial(**kwargs))
        mat_index[mat_id] = idx
        return idx

    def skin_weights(gid: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Per-control-point (4,) bone indices/weights from the geometry's
        Skin deformer clusters (≙ assimp aiBone import,
        SceneImporter.cpp:420-453: ≤4 influences, normalized)."""
        skin_ids = children_of(gid, skins)
        if not skin_ids:
            return None
        cp_count = len(np.asarray(geoms[gid].find("Vertices").props[0])) // 3
        influences: List[List[Tuple[float, int]]] = \
            [[] for _ in range(cp_count)]
        found = False
        for sid in skin_ids:
            for cid in children_of(sid, clusters):
                c = clusters[cid]
                idx_n, w_n = c.find("Indexes"), c.find("Weights")
                t_n, tl_n = c.find("Transform"), c.find("TransformLink")
                bone_models = children_of(cid, models)
                if (idx_n is None or w_n is None or not bone_models
                        or not idx_n.props or not w_n.props):
                    continue
                # FBX matrices: row-vector convention, translation in
                # elements 12-14 → transpose into our column-vector form
                t = (np.asarray(t_n.props[0], np.float64).reshape(4, 4).T
                     if t_n is not None and t_n.props else np.eye(4))
                tl = (np.asarray(tl_n.props[0],
                                 np.float64).reshape(4, 4).T
                      if tl_n is not None and tl_n.props else np.eye(4))
                # offset (mesh→bone bind) = TransformLink⁻¹ · Transform
                # (≙ aiBone::mOffsetMatrix)
                offset = np.linalg.inv(tl) @ t
                bone = builder.add_bone(f"{path.stem}:cluster{cid}",
                                        ensure_node(bone_models[0]), offset)
                for cp, w in zip(np.asarray(idx_n.props[0], np.int64),
                                 np.asarray(w_n.props[0], np.float64)):
                    if 0 <= cp < cp_count and w > 0:
                        influences[int(cp)].append((float(w), bone))
                        found = True
        if not found:
            return None
        bidx = np.zeros((cp_count, 4), np.int32)
        bw = np.zeros((cp_count, 4), np.float32)
        for cp, infl in enumerate(influences):
            for k, (w, bone) in enumerate(
                    sorted(infl, reverse=True)[:4]):
                bidx[cp, k] = bone
                bw[cp, k] = w
        return bidx, bw

    imported = 0
    for model_id, model in models.items():
        geo_ids = children_of(model_id, geoms)
        if not geo_ids:
            continue
        mat_ids = children_of(model_id, materials)
        meshes = []
        for gid in geo_ids:
            geo = geoms[gid]
            vnode = geo.find("Vertices")
            inode = geo.find("PolygonVertexIndex")
            if vnode is None or inode is None or not vnode.props:
                continue
            verts = np.asarray(vnode.props[0], np.float64).reshape(-1, 3)
            pvi = np.asarray(inode.props[0], np.int64)

            # fan-triangulate: polygon ends at negative index (~x)
            corners: List[int] = []       # indices into pvi
            tri_polys: List[int] = []     # polygon ordinal per triangle
            poly_start = 0
            poly_ord = 0
            for i, v in enumerate(pvi):
                if v < 0:
                    for k in range(poly_start + 1, i):
                        corners.extend((poly_start, k, k + 1))
                        tri_polys.append(poly_ord)
                    poly_start = i + 1
                    poly_ord += 1
            tri_corners = np.asarray(corners, np.int64)
            tri_poly = np.asarray(tri_polys, np.int64)
            if len(tri_corners) == 0:
                continue
            vert_ids = np.where(pvi < 0, -pvi - 1, pvi)[tri_corners]
            pos = verts[vert_ids].astype(np.float32)

            nrm = _layer_attr(geo, "LayerElementNormal", "Normals",
                              "NormalsIndex", pvi, tri_corners, 3)
            if nrm is None:
                p0 = pos[0::3]
                fn = np.cross(pos[1::3] - p0, pos[2::3] - p0)
                ln = np.linalg.norm(fn, axis=-1, keepdims=True)
                fn = fn / np.maximum(ln, 1e-20)
                nrm = np.repeat(fn, 3, axis=0).astype(np.float32)
            uv = _layer_attr(geo, "LayerElementUV", "UV", "UVIndex",
                             pvi, tri_corners, 2)
            if uv is None:
                uv = np.zeros((len(pos), 2), np.float32)
            else:
                uv = np.stack([uv[:, 0], 1.0 - uv[:, 1]], axis=-1)

            # per-polygon material assignment (LayerElementMaterial
            # ByPolygon): split the geometry per material so a
            # multi-material mesh doesn't render wholly with its first
            # material; AllSame / absent keeps the single-material path
            tri_matidx = np.zeros(len(tri_poly), np.int64)
            mat_layer = geo.find("LayerElementMaterial")
            if mat_layer is not None and len(mat_ids) > 1:
                mapping_node = mat_layer.find("MappingInformationType")
                marr_node = mat_layer.find("Materials")
                if (mapping_node is not None and marr_node is not None
                        and mapping_node.props
                        and str(mapping_node.props[0]) == "ByPolygon"
                        and len(marr_node.props)):
                    marr = np.asarray(marr_node.props[0], np.int64)
                    if len(marr):
                        tri_matidx = np.clip(marr, 0, len(mat_ids) - 1)[
                            np.clip(tri_poly, 0, len(marr) - 1)]
            mat_groups = np.unique(tri_matidx)
            skin = skin_weights(gid)
            for gmat in mat_groups:
                csel = np.repeat(tri_matidx == gmat, 3)
                gpos = pos[csel]
                guv = uv[csel].astype(np.float32)
                gnrm = nrm[csel].astype(np.float32)
                mat_id = (mat_ids[int(gmat)] if int(gmat) < len(mat_ids)
                          else (mat_ids[0] if mat_ids else None))
                mid = build_material(mat_id)
                if skin is not None:
                    from pt_torch.scene.builder import _make_tangents
                    bidx, bw = skin
                    tan, bit = _make_tangents(gnrm)
                    gvids = vert_ids[csel]
                    vbase = builder.add_animated_vertices(
                        gpos, guv, gnrm, tan, bit,
                        bidx[gvids], bw[gvids])
                    ibase = builder.add_animated_indices(
                        np.arange(len(gpos), dtype=np.uint32))
                    g = builder.add_geometry(Geometry(
                        vbase, len(gpos), ibase, len(gpos), is_opaque=True,
                        is_animated=True))
                else:
                    vbase = builder.add_vertices(gpos, guv, gnrm)
                    ibase = builder.add_indices(
                        np.arange(len(gpos), dtype=np.uint32))
                    g = builder.add_geometry(Geometry(
                        vbase, len(gpos), ibase, len(gpos), is_opaque=True))
                meshes.append(MeshInfo(g, mid))
        if meshes:
            builder.add_model_instance(builder.add_model(meshes),
                                       ensure_node(model_id))
            imported += 1

    _import_animations(builder, path, models, curve_nodes, curves,
                       op_links, node_of_model, ensure_node)
    if imported == 0:
        raise ValueError(f"no mesh models in {path}")


_KTIME_PER_SEC = 46186158000.0    # FBX KTime ticks per second


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (w, x, y, z)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.asarray([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                           (m[0, 2] - m[2, 0]) / s,
                           (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def _import_animations(builder, path, models, curve_nodes, curves,
                       op_links, node_of_model, ensure_node) -> None:
    """AnimationCurveNode/AnimationCurve → Animation clips (≙ assimp's
    FBX animation import): per-channel KeyTime/KeyValueFloat curves are
    resampled on the union of key times; euler XYZ rotation keys (with
    PreRotation composed) convert to quaternions for the slerp channel."""
    from pt_torch.scene.graph import Animation, AnimationNode, KeySequence

    # curve-node → model property ("Lcl Translation"/"Lcl Rotation"/
    # "Lcl Scaling"); curve → curve-node channel ("d|X"/"d|Y"/"d|Z")
    cn_target: Dict[int, Tuple[int, str]] = {}
    cn_channels: Dict[int, Dict[str, int]] = {}
    for child, parent, prop in op_links:
        if child in curve_nodes and parent in models:
            cn_target[child] = (parent, prop)
        elif child in curves and parent in curve_nodes:
            cn_channels.setdefault(parent, {})[prop] = child

    by_model: Dict[int, Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]]] = {}
    max_t = 0.0
    for cn_id, (model_id, prop) in cn_target.items():
        if prop not in ("Lcl Translation", "Lcl Rotation", "Lcl Scaling"):
            continue
        chans = {}
        for ch_name, cv_id in cn_channels.get(cn_id, {}).items():
            cv = curves[cv_id]
            kt, kv = cv.find("KeyTime"), cv.find("KeyValueFloat")
            if kt is None or kv is None or not kt.props or not kv.props:
                continue
            times = np.asarray(kt.props[0], np.float64) / _KTIME_PER_SEC
            vals = np.asarray(kv.props[0], np.float64)
            if len(times) and len(vals):
                chans[ch_name[-1].upper()] = (times, vals[:len(times)])
                max_t = max(max_t, float(times[-1]))
        if chans:
            by_model.setdefault(model_id, {})[prop] = chans

    if not by_model:
        return

    nodes = []
    for model_id, channels in by_model.items():
        p70 = _p70(models[model_id])
        defaults = {
            "Lcl Translation": np.asarray(
                p70.get("Lcl Translation", [0, 0, 0])[:3], np.float64),
            "Lcl Rotation": np.asarray(
                p70.get("Lcl Rotation", [0, 0, 0])[:3], np.float64),
            "Lcl Scaling": np.asarray(
                p70.get("Lcl Scaling", [1, 1, 1])[:3], np.float64),
        }
        pre = p70.get("PreRotation")

        def vec_track(prop: str) -> Tuple[np.ndarray, np.ndarray]:
            chans = channels.get(prop, {})
            if not chans:
                return (np.asarray([0.0]), defaults[prop][None, :].copy())
            union = np.unique(np.concatenate(
                [t for t, _ in chans.values()]))
            out = np.tile(defaults[prop], (len(union), 1))
            for k, axis in enumerate("XYZ"):
                if axis in chans:
                    t, v = chans[axis]
                    out[:, k] = np.interp(union, t, v)
            return union, out

        pt_t, pt_v = vec_track("Lcl Translation")
        rt_t, rt_e = vec_track("Lcl Rotation")
        sc_t, sc_v = vec_track("Lcl Scaling")
        quats = []
        for e in rt_e:
            rot = _rot_xyz(e)
            if pre is not None:
                rot = _rot_xyz(pre[:3]) @ rot
            quats.append(_mat_to_quat(rot))
        nodes.append(AnimationNode(
            scene_node_index=ensure_node(model_id),
            positions=KeySequence(pt_t, pt_v),
            rotations=KeySequence(rt_t, np.asarray(quats),
                                  is_rotation=True),
            scales=KeySequence(sc_t, sc_v)))

    builder.add_animation(Animation(
        nodes=nodes, ticks_per_second=1.0, duration=max(max_t, 1e-6),
        name=f"{path.stem}:take"))
