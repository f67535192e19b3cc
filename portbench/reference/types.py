"""Plain reference: a frozen copy of pt_torch/scene/types.py,
which the port may change without moving the yardstick.

Scene data model: materials, lights, geometry, texture slots.

Counterpart of the reference's shared C++/GLSL structs
(Shaders/ShaderTypes.incl:1-170) and the Scene SoA types (Scene.h:63-157).
Host-side these are plain dataclasses; `pt.scene.flatten` packs them into
device SoA arrays. Field names/semantics (including the MaterialId packing
`index << 8 | type`, ShaderTypes.incl:155-158, and the fixed default-texture
indices 0..8 with scene textures from 9) are preserved for API parity.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple, Union

import numpy as np

# --- constants (≙ ShaderTypes.incl:18-33) ---
DEFAULT_COLOR_TEXTURE = 0
DEFAULT_NORMAL_TEXTURE = 1
DEFAULT_ROUGHNESS_TEXTURE = 2
DEFAULT_METALLIC_TEXTURE = 3
DEFAULT_EMISSIVE_TEXTURE = 4
DEFAULT_SPECULAR_TEXTURE = 5
DEFAULT_GLOSSINESS_TEXTURE = 6
DEFAULT_SHININESS_TEXTURE = 7
PLACEHOLDER_TEXTURE = 8
SCENE_TEXTURE_OFFSET = 9

MAX_TEXTURE_COUNT = 1024
MAX_LIGHT_COUNT = 64
MAX_BONES_PER_VERTEX = 4
MAX_BONES = 64 * 1024 // (3 * 4 * 4)
MAX_MATERIAL_COUNT = 1 << 24


class MaterialType(enum.IntEnum):
    """≙ MaterialTypeMetallicRoughness/SpecularGlossiness/Phong."""
    METALLIC_ROUGHNESS = 0
    SPECULAR_GLOSSINESS = 1
    PHONG = 2


class TextureType(enum.IntEnum):
    """Semantic texture slots (≙ TextureType in Scene.h; order matches the
    default-texture indices above)."""
    COLOR = 0
    NORMAL = 1
    ROUGHNESS = 2
    METALLIC = 3
    EMISSIVE = 4
    SPECULAR = 5
    GLOSSINESS = 6
    SHININESS = 7


def create_material_id(material_index: int, material_type: MaterialType) -> int:
    """≙ CreateMaterialId (ShaderTypes.incl:155-158)."""
    return (material_index << 8) | int(material_type)


@dataclasses.dataclass
class MetallicRoughnessMaterial:
    """≙ MetallicRoughnessMaterial (ShaderTypes.incl:61-80)."""
    emissive_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emissive_intensity: float = 0.0
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    roughness: float = 1.0
    metalness: float = 0.0
    ior: float = 1.5
    transmission: float = 0.0
    attenuation_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    attenuation_distance: float = 1e32
    emissive_idx: int = DEFAULT_EMISSIVE_TEXTURE
    color_idx: int = DEFAULT_COLOR_TEXTURE
    normal_idx: int = DEFAULT_NORMAL_TEXTURE
    roughness_idx: int = DEFAULT_ROUGHNESS_TEXTURE
    metallic_idx: int = DEFAULT_METALLIC_TEXTURE


@dataclasses.dataclass
class SpecularGlossinessMaterial:
    """≙ SpecularGlossinessMaterial (ShaderTypes.incl:82-99)."""
    emissive_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emissive_intensity: float = 0.0
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    specular: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    glossiness: float = 0.0
    attenuation_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    attenuation_distance: float = 1e32
    ior: float = 1.5
    transmission: float = 0.0
    emissive_idx: int = DEFAULT_EMISSIVE_TEXTURE
    color_idx: int = DEFAULT_COLOR_TEXTURE
    normal_idx: int = DEFAULT_NORMAL_TEXTURE
    specular_idx: int = DEFAULT_SPECULAR_TEXTURE
    glossiness_idx: int = DEFAULT_GLOSSINESS_TEXTURE


@dataclasses.dataclass
class PhongMaterial:
    """≙ PhongMaterial (ShaderTypes.incl:101-118)."""
    emissive_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emissive_intensity: float = 0.0
    color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    specular: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    shininess: float = 0.0
    attenuation_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    attenuation_distance: float = 1e32
    ior: float = 1.5
    transmission: float = 0.0
    emissive_idx: int = DEFAULT_EMISSIVE_TEXTURE
    color_idx: int = DEFAULT_COLOR_TEXTURE
    normal_idx: int = DEFAULT_NORMAL_TEXTURE
    specular_idx: int = DEFAULT_SPECULAR_TEXTURE
    shininess_idx: int = DEFAULT_SHININESS_TEXTURE


AnyMaterial = Union[MetallicRoughnessMaterial, SpecularGlossinessMaterial, PhongMaterial]

MATERIAL_TYPE_OF = {
    MetallicRoughnessMaterial: MaterialType.METALLIC_ROUGHNESS,
    SpecularGlossinessMaterial: MaterialType.SPECULAR_GLOSSINESS,
    PhongMaterial: MaterialType.PHONG,
}


@dataclasses.dataclass
class DirectionalLight:
    """≙ DirectionalLight (ShaderTypes.incl:120-126)."""
    color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    direction: Tuple[float, float, float] = (0.0, -1.0, 0.0)


@dataclasses.dataclass
class PointLight:
    """≙ PointLight (ShaderTypes.incl:128-138)."""
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    attenuation_constant: float = 1.0
    attenuation_linear: float = 0.0
    attenuation_quadratic: float = 0.0


@dataclasses.dataclass
class Geometry:
    """One mesh's index/vertex range in the flattened arrays
    (≙ Geometry, Scene.h:63-71)."""
    vertex_offset: int
    vertex_count: int
    index_offset: int
    index_count: int
    is_opaque: bool = True
    is_animated: bool = False


@dataclasses.dataclass
class MeshInfo:
    """One mesh inside a Model: geometry + material + local transform
    (≙ MeshInfo used by SceneBuilder::CreateModel, Scene.cpp:337-355)."""
    geometry_index: int
    material_id: int               # packed (index << 8 | type)
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))


@dataclasses.dataclass
class Model:
    """≙ Model (Scene.h:96-100)."""
    meshes: List[MeshInfo]


@dataclasses.dataclass
class ModelInstance:
    """≙ ModelInstance (Scene.h:102-107): a model placed at a scene node."""
    model_index: int
    scene_node_index: int


class SkyboxKind(enum.IntEnum):
    """≙ Scene skybox variant (Scene.h:127-157) and the miss-shader spec
    constant (miss.rmiss:16-39)."""
    CLEAR = 0       # constant color (0.08, 0.09, 0.10)
    EQUIRECT = 1    # 2D lat-long texture
    CUBE = 2        # cubemap


@dataclasses.dataclass
class Skybox:
    kind: SkyboxKind = SkyboxKind.CLEAR
    # CLEAR: constant color; EQUIRECT: (H,W,3) float; CUBE: (6,H,W,3) float
    color: Tuple[float, float, float] = (0.08, 0.09, 0.10)
    image: Optional[np.ndarray] = None


@dataclasses.dataclass
class TextureInfo:
    """Texture metadata + lazily-loadable source
    (≙ TextureInfo, Scene.h:20-46: name, type, source variant file/memory)."""
    name: str
    type: TextureType
    # source: path on disk, raw encoded bytes, or a decoded numpy array
    path: Optional[str] = None
    data: Optional[bytes] = None
    pixels: Optional[np.ndarray] = None     # (H, W, 4) uint8 or float32
    width: int = 0
    height: int = 0
    is_srgb: bool = False                   # color/emissive are sRGB-encoded


@dataclasses.dataclass
class Bone:
    """≙ Bone (Scene.h:73-80): node index + inverse-bind (offset) matrix."""
    node_index: int
    offset: np.ndarray   # 4x4 inverse bind matrix
