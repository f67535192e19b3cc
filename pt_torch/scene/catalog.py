"""Curated high-quality scene catalog.

Port of `pt.scene.catalog` (≙ the reference's AddHighQualityScenes
(ExampleScenes.cpp:82-236)): the 14 curated scene descriptions (Intel
Sponza 3-component + HDR skybox, UE4 Sun Temple, Amazon Bistro ×3, Beeple
Zero Day ×2, NVIDIA Emerald Square ×2, eMirage Barcelona Pavilion ×3,
Beeple Transparent Machines ×2) with their per-scene texture-mapping and
DX-normal flags. Descriptions whose files are missing are skipped with a
warning (≙ AddSceneByDescription, ExampleScenes.cpp:71-80).

The NVIDIA ORCA collections mislabel their roughness/metalness textures as
specular — the remap below reproduces the reference's
NVIDIAOrcaTextureMapping (rationale comment at ExampleScenes.cpp:97-110).

FBX-sourced scenes (Sun Temple, Bistro, Zero Day, Emerald Square) load
through the native binary/ASCII FBX importer (`pt_torch/scene/fbx.py`); when
the FBX itself is absent, a pre-converted `.gltf`/`.glb` sibling is
probed as a fallback.
"""

from __future__ import annotations

import logging
import pathlib
from typing import Dict, Optional

from pt_torch.scene.manager import SceneDescription, SceneManager
from pt_torch.scene.types import TextureType

log = logging.getLogger("pt_torch")

# ≙ NVIDIAOrcaTextureMapping (ExampleScenes.cpp:112-117): the "specular"
# texture is really roughness/metalness data
NVIDIA_ORCA_TEXTURE_MAPPING: Dict[TextureType, TextureType] = {
    TextureType.ROUGHNESS: TextureType.SPECULAR,
    TextureType.METALLIC: TextureType.SPECULAR,
}


def _hq_descriptions(base: pathlib.Path) -> Dict[str, SceneDescription]:
    d = {}
    d["Intel Sponza"] = SceneDescription(
        "Intel Sponza",
        [base / "IntelSponzaMain/main_sponza/NewSponza_Main_glTF_003.gltf",
         base / "IntelSponzaCurtains/pkg_a_curtains/NewSponza_Curtains_glTF.gltf",
         base / "IntelSponzaIvy/pkg_b_ivy/NewSponza_IvyGrowth_glTF.gltf"],
        skybox=str(base / "IntelSponzaMain/main_sponza/textures/kloppenheim_05_4k.hdr"),
        dx_normals=True)
    d["UE4 Sun Temple"] = SceneDescription(
        "UE4 Sun Temple",
        [base / "UE4SunTemple/SunTemple_v4/SunTemple/SunTemple.fbx"],
        skybox=str(base / "UE4SunTemple/SunTemple_v4/SunTemple/SunTemple_Skybox.hdr"),
        texture_mapping=NVIDIA_ORCA_TEXTURE_MAPPING, dx_normals=True)
    bistro = base / "AmazonBistro/Bistro_v5_2"
    for name, fbx in (("Amazon Bistro Exterior", "BistroExterior.fbx"),
                      ("Amazon Bistro Interior", "BistroInterior.fbx"),
                      ("Amazon Bistro Interior Wine", "BistroInterior_Wine.fbx")):
        d[name] = SceneDescription(
            name, [bistro / fbx],
            skybox=str(bistro / "san_giuseppe_bridge_4k.hdr"),
            texture_mapping=NVIDIA_ORCA_TEXTURE_MAPPING, dx_normals=True)
    for name, sub in (("Beeple Zero Day Mesure One", "MEASURE_ONE"),
                      ("Beeple Zero Day Mesure Seven", "MEASURE_SEVEN")):
        d[name] = SceneDescription(
            name, [base / "BeepleZeroDay" / sub / f"{sub}.fbx"],
            texture_mapping=NVIDIA_ORCA_TEXTURE_MAPPING, dx_normals=True)
    emerald = base / "NVIDIAEmeraldSquare/EmeraldSquare_v4_1"
    d["NVIDIA Emerald Square Day"] = SceneDescription(
        "NVIDIA Emerald Square Day", [emerald / "EmeraldSquare_Day.fbx"],
        skybox=str(emerald / "symmetrical_garden_4k.hdr"),
        texture_mapping=NVIDIA_ORCA_TEXTURE_MAPPING, dx_normals=True)
    d["NVIDIA Emerald Square Night"] = SceneDescription(
        "NVIDIA Emerald Square Night", [emerald / "EmeraldSquare_Dusk.fbx"],
        skybox=str(emerald / "night_sky.hdr"),
        texture_mapping=NVIDIA_ORCA_TEXTURE_MAPPING, dx_normals=True)
    pavilion = base / "EMirageBarcelonaPavilion"
    for name, f in (("eMirage Barcelona Pavilion Day", "barcelona_pavilion_day.gltf"),
                    ("eMirage Barcelona Pavilion Sunset", "barcelona_pavilion_sunset.gltf"),
                    ("eMirage Barcelona Pavilion Night", "barcelona_pavilion_night.gltf")):
        d[name] = SceneDescription(name, [pavilion / f])
    d["Beeple Transparent Machines"] = SceneDescription(
        "Beeple Transparent Machines",
        [base / "BeepleTransparentMachines/no_anim.gltf"])
    d["Beeple Transparent Machines Animated"] = SceneDescription(
        "Beeple Transparent Machines Animated",
        [base / "BeepleTransparentMachines/anim.gltf"])
    return d


def _with_gltf_fallback(desc: SceneDescription) -> SceneDescription:
    """Probe .gltf/.glb siblings for FBX components (this build imports
    glTF natively; FBX requires pre-conversion)."""
    paths = []
    for p in desc.paths:
        p = pathlib.Path(p)
        if p.suffix.lower() == ".fbx" and not p.is_file():
            for alt in (p.with_suffix(".gltf"), p.with_suffix(".glb")):
                if alt.is_file():
                    p = alt
                    break
        paths.append(p)
    desc.paths = paths
    return desc


def add_high_quality_scenes(manager: SceneManager,
                            assets_path: Optional[pathlib.Path] = None) -> int:
    """Register every HQ scene whose files exist under
    `<assets>/scenes`, where `<assets>` is `assets_path`, else the
    manager's `config.assets_path`, else `Assets`; returns the count."""
    base = pathlib.Path(assets_path or (manager.config.assets_path
                                        or "Assets")) / "scenes"
    added = 0
    for name, desc in _hq_descriptions(base).items():
        loader = _with_gltf_fallback(desc).to_loader()
        if loader is None:
            log.debug("HQ scene %s not installed", name)
            continue
        manager.register("High Quality Scenes", name, loader)
        added += 1
    if added == 0:
        log.info("no High Quality scenes installed under %s", base)
    return added
