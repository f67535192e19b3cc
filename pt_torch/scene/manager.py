"""Scene registry + async loading.

Port of `pt.scene.manager` (≙ the reference's SceneManager,
SceneManager.{h,cpp}): named scene groups mapping to loaders, a combined
loader merging several component files plus a skybox and per-scene flags,
path-validated file descriptions, async loading on a worker thread with
keep-previous-scene-on-failure semantics (SceneManager.cpp:120-157), and
the built-in boot catalog (SceneManager.cpp:100-105 boots "Test
Scenes"/"Default") followed, as in `pt`, by the Khronos sample directories
under the configured Scenes directory and the curated catalog under the
Assets directory.
"""

from __future__ import annotations

import logging
import pathlib
import threading
from typing import Callable, Dict, List, Optional

from pt_torch.core.config import Config
from pt_torch.core.stats import Timer
from pt_torch.scene.builder import Scene, SceneBuilder
from pt_torch.scene.types import Skybox, SkyboxKind, TextureType


class SceneLoader:
    """Abstract loader (≙ SceneLoader, SceneManager.h:17-30)."""

    def load(self, builder: SceneBuilder) -> None:
        raise NotImplementedError


class CustomSceneLoader(SceneLoader):
    """Wraps a procedural build function (≙ CustomSceneLoader template)."""

    def __init__(self, fn: Callable[[SceneBuilder], None]):
        self._fn = fn

    def load(self, builder: SceneBuilder) -> None:
        self._fn(builder)


class CombinedSceneLoader(SceneLoader):
    """Merges multiple component files + optional skybox + per-scene flags
    (≙ CombinedSceneLoader, SceneManager.cpp:47-64 — used for e.g. Intel
    Sponza main+curtains+ivy). Files import by suffix: .obj, .fbx, else
    glTF."""

    def __init__(self, paths: List[pathlib.Path],
                 skybox_path: Optional[pathlib.Path] = None,
                 texture_mapping: Optional[Dict[TextureType, TextureType]] = None,
                 dx_normals: bool = False,
                 default_camera=None):
        self.paths = [pathlib.Path(p) for p in paths]
        self.skybox_path = skybox_path
        self.texture_mapping = texture_mapping
        self.dx_normals = dx_normals
        self.default_camera = default_camera

    def load(self, builder: SceneBuilder) -> None:
        for path in self.paths:
            with Timer("File Import"):
                if path.suffix.lower() == ".obj":
                    from pt_torch.scene.obj import import_obj
                    import_obj(builder, path)
                elif path.suffix.lower() == ".fbx":
                    from pt_torch.scene.fbx import import_fbx
                    import_fbx(builder, path)
                else:
                    from pt_torch.scene.gltf import import_gltf
                    import_gltf(builder, path, self.texture_mapping)
        if self.dx_normals:
            builder.texture_mapping["dx_normals"] = True
        if self.skybox_path is not None:
            from pt_torch.scene.textures import load_texture_pixels
            from pt_torch.scene.types import TextureInfo
            px = load_texture_pixels(TextureInfo(
                name=str(self.skybox_path), type=TextureType.COLOR,
                path=str(self.skybox_path)))
            if px is not None:
                builder.set_skybox(Skybox(kind=SkyboxKind.EQUIRECT,
                                          image=px[..., :3]))
        if self.default_camera is not None:
            builder.add_camera(self.default_camera)


class SceneDescription:
    """Validated file-based scene description (≙ SceneDescription::ToLoader,
    SceneManager.cpp:66-94)."""

    def __init__(self, name: str, paths: List, skybox: Optional[str] = None,
                 texture_mapping=None, dx_normals: bool = False):
        self.name = name
        self.paths = paths
        self.skybox = skybox
        self.texture_mapping = texture_mapping
        self.dx_normals = dx_normals

    def to_loader(self) -> Optional[CombinedSceneLoader]:
        """The loader, or None if a component file is missing (a missing
        skybox is dropped)."""
        paths = [pathlib.Path(p) for p in self.paths]
        missing = [p for p in paths if not p.is_file()]
        if missing:
            return None
        sky = pathlib.Path(self.skybox) if self.skybox else None
        if sky is not None and not sky.is_file():
            sky = None
        return CombinedSceneLoader(paths, sky, self.texture_mapping,
                                   self.dx_normals)


class SceneManager:
    """Groups → named loaders; async activation (≙ SceneManager static API).
    `config` gives the Scenes and Assets directories (`Config()`, which
    has none, without one)."""

    def __init__(self, config: Optional[Config] = None):
        self.config = config or Config()
        self.groups: Dict[str, Dict[str, SceneLoader]] = {}
        self.active_scene: Optional[Scene] = None
        self.active_name: str = ""
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._on_loaded: List[Callable[[Scene], None]] = []
        self._register_builtin()

    def _register_builtin(self) -> None:
        from pt_torch.scene import examples
        group = self.groups.setdefault("Test Scenes", {})
        group["Default"] = CustomSceneLoader(examples.create_default_scene)
        group["MetallicRoughness Cubes"] = CustomSceneLoader(
            examples.create_metallic_roughness_cubes_scene)
        group["Roughness Test Cubes"] = CustomSceneLoader(
            examples.create_roughness_test_scene)
        group["Heightfield"] = CustomSceneLoader(
            examples.create_heightfield_scene)
        group["Reuse Mesh"] = CustomSceneLoader(
            examples.create_reuse_mesh_scene)

        def _courtyard(builder):
            from pt_torch.scene.standin import create_courtyard_scene
            create_courtyard_scene(builder)
        group["Courtyard"] = CustomSceneLoader(_courtyard)

        def _courtyard_flythrough(builder):
            from pt_torch.scene.standin import \
                create_courtyard_flythrough_scene
            create_courtyard_flythrough_scene(builder)
        group["Courtyard Flythrough"] = CustomSceneLoader(_courtyard_flythrough)
        self.discover_khronos_scenes()
        from pt_torch.scene.catalog import add_high_quality_scenes
        add_high_quality_scenes(self)

    def discover_khronos_scenes(self) -> None:
        """Scan the configured scenes directory for glTF sample directories
        (≙ AddKhronosScenes, ExampleScenes.cpp:39-69)."""
        root = self.config.scenes_path
        if root is None or not pathlib.Path(root).is_dir():
            return
        for entry in sorted(pathlib.Path(root).iterdir()):
            gltfs = (list(entry.glob("glTF/*.gltf")) + list(entry.glob("*.gltf"))
                     + list(entry.glob("*.glb"))) if entry.is_dir() else []
            if gltfs:
                loader = SceneDescription(entry.name, [gltfs[0]]).to_loader()
                if loader:
                    # the group is made only for a usable scene, so an
                    # asset directory with none lists no empty group
                    self.groups.setdefault("Khronos Scenes",
                                           {})[entry.name] = loader

    def register(self, group: str, name: str, loader: SceneLoader) -> None:
        self.groups.setdefault(group, {})[name] = loader

    def on_scene_loaded(self, callback: Callable[[Scene], None]) -> None:
        self._on_loaded.append(callback)

    def set_active_scene(self, group: str, name: str,
                         blocking: bool = False) -> None:
        """Load + activate on a worker thread; failures keep the previous
        scene (≙ SetActiveScene, SceneManager.cpp:120-157)."""
        loader = self.groups[group][name]

        def work() -> None:
            try:
                with Timer("Scene Load"):
                    builder = SceneBuilder(name)
                    loader.load(builder)
                    scene = builder.create_scene()
            except Exception as exc:     # keep previous scene on failure
                logging.getLogger("pt_torch").error(
                    "scene load %s/%s failed: %s", group, name, exc)
                return
            with self._lock:
                self.active_scene = scene
                self.active_name = name
            for cb in self._on_loaded:
                cb(scene)

        self.wait()
        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    def get_active_scene(self) -> Optional[Scene]:
        with self._lock:
            return self.active_scene
