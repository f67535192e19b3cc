"""Scene registry + async loading.

Port of `pt.scene.manager` (≙ the reference's SceneManager,
SceneManager.{h,cpp}): named scene groups mapping to loaders, async loading
on a worker thread with keep-previous-scene-on-failure semantics
(SceneManager.cpp:120-157), and the built-in boot catalog
(SceneManager.cpp:100-105 boots "Test Scenes"/"Default").

The file loaders (glTF/OBJ/FBX import, `CombinedSceneLoader`,
`SceneDescription`, the Khronos sample directories and the curated
catalog) come with queue 1, item 6 of the port. With no Scenes or Assets
directory `pt` registers none of them either.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from pt_torch.core.stats import Timer
from pt_torch.scene.builder import Scene, SceneBuilder


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


class SceneManager:
    """Groups → named loaders; async activation (≙ SceneManager static API)."""

    def __init__(self):
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
