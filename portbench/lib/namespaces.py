"""The two namespaces a configuration's recorded calls are replayed in: the
port's scene classes (the system under test) and the plain reference's own
copies. Both are imported when asked for, never when this module is."""

from __future__ import annotations

import types


def _namespace(builder_mod, types_mod, graph_mod, camera_mod):
    return types.SimpleNamespace(
        SceneBuilder=builder_mod.SceneBuilder,
        Geometry=types_mod.Geometry, MeshInfo=types_mod.MeshInfo,
        MetallicRoughnessMaterial=types_mod.MetallicRoughnessMaterial,
        TextureInfo=types_mod.TextureInfo, PointLight=types_mod.PointLight,
        DirectionalLight=types_mod.DirectionalLight, Skybox=types_mod.Skybox,
        TextureType=types_mod.TextureType, SkyboxKind=types_mod.SkyboxKind,
        InputCamera=camera_mod.InputCamera, Animation=graph_mod.Animation,
        AnimationNode=graph_mod.AnimationNode,
        KeySequence=graph_mod.KeySequence)


def port_namespace():
    """`pt_torch`'s SceneBuilder and scene classes."""
    from pt_torch.core import camera
    from pt_torch.scene import builder, graph
    from pt_torch.scene import types as scene_types
    return _namespace(builder, scene_types, graph, camera)


def reference_namespace():
    """The plain reference's copies of the same classes."""
    from portbench.reference import builder, camera, graph
    from portbench.reference import types as scene_types
    return _namespace(builder, scene_types, graph, camera)
