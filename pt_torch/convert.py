"""State of the JAX package, as numpy arrays, → the port's containers.

In a path tracer the scene and accel arrays play the part of weights: to
hold the port against `pt` on identical state, `pt`'s DeviceScene,
DeviceTextures, PacketBVH (SAH or Morton build), BF8BVH, BF8Instanced,
BF8V6, ThreadedBVH and AlphaSplit are read out as mappings of field name →
numpy array (or Python scalar for static metadata) and converted here; so
are the settings that select what runs: PathTracingSettings (with its
backend), DebugFlags and DebugRenderMode. An imported scene (`Scene`:
geometry, materials, textures, lights, cameras, skins, animation keys and
the graph) is read out the same way by `scene_state`, which takes either
package's objects. Arrays keep their bits: bf16 texel rows arrive as numpy
`bfloat16` (or raw uint16) and are reinterpreted, and the f32 page id rows
are copied as raw bits. This module imports neither JAX nor `pt`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping

import numpy as np
import torch

from pt_torch import default_device
from pt_torch.accel.archive import BF8V6
from pt_torch.accel.bvh8 import BF8BVH, PacketBVH, bf8_depth
from pt_torch.accel.instanced import BF8Instanced
from pt_torch.accel.lbvh import ThreadedBVH
from pt_torch.render.debug import DebugFlags, DebugRenderMode
from pt_torch.render.integrator import AlphaSplit, PathTracingSettings
from pt_torch.render.textures import DeviceTextures
from pt_torch.scene.flatten import DeviceScene


def to_tensor(a, device=None) -> torch.Tensor:
    """numpy array → tensor on `device`, bit for bit. A bfloat16 array
    (numpy has no native bf16; JAX hands out ml_dtypes' type) is
    reinterpreted from its 16-bit pattern."""
    dev = default_device(device)
    a = np.array(a, copy=True, order="C")     # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _convert(cls, fields: Mapping, device):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields or fields[f.name] is None:
            continue
        v = fields[f.name]
        kw[f.name] = to_tensor(v, device) if isinstance(v, np.ndarray) else v
    return cls(**kw)


def device_scene(fields: Mapping, device=None) -> DeviceScene:
    """`pt.scene.flatten.DeviceScene` fields → DeviceScene."""
    return _convert(DeviceScene, fields, device)


def device_textures(fields: Mapping, device=None) -> DeviceTextures:
    """`pt.render.textures.DeviceTextures` fields → DeviceTextures."""
    return _convert(DeviceTextures, fields, device)


def packet_bvh(fields: Mapping, device=None) -> PacketBVH:
    """`pt.accel.pallas_bvh.PacketBVH` fields → PacketBVH."""
    return _convert(PacketBVH, fields, device)


def bf8_bvh(fields: Mapping, device=None) -> BF8BVH:
    """`pt.accel.pallas_bvh.BF8BVH` fields → BF8BVH, with its tree depth
    worked out from the child entries."""
    out = _convert(BF8BVH, fields, device)
    out.depth = bf8_depth(np.asarray(fields["c_ent"]))
    return out


def bf8_instanced(fields: Mapping, device=None) -> BF8Instanced:
    """`pt.accel.instanced.BF8Instanced` fields → BF8Instanced, with its
    tree depth worked out from the child entries."""
    out = _convert(BF8Instanced, fields, device)
    out.depth = bf8_depth(np.asarray(fields["c_ent"]))
    return out


def threaded_bvh(fields: Mapping, device=None) -> ThreadedBVH:
    """`pt.accel.lbvh.ThreadedBVH` fields → ThreadedBVH (the threaded LBVH
    of `backend="bvh"`)."""
    return _convert(ThreadedBVH, fields, device)


def alpha_split(bvh_opaque, sel_opaque, bvh_alpha, sel_alpha,
                device=None) -> AlphaSplit:
    """`pt.render.integrator.AlphaSplit` → AlphaSplit: the two subset trees
    as already converted structures (`bf8_bvh` / `packet_bvh` /
    `bf8_instanced`), the
    selections as numpy arrays of global triangle ids. `pt`'s `tri_opaque` /
    `tri_alpha` rows serve its brute backend only and are not carried: the
    port's brute split (`make_alpha_split_brute`) keeps its rows in its
    `BruteTriangles`."""
    return AlphaSplit(bvh_opaque, to_tensor(np.asarray(sel_opaque, np.int32),
                                            device),
                      bvh_alpha, to_tensor(np.asarray(sel_alpha, np.int32),
                                           device))


def bf8_v6(fields: Mapping, device=None) -> BF8V6:
    """`pt.accel.pallas_bvh_archive.BF8V6` fields → BF8V6, with its tree
    depth worked out from the child entries."""
    out = _convert(BF8V6, fields, device)
    out.depth = bf8_depth(np.asarray(fields["c_ent"]))
    return out


def path_tracing_settings(fields: Mapping) -> PathTracingSettings:
    """`pt.render.integrator.PathTracingSettings` fields (as
    `dataclasses.asdict` gives them) → PathTracingSettings, every field
    carried: the backend, the LBVH leaf size and the two sorts included."""
    return PathTracingSettings(**fields)


def debug_flags(fields: Mapping) -> DebugFlags:
    """`pt.render.debug.DebugFlags` fields → DebugFlags."""
    return DebugFlags(**fields)


def debug_mode(value) -> DebugRenderMode:
    """A `pt.render.debug.DebugRenderMode` (or its int value) →
    DebugRenderMode."""
    return DebugRenderMode(int(value))


def scene_state(obj, _depth: int = 0):
    """A scene object of either package (a `Scene` and everything it
    holds) → plain values: numpy arrays as they are, Python scalars,
    strings and bytes, lists and dicts of those, an enum as its class
    name and member name, and any other object as a dict of its
    attributes under "__class__" and their names, private ones included.
    Callables (an animated camera's transform provider) are left out. Two
    scenes that compute the same give equal states, bit for bit."""
    if _depth > 32:
        raise RecursionError("scene_state: nesting deeper than 32")
    if isinstance(obj, enum.Enum):
        return f"{type(obj).__name__}.{obj.name}"
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (list, tuple)):
        return [scene_state(v, _depth + 1) for v in obj]
    if isinstance(obj, dict):
        return {scene_state(k, _depth + 1): scene_state(v, _depth + 1)
                for k, v in obj.items()}
    fields = vars(obj) if hasattr(obj, "__dict__") else {
        name: getattr(obj, name) for name in getattr(obj, "__slots__", ())}
    out = {"__class__": type(obj).__name__}
    for name, value in fields.items():
        if not callable(value) or isinstance(value, (np.ndarray, enum.Enum)):
            out[name] = scene_state(value, _depth + 1)
    return out
