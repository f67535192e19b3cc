"""Scene inputs: recorded once from a configuration's generator, cached,
replayed onto a scene builder.

A configuration's generator builds its scene through a builder and a
namespace of scene classes, as an importer would. `generate` runs it
against a `Recorder`, which forwards every call to the port's
`SceneBuilder` (for the indices it returns) and keeps the call with its
arguments: numbers, arrays, and records of the namespace's classes. The
calls are the scene inputs. They are cached on disk under a key made of the
configuration's name, a hash of its file and its parameters, so only the
first run in a checkout pays for the generator. `replay` makes the calls
again on any builder with any namespace of classes of the same names: the
port's, or the plain reference's own copies.
"""

from __future__ import annotations

import enum
import hashlib
import json
import os
import pathlib
import shutil
from typing import Any, Callable, Dict, List

import numpy as np

CACHE_ROOT = pathlib.Path(__file__).resolve().parents[1] / ".cache" / "scenes"

# the scene classes a generator may construct through its namespace
CLASSES = ("Geometry", "MeshInfo", "MetallicRoughnessMaterial", "TextureInfo",
           "PointLight", "DirectionalLight", "Skybox", "InputCamera",
           "Animation", "AnimationNode", "KeySequence")
ENUMS = ("TextureType", "SkyboxKind")


class Rec:
    """A constructor call of a scene class, kept as its name and arguments."""

    def __init__(self, cls: str, args: tuple, kwargs: dict):
        self.cls, self.args, self.kwargs = cls, args, kwargs


class EnumRec:
    """A member of a scene enum, kept by names."""

    def __init__(self, enum_name: str, member: str):
        self.enum_name, self.member = enum_name, member

    @property
    def name(self) -> str:
        """The member's name, as an enum member's `name`."""
        return self.member


class _RecEnum:
    def __init__(self, name: str, real: type):
        self._name, self._real = name, real

    def __getattr__(self, member: str) -> EnumRec:
        getattr(self._real, member)          # an unknown member raises
        return EnumRec(self._name, member)


class RecordingNamespace:
    """What a generator sees as `ns`: each class makes a `Rec`, each enum
    member an `EnumRec`. `real` is the namespace replayed onto while
    recording, which checks the names."""

    def __init__(self, real):
        for name in CLASSES:
            setattr(self, name, self._maker(name))
        for name in ENUMS:
            setattr(self, name, _RecEnum(name, getattr(real, name)))

    @staticmethod
    def _maker(name: str) -> Callable[..., Rec]:
        return lambda *args, **kwargs: Rec(name, args, kwargs)


def realize(value, ns):
    """`value` with every record turned into an object of `ns`'s class."""
    if isinstance(value, Rec):
        return getattr(ns, value.cls)(*realize(value.args, ns),
                                      **realize(value.kwargs, ns))
    if isinstance(value, EnumRec):
        return getattr(getattr(ns, value.enum_name), value.member)
    if isinstance(value, tuple):
        return tuple(realize(v, ns) for v in value)
    if isinstance(value, list):
        return [realize(v, ns) for v in value]
    if isinstance(value, dict):
        return {k: realize(v, ns) for k, v in value.items()}
    return value


class Recorder:
    """A builder that keeps every call and makes it on `target` too, so
    that it returns what the target returns."""

    def __init__(self, target, ns):
        self._target, self._ns = target, ns
        self.calls: List[tuple] = []

    def __getattr__(self, method: str):
        real = getattr(self._target, method)
        if not callable(real):
            raise AttributeError(f"a generator may only call the builder, "
                                 f"not read {method!r}")

        def call(*args, **kwargs):
            self.calls.append((method, args, kwargs))
            return real(*realize(args, self._ns), **realize(kwargs, self._ns))
        return call


def replay(calls, builder, ns) -> None:
    """Make the recorded calls on `builder`, records realized in `ns`."""
    for method, args, kwargs in calls:
        getattr(builder, method)(*realize(args, ns), **realize(kwargs, ns))


# -- on disk: calls.json plus one .npy file per array ------------------------

def _encode(value, arrays: list):
    if isinstance(value, Rec):
        return {"rec": value.cls, "args": _encode(list(value.args), arrays),
                "kwargs": _encode(value.kwargs, arrays)}
    if isinstance(value, EnumRec):
        return {"enum": value.enum_name, "member": value.member}
    if isinstance(value, (np.ndarray, np.generic)):
        arrays.append(np.asarray(value))
        return {"array": len(arrays) - 1, "scalar": isinstance(value,
                                                                np.generic)}
    if isinstance(value, tuple):
        return {"tuple": [_encode(v, arrays) for v in value]}
    if isinstance(value, list):
        return [_encode(v, arrays) for v in value]
    if isinstance(value, dict):
        return {"dict": {k: _encode(v, arrays) for k, v in value.items()}}
    if isinstance(value, enum.Enum):
        raise TypeError(f"enum {value!r} given directly: use the namespace's")
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    raise TypeError(f"cannot record a {type(value).__name__}")


def _decode(value, arrays):
    if isinstance(value, list):
        return [_decode(v, arrays) for v in value]
    if not isinstance(value, dict):
        return value
    if "rec" in value:
        return Rec(value["rec"], tuple(_decode(value["args"], arrays)),
                   _decode(value["kwargs"], arrays))
    if "enum" in value:
        return EnumRec(value["enum"], value["member"])
    if "array" in value:
        a = arrays(value["array"])
        return a[()] if value["scalar"] else a
    if "tuple" in value:
        return tuple(_decode(v, arrays) for v in value["tuple"])
    return {k: _decode(v, arrays) for k, v in value["dict"].items()}


def save_calls(calls, folder: pathlib.Path) -> None:
    """Write the calls into `folder`, made whole before it is renamed in,
    so a run cut off while writing leaves no half cache."""
    tmp = folder.with_name(folder.name + f".part{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    arrays: list = []
    doc = [[m, _encode(list(a), arrays), _encode(k, arrays)]
           for m, a, k in calls]
    for i, a in enumerate(arrays):
        np.save(tmp / f"a{i}.npy", a, allow_pickle=False)
    (tmp / "calls.json").write_text(json.dumps(doc))
    shutil.rmtree(folder, ignore_errors=True)
    os.replace(tmp, folder)


def load_calls(folder: pathlib.Path):
    doc = json.loads((folder / "calls.json").read_text())
    arrays = lambda i: np.load(folder / f"a{i}.npy",  # noqa: E731
                               allow_pickle=False)
    return [(m, tuple(_decode(a, arrays)), _decode(k, arrays))
            for m, a, k in doc]


def cache_key(config_name: str, config_file: pathlib.Path,
              params: Dict[str, Any]) -> str:
    h = hashlib.sha256(config_file.read_bytes())
    h.update(json.dumps(params, sort_keys=True).encode())
    return f"{config_name}-{h.hexdigest()[:16]}"


def scene_inputs(config, params: Dict[str, Any], port_ns,
                 root: pathlib.Path = CACHE_ROOT):
    """The recorded calls of `config`'s generator at `params`: from the
    cache, or generated (against the port's builder and classes, `port_ns`)
    and cached. Returns (calls, whether they came from the cache)."""
    folder = root / cache_key(config.NAME, pathlib.Path(config.__file__),
                              params)
    if (folder / "calls.json").exists():
        return load_calls(folder), True
    rec = Recorder(port_ns.SceneBuilder(config.NAME), port_ns)
    config.generate(rec, RecordingNamespace(port_ns), **params)
    save_calls(rec.calls, folder)
    return load_calls(folder), False
