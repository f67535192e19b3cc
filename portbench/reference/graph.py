"""Plain reference: a frozen copy of pt_torch/scene/graph.py,
which the port may change without moving the yardstick.

Scene graph + keyframe animation.

Counterpart of the reference's `SceneGraph.{h,cpp}`: a flat pre-order node
array with parent links, per-node local transforms, keyframed TRS animation
channels (linear position/scale, slerp rotation, looping over the clip
duration — SceneGraph.h:19-78, SceneGraph.cpp:8-34), and pre-order transform
propagation with absolute-transform override flags used for bones
(SceneGraph.cpp:36-60).

Convention note: the reference stores node transforms *transposed*
(row-vector `vec4 * mat` math, SceneGraph.cpp:31-33). This build stores
standard column-vector 4x4 matrices; composition `current = parent @ local`
is mathematically identical to the reference's transposed
`local' * parent'`. Evaluation is host-side numpy (node counts are tiny);
the results feed device uploads (instance transforms, bone palettes).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


def trs_matrix(position: np.ndarray, rotation_quat: np.ndarray,
               scale: np.ndarray) -> np.ndarray:
    """Compose translate(position) @ rotate(quat) @ scale(scale).
    Quaternion layout is (w, x, y, z)."""
    w, x, y, z = rotation_quat
    r = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = r * np.asarray(scale, dtype=np.float64)[None, :]
    m[:3, 3] = position
    return m


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical linear interpolation, shortest arc (≙ glm::slerp)."""
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / s


@dataclasses.dataclass
class KeySequence:
    """Keyframe channel (≙ AnimationNode::Sequence, SceneGraph.h:22-39).
    `ticks` strictly increasing; evaluation clamps outside the range and
    interpolates inside (linear for vec3, slerp for quat)."""
    ticks: np.ndarray          # (N,)
    values: np.ndarray         # (N, 3) or (N, 4) quaternions (w,x,y,z)
    is_rotation: bool = False

    def sample(self, tick: float) -> np.ndarray:
        ticks, values = self.ticks, self.values
        if tick <= ticks[0]:
            return values[0]
        if tick >= ticks[-1]:
            return values[-1]
        i = int(np.searchsorted(ticks, tick, side="right")) - 1
        ratio = (tick - ticks[i]) / (ticks[i + 1] - ticks[i])
        if self.is_rotation:
            return _slerp(values[i], values[i + 1], float(ratio))
        return values[i] * (1 - ratio) + values[i + 1] * ratio


@dataclasses.dataclass
class AnimationNode:
    """TRS channels targeting one scene node (≙ AnimationNode)."""
    scene_node_index: int
    positions: KeySequence
    rotations: KeySequence
    scales: KeySequence


@dataclasses.dataclass
class Animation:
    """One clip: node channels + timing (≙ Animation, SceneGraph.h:70-78).
    `update` advances current_tick by dt*ticks_per_second, wrapping at
    duration, and writes fresh local transforms into `nodes`."""
    nodes: List[AnimationNode]
    ticks_per_second: float
    duration: float
    current_tick: float = 0.0
    name: str = ""

    def update(self, dt: float, local_transforms: np.ndarray) -> None:
        self.current_tick += dt * self.ticks_per_second
        # single fmod, not a subtraction loop: a subtraction loop spins
        # forever at duration == 0 and runs tick/duration iterations for
        # tiny clips
        if self.duration > 0.0:
            self.current_tick %= self.duration
        else:
            self.current_tick = 0.0
        for node in self.nodes:
            p = node.positions.sample(self.current_tick)
            r = node.rotations.sample(self.current_tick)
            s = node.scales.sample(self.current_tick)
            local_transforms[node.scene_node_index] = trs_matrix(p, r, s)


class SceneGraph:
    """Flat pre-order node hierarchy (≙ SceneGraph, SceneGraph.h:80-106).

    parents[i] < i for all i > 0 (pre-order requirement asserted like the
    reference's CONFIG_ASSERTS path). `is_relative[i]` False means the node's
    transform is absolute (bone override, SceneGraph.cpp:50-53).
    """

    def __init__(self, parents: np.ndarray, local_transforms: np.ndarray,
                 is_relative: Optional[np.ndarray] = None,
                 animations: Optional[List[Animation]] = None):
        self.parents = np.asarray(parents, dtype=np.int64)
        n = len(self.parents)
        self.local = np.asarray(local_transforms, dtype=np.float64).reshape(n, 4, 4).copy()
        self.current = self.local.copy()
        self.is_relative = (np.ones(n, dtype=bool) if is_relative is None
                            else np.asarray(is_relative, dtype=bool))
        self.animations = animations or []
        if n:
            assert self.parents[0] == 0
            assert np.all(self.parents[1:] < np.arange(1, n)), \
                "scene nodes must be in pre-order"
        self._update_transforms()

    def __len__(self) -> int:
        return len(self.parents)

    @property
    def has_animations(self) -> bool:
        return bool(self.animations)

    def update(self, dt: float) -> None:
        for anim in self.animations:
            anim.update(dt, self.local)
        self._update_transforms()

    def _update_transforms(self) -> None:
        """Pre-order propagation: current[i] = current[parent] @ local[i]
        (≙ UpdateTransforms, SceneGraph.cpp:36-60, transposed convention)."""
        if not len(self.parents):
            return
        self.current[0] = self.local[0]
        for i in range(1, len(self.parents)):
            if self.is_relative[i]:
                self.current[i] = self.current[self.parents[i]] @ self.local[i]
            else:
                self.current[i] = self.local[i]
