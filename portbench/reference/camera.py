"""Plain reference: a frozen copy of pt_torch/core/camera.py
(no input polling: a run gives the camera none),
which the port may change without moving the yardstick.

Cameras.

Counterpart of the reference's `Core/Camera.{h,cpp}`: an abstract camera
exposing inverse-view / inverse-projection matrices consumed by primary-ray
construction, a WASD fly camera, and a camera following an animated
scene-graph node. The reference compiles GLM with GLM_FORCE_LEFT_HANDED and
GLM_FORCE_DEPTH_ZERO_TO_ONE (Core/Camera.cpp:1-2); the matrix builders below
reproduce those conventions exactly so primary rays match
(Shaders/ray.glsl constructPrimaryRay uses ViewInverse/ProjInverse).

Matrices are host-side numpy; they are tiny per-frame uniforms.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def look_at_lh(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Left-handed look-at view matrix (column-vector convention)."""
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(up, f)
    s = s / np.linalg.norm(s)
    u = np.cross(f, s)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = -np.dot(f, eye)
    return m


def perspective_fov_lh_zo(fovy_rad: float, width: float, height: float,
                          near: float, far: float) -> np.ndarray:
    """Left-handed, zero-to-one-depth perspective projection."""
    h = math.cos(0.5 * fovy_rad) / math.sin(0.5 * fovy_rad)
    w = h * height / width
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = far / (far - near)
    m[3, 2] = 1.0
    m[2, 3] = -(far * near) / (far - near)
    return m


class Camera:
    """Base camera (≙ Camera, Core/Camera.h:8-45)."""

    def __init__(self, vertical_fov_deg: float, near_clip: float, far_clip: float,
                 position, direction, up=(0.0, -1.0, 0.0)):
        self.vertical_fov = float(vertical_fov_deg)
        self.near_clip = float(near_clip)
        self.far_clip = float(far_clip)
        self.position = np.asarray(position, dtype=np.float64)
        self.direction = np.asarray(direction, dtype=np.float64)
        self.up_direction = np.asarray(up, dtype=np.float64)
        self.width = 0
        self.height = 0
        self._inv_view = np.eye(4)
        self._inv_proj = np.eye(4)
        self._update_inv_view()

    def on_resize(self, width: int, height: int) -> None:
        if (self.width, self.height) == (width, height):
            return
        self.width, self.height = width, height
        self._inv_proj = np.linalg.inv(perspective_fov_lh_zo(
            math.radians(self.vertical_fov), width, height,
            self.near_clip, self.far_clip))

    @property
    def extent(self) -> Tuple[int, int]:
        return self.width, self.height

    @property
    def inv_view(self) -> np.ndarray:
        return self._inv_view

    @property
    def inv_proj(self) -> np.ndarray:
        assert self.width and self.height, "call on_resize first"
        return self._inv_proj

    def on_update(self, dt: float) -> bool:
        """Advance camera state; returns True when the view changed
        (callers reset progressive accumulation on True)."""
        return False

    def _update_inv_view(self) -> None:
        self._inv_view = np.linalg.inv(look_at_lh(
            self.position, self.position + self.direction, self.up_direction))


class InputCamera(Camera):
    """Fly camera with yaw/pitch state (≙ InputCamera, Core/Camera.h:47-73).

    The reference polls GLFW; here `on_update` polls the Input shim (the
    live viewer feeds it), and scripts drive move()/rotate() directly.
    Pitch clamps to ±89° exactly like the reference.
    """

    CAMERA_SPEED = 5.0
    MOUSE_SENSITIVITY = 0.05

    _input_disabled = False

    def __init__(self, vertical_fov_deg: float, near_clip: float, far_clip: float,
                 position, direction):
        super().__init__(vertical_fov_deg, near_clip, far_clip, position, direction,
                         up=(0.0, -1.0, 0.0))
        # faithful to the reference (Core/Camera.cpp:77-78) INCLUDING its
        # quirk: this is the NEGATION of the yaw rotate() reconstructs
        # from (atan2(z,x)), so for directions with z != 0 the first
        # mouse-look snaps to the z-mirrored view — the reference behaves
        # identically, so parity keeps it
        self._yaw = math.degrees(math.atan2(self.direction[0], self.direction[2])
                                 - math.pi / 2)
        self._pitch = math.degrees(math.asin(np.clip(self.direction[1], -1, 1)))

    @classmethod
    def disable_input(cls) -> None:
        cls._input_disabled = True

    @classmethod
    def enable_input(cls) -> None:
        cls._input_disabled = False

    def move(self, forward: float = 0.0, right: float = 0.0, up: float = 0.0,
             dt: float = 1.0 / 60.0) -> bool:
        if InputCamera._input_disabled:
            return False
        prev = self.position.copy()
        right_dir = np.cross(self.direction, self.up_direction)
        right_dir = right_dir / max(np.linalg.norm(right_dir), 1e-12)
        self.position = (self.position
                         + dt * self.CAMERA_SPEED * forward * self.direction
                         + dt * self.CAMERA_SPEED * right * right_dir
                         - dt * self.CAMERA_SPEED * up * self.up_direction)
        if not np.array_equal(prev, self.position):
            self._update_inv_view()
            return True
        return False

    def on_update(self, dt: float) -> bool:
        """A benchmark run gives the camera no input: nothing moves."""
        return False

    def rotate(self, dx: float, dy: float) -> bool:
        """Mouse-look: dx/dy in pixels scaled by MOUSE_SENSITIVITY."""
        if InputCamera._input_disabled or (dx == 0 and dy == 0):
            return False
        self._yaw += dx * self.MOUSE_SENSITIVITY
        self._pitch = float(np.clip(self._pitch - dy * self.MOUSE_SENSITIVITY, -89.0, 89.0))
        yaw, pitch = math.radians(self._yaw), math.radians(self._pitch)
        self.direction = np.array([
            math.cos(yaw) * math.cos(pitch),
            math.sin(pitch),
            math.sin(yaw) * math.cos(pitch)])
        self._update_inv_view()
        return True


