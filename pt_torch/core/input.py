"""Headless input shim.

Port of `pt.core.input` (≙ the reference's `Core/Input.{h,cpp}`: static
GLFW key/mouse polling with UI-focus suppression, Input.cpp:31-45). There
is no window: programmatic drivers (tests, scripted camera paths, the live
viewer's browser events) push state here, and the fly camera polls it
through the same is_key_pressed/mouse API.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple


class Input:
    _lock = threading.Lock()
    _keys: Dict[str, bool] = {}
    _mouse_buttons: Dict[int, bool] = {}
    _mouse_pos: Tuple[float, float] = (0.0, 0.0)
    _mouse_delta: Tuple[float, float] = (0.0, 0.0)
    _cursor_locked = False
    _key_release_callback: Optional[Callable[[str], None]] = None
    _ui_focused = False      # ≙ input suppressed while the UI has focus

    @classmethod
    def set_key(cls, key: str, pressed: bool) -> None:
        with cls._lock:
            was = cls._keys.get(key, False)
            cls._keys[key] = pressed
        if was and not pressed and cls._key_release_callback:
            cls._key_release_callback(key)

    @classmethod
    def is_key_pressed(cls, key: str) -> bool:
        with cls._lock:
            return not cls._ui_focused and cls._keys.get(key, False)

    @classmethod
    def set_mouse_button(cls, button: int, pressed: bool) -> None:
        with cls._lock:
            cls._mouse_buttons[button] = pressed

    @classmethod
    def is_mouse_button_pressed(cls, button: int) -> bool:
        with cls._lock:
            return (not cls._ui_focused
                    and cls._mouse_buttons.get(button, False))

    @classmethod
    def set_mouse_position(cls, x: float, y: float) -> None:
        with cls._lock:
            cls._mouse_pos = (x, y)

    @classmethod
    def add_mouse_delta(cls, dx: float, dy: float) -> None:
        """Accumulate relative mouse motion (pointer-lock style); the fly
        camera consumes it once a frame (≙ the cursor-delta polling in
        InputCamera::OnUpdate, Core/Camera.cpp:120-137)."""
        with cls._lock:
            cls._mouse_delta = (cls._mouse_delta[0] + dx,
                                cls._mouse_delta[1] + dy)

    @classmethod
    def consume_mouse_delta(cls) -> Tuple[float, float]:
        with cls._lock:
            d = cls._mouse_delta
            cls._mouse_delta = (0.0, 0.0)
            return d

    @classmethod
    def get_mouse_position(cls) -> Tuple[float, float]:
        with cls._lock:
            return cls._mouse_pos

    @classmethod
    def lock_cursor(cls) -> None:
        cls._cursor_locked = True

    @classmethod
    def unlock_cursor(cls) -> None:
        cls._cursor_locked = False

    @classmethod
    def set_ui_focused(cls, focused: bool) -> None:
        with cls._lock:
            cls._ui_focused = focused

    @classmethod
    def set_key_release_callback(
            cls, cb: Optional[Callable[[str], None]]) -> None:
        cls._key_release_callback = cb
