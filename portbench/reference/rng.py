"""Plain reference: a frozen copy of pt_torch/render/rng.py,
which the port may change without moving the yardstick.

Counter-free per-ray RNG, bit-exact with `pt.render.rng`.

The jenkinsHash/xorshift/uintToFloat chain of the reference's
Shaders/common.glsl:133-165. PyTorch has no shifts on `torch.uint32` on the
CPU, so the uint32 state is carried in int64 tensors holding values in
[0, 2^32) and every step masks with 0xFFFFFFFF.

All functions are functional: state in, (state, value) out; state is an
int64 tensor of any shape (one lane per ray).
"""

from __future__ import annotations

from typing import Tuple

import torch

_MASK = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(torch.int64) & _MASK


def jenkins_hash(x) -> torch.Tensor:
    """≙ jenkinsHash (common.glsl:134-142)."""
    x = _u32(x)
    x = (x + (x << 10)) & _MASK
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & _MASK
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & _MASK
    return x


def init_rng(pixel_x, pixel_y, width, frame) -> torch.Tensor:
    """≙ initRng (common.glsl:144-148): state = hash(pix.x + pix.y*width ^ hash(frame))."""
    px = _u32(pixel_x)
    lin = (px + _u32(pixel_y) * (int(width) & _MASK)) & _MASK
    if not isinstance(frame, torch.Tensor):
        frame = torch.full((), int(frame) & _MASK, dtype=torch.int64,
                           device=px.device)
    seed = lin ^ jenkins_hash(frame)
    return jenkins_hash(seed)


def uint_to_float(x: torch.Tensor) -> torch.Tensor:
    """Map uint32 → [0,1): bit-splice into the float32 mantissa
    (≙ uintToFloat, common.glsl:150-153)."""
    bits = 0x3F800000 | (_u32(x) >> 9)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def xorshift(state: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step (≙ xorshift, common.glsl:155-160)."""
    state = state ^ ((state << 13) & _MASK)
    state = state ^ (state >> 17)
    state = state ^ ((state << 5) & _MASK)
    return state


def rand(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw one float in [0,1) per lane (≙ rand, common.glsl:162-165)."""
    state = xorshift(state)
    return state, uint_to_float(state)


def rand2(state: torch.Tensor):
    state, a = rand(state)
    state, b = rand(state)
    return state, a, b


def rand3(state: torch.Tensor):
    state, a = rand(state)
    state, b = rand(state)
    state, c = rand(state)
    return state, a, b, c
