"""The arithmetic that decides `correct`: what the window produced against
the plain reference, at the timed sizes. Each traffic kind's `check`
(`portbench/kinds/<kind>.py`) names its numbers and computes them with
these; each number's limit is in `portbench/limits/<cell>.json`, and a
number at or below its limit passes.

A pixel agrees with the reference when every channel of its mean radiance
is within `PIXEL_ATOL + PIXEL_RTOL * |reference|` of the reference's.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List

import numpy as np

LIMITS_DIR = pathlib.Path(__file__).resolve().parents[1] / "limits"
# a pixel agrees when every channel of its mean is within this of the
# reference's: f32 traversal arithmetic (the kernels' Woop test against
# Moller-Trumbore here) moves a radiance by ~1e-6 relative, a path that
# takes another branch moves it by far more
PIXEL_RTOL = 1e-3
PIXEL_ATOL = 1e-4


def load_limits(cell: str,
                root: pathlib.Path = LIMITS_DIR) -> Dict[str, float]:
    path = root / f"{cell}.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def mismatch_pct(port: np.ndarray, ref: np.ndarray) -> float:
    """Percent of pixels (rows) that disagree in some channel."""
    bad = np.any(np.abs(port - ref) > PIXEL_ATOL + PIXEL_RTOL * np.abs(ref),
                 axis=-1)
    return float(100.0 * bad.mean()) if len(bad) else 100.0


def per_sample_pct(share_pct: float, samples: int) -> float:
    """The percent of samples that would leave `share_pct` percent of the
    pixels disagreeing after `samples` samples each, were each sample to
    take another branch on its own: 100 x (1 - (1 - share) ^ (1 / N))."""
    share = min(max(share_pct / 100.0, 0.0), 1.0)
    return float(100.0 * (1.0 - (1.0 - share) ** (1.0 / max(samples, 1))))


def verdict(numbers: Dict[str, float],
            limits: Dict[str, float]) -> List[tuple]:
    """(name, value, limit, passed) for each compared number; a number with
    no limit, or a limit with no number, fails."""
    names = sorted(set(numbers) | set(limits))
    out = []
    for name in names:
        value, limit = numbers.get(name), limits.get(name)
        ok = (value is not None and limit is not None
              and np.isfinite(value) and value <= limit)
        out.append((name, value, limit, bool(ok)))
    return out


