"""Runtime configuration of the port: the knobs its modules read.

A copy of the fields of `pt.core.config.Config` that the ported modules
use, with `pt`'s defaults. Callers create a `Config` and pass it; there is
no process-wide instance.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # --- rendering (the run loop's samples-per-frame controller) ---
    max_samples_per_frame: int = 64          # ≙ Config::MaxSamplesPerFrame
    min_refresh_rate: float = 60.0           # ≙ Config::MinRefreshRate
    # --- memory / streaming budgets ---
    texture_memory_budget: int = 2 << 30     # bytes the texture pool may take
    max_texture_size: int = 4096             # downscale textures larger than this
