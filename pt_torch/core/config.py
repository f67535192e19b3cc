"""Runtime configuration of the port: the knobs its modules read.

A copy of the fields of `pt.core.config.Config` that the ported modules
use, with `pt`'s defaults. Callers create a `Config` and pass it; there is
no process-wide instance.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # --- memory / streaming budgets ---
    texture_memory_budget: int = 2 << 30     # bytes the texture pool may take
    max_texture_size: int = 4096             # downscale textures larger than this
