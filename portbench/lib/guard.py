"""The check that nothing a run loaded is JAX or the JAX package `pt`.

Module names are compared by their top-level name as a whole word (the part
before the first dot), so `pt_torch` passes and `pt.render` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "pt")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded module names (or `names`) whose top-level name is
    forbidden, sorted."""
    names = sys.modules.keys() if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
