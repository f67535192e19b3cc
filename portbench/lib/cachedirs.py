"""Fixed folders of the checkout for every build and kernel cache a run may
fill. The port's kernels build into its own `pt_torch/.build/`."""

from __future__ import annotations

import os
import pathlib

CACHE_ROOT = pathlib.Path(__file__).resolve().parents[1] / ".cache"


def cache_environment(root: pathlib.Path = CACHE_ROOT) -> None:
    os.environ["TRITON_CACHE_DIR"] = str(root / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "torch_extensions")
    # a library that would load JAX by itself is kept from doing so
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
