"""Runtime configuration of the port: the knobs its modules read.

A copy of the fields of `pt.core.config.Config` that the ported modules
use, with `pt`'s defaults, and `Config.create`, which reads `-A/-S` and
else finds the Assets and Scenes directories in the working directory
(≙ Config::Create, Core/Config.cpp:138-242). `pt` also walks up to three
parents and reads `-C/-L`; the port looks nowhere above the working
directory, and has no cache or logs directory, since none of its modules
writes one. Callers create a `Config` and pass it; there is no
process-wide instance.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
from typing import Optional


def _find_folder(name: str) -> Optional[pathlib.Path]:
    """The directory `name` in the working directory, or None
    (≙ FindFolder, Core/Config.cpp:99-122, without its walk up)."""
    candidate = pathlib.Path.cwd().resolve() / name
    return candidate if candidate.is_dir() else None


@dataclasses.dataclass
class Config:
    # --- paths (≙ AssetsPath/ScenesPath) ---
    assets_path: Optional[pathlib.Path] = None
    scenes_path: Optional[pathlib.Path] = None
    # --- rendering (the run loop's samples-per-frame controller) ---
    max_samples_per_frame: int = 64          # ≙ Config::MaxSamplesPerFrame
    min_refresh_rate: float = 60.0           # ≙ Config::MinRefreshRate
    # --- memory / streaming budgets ---
    texture_memory_budget: int = 2 << 30     # bytes the texture pool may take
    max_texture_size: int = 4096             # downscale textures larger than this
    # threads of the parallel texture decode (≙ TextureUploader threads)
    loader_thread_count: int = max(1, (os.cpu_count() or 2) // 2)

    @staticmethod
    def create(argv: Optional[list] = None) -> "Config":
        """A Config from command-line flags and directory discovery: -A/-S
        override the Assets/Scenes directories found in the working
        directory; other arguments are ignored. ValueError if an assets or
        scenes path is not a directory."""
        parser = argparse.ArgumentParser(prog="pt_torch", add_help=True,
                                         description="path tracer on "
                                         "PyTorch and CUDA")
        parser.add_argument("-A", "--assets", type=pathlib.Path, default=None,
                            help="assets directory")
        parser.add_argument("-S", "--scenes", type=pathlib.Path, default=None,
                            help="scenes directory")
        args, _ = parser.parse_known_args(argv)

        cfg = Config(
            assets_path=args.assets or _find_folder("Assets"),
            scenes_path=args.scenes or _find_folder("Scenes"),
        )
        for name, path in (("assets", cfg.assets_path),
                           ("scenes", cfg.scenes_path)):
            if path is not None and not path.is_dir():
                raise ValueError(f"{name} path {path} is not a directory")
        return cfg
