"""Render-step time of two checkouts of the port, in turns, on the card.

Times `Renderer.render()` steps of three cells of `chip_smoke.py`: the
static Heightfield (n=224), the 64-instance scene with instancing "auto"
(the shared-BLAS structure) and the Default scene, each at 512², 5
bounces, 4 spp. Each turn is a fresh process that imports one checkout's
`pt_torch` (through PYTHONPATH) and runs this file as its worker, with this
checkout's `chip_smoke.py` scene builders, so both arms render the same
scenes. A worker builds the kernels, then per cell takes one warm step and
times `--blocks` blocks of 3 steps (host clock around a synchronised block,
as `chip_smoke.py`'s phase 4 does).

The turns go other, this, this with the stat board stubbed out (`Stats`'
methods made no-ops), the same again, this, other. Prints one JSON line a
turn (ms per step of each block, the launches of one step, the checkout
whose `pt_torch` ran, the card's name and power limit) and a last JSON
line: per cell and arm the median of its blocks, and each arm's median
over the other checkout's.

    python -m pt_torch.benches.step_ab OTHER_CHECKOUT [--blocks 4]

Needs the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[2]   # this checkout's root
CELLS = ("heightfield", "instanced64_shared", "default")
ARMS = ("other", "this", "this_stub", "this_stub", "this", "other")


def _chip_smoke():
    """This checkout's `chip_smoke.py` as a module (its scene builders
    import `pt_torch` when called, so they build with the worker's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub_stats() -> None:
    """Make every write to the stat board a no-op."""
    from pt_torch.core.stats import Stats
    for name in ("add_stat", "add_measurement", "add_max_measurement"):
        setattr(Stats, name, classmethod(lambda cls, *a: None))


def worker(blocks: int, stub: bool) -> dict:
    import threading
    import time

    import torch
    import pt_torch
    from pt_torch.accel import kernels, native
    if not torch.cuda.is_available():
        raise SystemExit("step_ab: needs a CUDA device")
    if stub:
        _stub_stats()
    cs = _chip_smoke()
    th = threading.Thread(target=native._load)
    th.start()
    kernels.build_kernels()
    th.join()
    from pt_torch.scene.examples import make_default_scene
    scenes = {
        "heightfield": lambda: 224,
        "instanced64_shared": lambda: cs.build_instanced_scene(
            cs.port_namespace(), cs.N_INST),
        "default": make_default_scene,
    }
    out = {"checkout": str(pathlib.Path(pt_torch.__file__).parents[1]),
           "stub_stats": stub, "device": torch.cuda.get_device_name(0),
           "power": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "cells": {}}
    for cell in CELLS:
        r = cs._renderer(scenes[cell](), 512, 4, 5, "cuda")
        r.render()                                   # accel build, warm
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        r.render()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.launches.items() if v}
        ms = []
        for _ in range(blocks):
            t0 = time.perf_counter()
            for _ in range(3):
                r.render()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) / 3 * 1e3)
        out["cells"][cell] = {"ms_blocks": ms, "launches": launches,
                              "accel": type(r.accel.bvh).__name__}
        del r
        torch.cuda.empty_cache()
    return out


def main(other: str, blocks: int, emit=print) -> dict:
    other = str(pathlib.Path(other).resolve())
    runs = {arm: {c: [] for c in CELLS} for arm in set(ARMS)}
    for arm in ARMS:
        env = dict(os.environ, PYTHONPATH=other if arm == "other"
                   else str(HERE))
        cmd = [sys.executable, __file__, "--worker", "--blocks",
               str(blocks)] + (["--stub-stats"] if arm == "this_stub" else [])
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=900)
        if res.returncode:
            raise SystemExit(f"step_ab: the {arm} turn failed "
                             f"({res.returncode}):\n{res.stderr[-4000:]}")
        turn = json.loads(res.stdout.strip().splitlines()[-1])
        want = other if arm == "other" else str(HERE)
        if turn["checkout"] != want:
            raise SystemExit(f"step_ab: the {arm} turn imported "
                             f"{turn['checkout']}, not {want}")
        emit(json.dumps({"arm": arm, **turn}))
        for c in CELLS:
            runs[arm][c] += turn["cells"][c]["ms_blocks"]
    med = {arm: {c: statistics.median(v) for c, v in cells.items()}
           for arm, cells in runs.items()}
    summary = {"median_ms": med,
               "ratio_to_other": {arm: {c: med[arm][c] / med["other"][c]
                                        for c in CELLS}
                                  for arm in ("this", "this_stub")}}
    emit(json.dumps(summary))
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--stub-stats", action="store_true",
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker(a.blocks, a.stub_stats)), flush=True)
    elif a.other is None:
        ap.error("name the other checkout")
    else:
        main(a.other, a.blocks)
