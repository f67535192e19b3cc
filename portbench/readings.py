"""Readings for the limits of `correct`: one cell set up once, then a short
window at each seed, each compared with the plain reference and with its
control (the reference in bfloat16 storage). One JSON line per seed.

    python3 portbench/readings.py --workload <cell> --seconds <s>
                                  --seeds 1,2,3 [--device cuda] [--control N]

The benchmark's own runs never run this; `portbench/tests/` holds it at a
size a test run can hold.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if sys.path and pathlib.Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))


def readings(cell_name: str, seeds, seconds: float, device: str = "cuda",
             overrides=None, out=sys.stdout, control=None):
    """(seed, program numbers, control numbers) for each seed; the control
    for the first `control` seeds only, where that is given."""
    from portbench.lib import spec as bench_spec
    from portbench.lib.drive import Cell
    spec = bench_spec.load_spec()
    cell = Cell(spec, cell_name, seeds[0], seconds, False, device=device,
                overrides=overrides)
    cache: dict = {}
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        record = cell.window(seed)
        t1 = time.perf_counter()
        program = cell.kind.check(cell, cell.outputs, cache=cache)
        row = dict(seed=seed, steps=len(record.steps) or len(record.frames),
                   window_s=record.window_s, program=program,
                   window_wall_s=t1 - t0)
        if control is None or i < control:
            row["control"] = cell.kind.check(cell, cell.outputs, lowp=True,
                                             cache=cache)
        row["check_s"] = time.perf_counter() - t1
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    from portbench.lib.cachedirs import cache_environment
    cache_environment()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--control", type=int, default=None,
                   help="read the control on the first N seeds only")
    a = p.parse_args()
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.seconds,
             a.device, control=a.control)
