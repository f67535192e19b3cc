"""The benchmark's command: one cell, one seed, one window, one result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`: each compared number with its limit. The same numbers
end standard error. Without a card, or with fewer cards than the cell asks
for, or with JAX or the JAX package `pt` loaded after the window, it prints
no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import List, Optional

from portbench.lib import guard
from portbench.lib import spec as bench_spec
from portbench.lib import trace as tr

EXIT_NO_DEVICE = 2
EXIT_FORBIDDEN = 3


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _metric_values(spec, cell: str, kind: str, record) -> dict:
    """Every metric of `kind` the cell reports, read by its own file; a
    reader that finds nothing to read leaves its metric out."""
    out = {}
    for m in bench_spec.metrics_of(spec, cell, kind):
        value = bench_spec.load_metric(m["name"]).read(record)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(args: argparse.Namespace, device: str = "cuda",
            overrides: Optional[dict] = None, faults=None,
            t_process: Optional[float] = None, spec=None) -> dict:
    """Run the cell and check it; the result object, without printing.
    `faults` (tests only) is a context manager entered around the window."""
    import contextlib

    import torch

    from portbench.lib.drive import Cell
    from portbench.reference.compare import load_limits, verdict
    spec = spec or bench_spec.load_spec()
    cell = Cell(spec, args.workload, args.seed, args.seconds,
                bool(args.trace), device=device, overrides=overrides,
                t_process=t_process)
    attempted = failed = 0
    with faults() if faults else contextlib.nullcontext():
        record = cell.run()
    attempted = len(record.steps) or len(record.frames)
    t_check = time.perf_counter()
    numbers = cell.kind.check(cell, cell.outputs)
    print(f"portbench: setup {record.setup_s:.3f} s, window "
          f"{record.window_s:.3f} s, {attempted} steps, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = verdict(numbers, load_limits(args.workload))
    kind = "per_layer" if args.trace else "end_to_end"
    on_card = cell.device.type == "cuda"
    result = {
        "correct": all(ok for *_, ok in checks),
        "attempted": attempted,
        "failed": failed,
        "metrics": _metric_values(spec, args.workload, kind, record)
        if on_card else {},
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": int(cell.cell["chips"]),
            "memory_peak_bytes": record.peak_mem_bytes or 0,
        },
    }
    if args.trace and record.trace is not None and record.trace.window():
        w0, w1 = record.trace.window()
        busy = tr.busy_ns(record.trace.kernels + record.trace.copies, w0, w1)
        result["device"]["busy_s"] = busy / 1e9
        result["device"]["window_s"] = (w1 - w0) / 1e9
        result["breakdown"] = tr.breakdown(record.trace)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit, _ in checks}
    return result


def main(argv: List[str], t_process: float) -> int:
    args = parse(argv)
    bench_spec_doc = bench_spec.load_spec()
    cell = bench_spec.workload(bench_spec_doc, args.workload)
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), found "
              f"{found}", file=sys.stderr)
        return EXIT_NO_DEVICE
    result = execute(args, t_process=t_process, spec=bench_spec_doc)
    bad = guard.forbidden_modules()
    if bad:
        print("portbench: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


def entry(t_process: float) -> None:
    sys.exit(main(sys.argv[1:], t_process))
