"""Readings of the port's own spans and counters: a cell set up once, then a
traced window at each seed with the recorder of `pt_torch.core.stats` on
around it, read by the five quantities below. One JSON line per seed.

    python3 portbench/program_readings.py --workload <cell> --seconds <s>
                                          --seeds 1,2,3 [--device cuda]

The benchmark's own runs never run this: its `--trace 1` run does not turn
the recorder on. Each line holds the seed, the window's steps, `correct`
(the cell's check against its limits), the per-layer metrics the
benchmark's readers give for the same window (`harness`), and `program`:

- `live_lane_pct`: 100 x `closest_live` / `closest_lanes`;
- `alpha_pending_pct`: 100 x `alpha_pending` / `alpha_lanes`;
- `alpha_ms_per_sample`, `compact_ms_per_sample`: the summed device
  intervals of the `alpha` and the `compact` spans, per film-wide sample;
- `loop_idle_ms_per_sample`: the device-idle ms of the profiled sub-window
  (`idle_pct`'s gaps) whose gap starts inside a "Render" span's host
  interval, per profiled sample;

the first four over the window's "Render" steps outside the profiled
sub-window; and beside them the device ms per sample of every stage span,
of each bounce, the host ms per step of the spans outside the steps (the
image's `post` and `readback`, the rebuild), and the sums the consistency
checks compare: the steps' device ms and the profiled window's whole idle
per sample.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if sys.path and pathlib.Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

from portbench.lib import trace as tr  # noqa: E402
from portbench.lib.drive import Cell  # noqa: E402

STEP = "Render"
STAGES = ("raygen", "bounce", "trace", "shade", "nee", "roulette", "alpha",
          "compact", "observe", "accumulate")
OUTSIDE_STEPS = ("post", "readback", "Acceleration Structure Build")


class TracedCell(Cell):
    """A cell whose every window runs with the port's recorder on; the
    records of the last window are `program`."""

    program = None

    def window(self, seed: Optional[int] = None):
        from pt_torch.core import stats
        stats.start_trace(self.device)
        try:
            return super().window(seed)
        finally:
            self.program = stats.stop_trace()


def _interval(record):
    """The window's first step start and last step end (perf seconds)."""
    steps = record.steps or record.frames
    return steps[0][0], steps[-1][1]


def window_steps(record, program):
    """The "Render" spans of the window outside the profiled sub-window:
    their step ids and their count."""
    a, b = _interval(record)
    u0, u1 = program.perf_to_unix_ns(a), program.perf_to_unix_ns(b)
    win = record.trace.window() if record.trace is not None else None
    steps = [s for s in program.spans
             if s.name == STEP and s.end_ns is not None
             and u0 <= s.start_ns <= u1
             and not (win and s.end_ns >= win[0] and s.start_ns <= win[1])]
    return {s.step for s in steps}, len(steps)


def _pct(x, y):
    return 100.0 * x / y if y else None


def live_lane_pct(program, steps):
    return _pct(program.counter("closest_live", steps),
                program.counter("closest_lanes", steps))


def alpha_pending_pct(program, steps):
    return _pct(program.counter("alpha_pending", steps),
                program.counter("alpha_lanes", steps))


def device_ms_per_sample(program, name, steps, samples):
    return program.device_ms(name, steps) / samples if samples else None


def loop_idle_ms_per_sample(record, program):
    """`idle_pct`'s gaps that start inside a "Render" span's host
    interval, in ms per profiled sample."""
    if (record.trace is None or record.trace.window() is None
            or not record.profiled_samples):
        return None
    w0, w1 = record.trace.window()
    renders = [(s.start_ns, s.end_ns) for s in program.spans
               if s.name == STEP and s.end_ns is not None
               and s.end_ns >= w0 and s.start_ns <= w1]
    gaps = tr.idle_gaps(record.trace.kernels + record.trace.copies, w0, w1)
    idle = sum(e - s for s, e in gaps
               if any(a <= s <= b for a, b in renders))
    return idle / 1e6 / record.profiled_samples


def read(record, program, samples_per_step: int) -> dict:
    steps, n = window_steps(record, program)
    samples = n * samples_per_step
    out = {"steps_read": n,
           "live_lane_pct": live_lane_pct(program, steps),
           "alpha_pending_pct": alpha_pending_pct(program, steps),
           "alpha_ms_per_sample": device_ms_per_sample(program, "alpha",
                                                       steps, samples),
           "compact_ms_per_sample": device_ms_per_sample(
               program, "compact", steps, samples),
           "loop_idle_ms_per_sample": loop_idle_ms_per_sample(record,
                                                              program),
           "render_ms_per_sample": device_ms_per_sample(program, STEP,
                                                        steps, samples)}
    out["stage_ms_per_sample"] = {
        name: device_ms_per_sample(program, name, steps, samples)
        for name in STAGES}
    bounces: dict = {}
    for s in program.spans:
        if s.name == "bounce" and s.step in steps:
            bounces[s.index] = bounces.get(s.index, 0.0) + (s.device_ms
                                                            or 0.0)
    out["bounce_ms_per_sample"] = {k: v / samples for k, v
                                   in sorted(bounces.items())} \
        if samples else {}
    for name in ("closest_lanes", "closest_live", "shadow_live",
                 "alpha_lanes", "alpha_pending"):
        out[f"{name}_per_sample"] = (program.counter(name, steps) / samples
                                     if samples else None)
    # spans outside the steps, over the same stretch of the window
    a, b = _interval(record)
    u0, u1 = program.perf_to_unix_ns(a), program.perf_to_unix_ns(b)
    win = record.trace.window() if record.trace is not None else None
    for name in OUTSIDE_STEPS:
        ss = [s for s in program.spans if s.name == name
              and s.end_ns is not None and u0 <= s.start_ns <= u1
              and not (win and s.end_ns >= win[0] and s.start_ns <= win[1])]
        if ss and n:
            out[f"{name}_host_ms_per_step"] = sum(
                s.end_ns - s.start_ns for s in ss) / 1e6 / n
    if win is not None and record.profiled_samples:
        gaps = tr.idle_gaps(record.trace.kernels + record.trace.copies,
                            *win)
        out["idle_ms_per_profiled_sample"] = sum(
            e - s for s, e in gaps) / 1e6 / record.profiled_samples
    return out


def readings(cell_name: str, seeds, seconds: float, device: str = "cuda",
             overrides=None, out=sys.stdout):
    """One traced window a seed, its check and its readings; the rows."""
    from portbench.lib import spec as bench_spec
    from portbench.lib.main import _metric_values
    from portbench.reference.compare import load_limits, verdict
    spec = bench_spec.load_spec()
    cell = TracedCell(spec, cell_name, seeds[0], seconds, True,
                      device=device, overrides=overrides,
                      t_process=T_PROCESS)
    spp = int(cell.traffic.get("samples_per_step", 1))
    cache: dict = {}
    rows = []
    for seed in seeds:
        record = cell.window(seed)
        checks = verdict(cell.kind.check(cell, cell.outputs, cache=cache),
                         load_limits(cell_name))
        row = dict(seed=seed, steps=len(record.steps) or len(record.frames),
                   window_s=record.window_s,
                   correct=all(ok for *_, ok in checks),
                   checks={name: value for name, value, *_ in checks},
                   harness={k: v["value"] for k, v in _metric_values(
                       spec, cell_name, "per_layer", record).items()},
                   program=read(record, cell.program, spp))
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
    a = p.parse_args()
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.seconds,
             a.device)
