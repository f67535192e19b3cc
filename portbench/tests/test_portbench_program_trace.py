"""The readers of the port's own spans and counters, on synthetic records:
`loop_idle_ms_per_sample` (a benchmark metric, read from the benchmark's
spans in the profiler trace) on a synthetic `RunRecord`, and the five
quantities of `portbench/program_readings.py` on a synthetic `RunRecord`
with synthetic recorder records; then one traced CPU window of the video
at a tiny size with the recorder on."""

import io

import pytest

from portbench import program_readings as pr
from portbench.lib import spec as bench_spec
from portbench.lib import trace as tr
from portbench.lib.drive import RunRecord
from portbench.tests._tiny import TINY
from pt_torch.core.stats import SpanRecord, TraceRecords

MS = 1_000_000          # ns in a millisecond


def profiled_trace():
    """A 100 ms profiled window: device busy 0-10, 20-30, 45-50, 70-80 ms,
    so idle 10-20, 30-45, 50-70, 80-100 ms. The benchmark's render span
    covers 0-60 ms with a rebuild 28-40 ms inside it; its snapshot
    60-100 ms."""
    t = tr.Trace()
    t.spans = [(tr.WINDOW_SPAN, 0, 100 * MS),
               ("portbench.render", 0, 60 * MS),
               ("portbench.rebuild", 28 * MS, 40 * MS),
               ("portbench.snapshot", 60 * MS, 100 * MS)]
    t.kernels = [("k", 0, 10 * MS), ("k", 20 * MS, 30 * MS),
                 ("k", 45 * MS, 50 * MS)]
    t.copies = [("Memcpy DtoH (Device -> Pageable)", 70 * MS, 80 * MS)]
    return t


@pytest.mark.parametrize("name", ["loop_idle_ms_per_sample",
                                  "loop_idle_ms_per_sample.video"])
def test_loop_idle_counts_the_gaps_that_start_in_render(name):
    read = bench_spec.load_metric(name).read
    rec = RunRecord(kind="still", pixels=1, trace=profiled_trace(),
                    profiled_samples=2)
    # gaps starting at 10 (render) and 50 ms (render) count: 10 + 20 ms;
    # 30 ms starts in the rebuild, 80 ms in the snapshot
    assert read(rec) == pytest.approx(30.0 / 2)
    # never more than the window's whole idle per sample (idle_pct's)
    idle_pct = bench_spec.load_metric("idle_pct").read(rec)
    window_ms = 100.0
    assert read(rec) <= idle_pct / 100 * window_ms / 2
    assert read(RunRecord(kind="still", pixels=1)) is None
    no_render = profiled_trace()
    no_render.spans = [s for s in no_render.spans
                       if s[0] != "portbench.render"]
    assert read(RunRecord(kind="still", pixels=1, trace=no_render,
                          profiled_samples=2)) is None


def _span(name, parent, step, start_ms, end_ms, dev=None, index=None):
    s = SpanRecord(name, parent, step, 1, int(start_ms * MS),
                   int(end_ms * MS), index=index)
    if dev is not None:
        s.device_start_ns, s.device_end_ns = (int(dev[0] * MS),
                                              int(dev[1] * MS))
    return s


def synthetic_program():
    """Three steps on the unix clock, 1000 ms from the anchor: step 0
    (1000-1100 ms) and step 2 (1300-1400 ms) lie outside the profiled
    window, step 1 (1150-1250 ms) inside it; each holds an alpha span and
    a compaction, step 2 two compactions."""
    spans = []
    for step, (a, b) in enumerate([(1000, 1100), (1150, 1250),
                                   (1300, 1400)]):
        top = len(spans)
        spans.append(_span("Render", -1, step, a, b, dev=(a, b + 20)))
        spans.append(_span("bounce", top, step, a + 1, a + 50,
                           dev=(a + 1, a + 60), index=0))
        spans.append(_span("alpha", top + 1, step, a + 2, a + 40,
                           dev=(a + 2, a + 42)))
        for k in range(2 if step == 2 else 1):
            spans.append(_span("compact", top, step, a + 60 + k,
                               a + 61 + k, dev=(a + 60 + 3 * k,
                                                a + 63 + 3 * k)))
    counters = {}
    for step in range(3):
        counters[("closest_lanes", step)] = 1000
        counters[("closest_live", step)] = 600 + 100 * step
        counters[("alpha_lanes", step)] = 4000
        counters[("alpha_pending", step)] = 400
    # the anchor: perf 10.0 s is unix 1000 ms
    return TraceRecords(spans, counters, anchor_unix_ns=1000 * MS,
                        anchor_perf_ns=10 * 10 ** 9)


def synthetic_record():
    """The window's steps on the perf clock (steps 0-2), and a profiled
    window 1140-1260 ms on the unix clock with idle gaps 1150-1170 (in
    step 1's Render) and 1250-1260 ms (after it)."""
    t = tr.Trace()
    t.spans = [(tr.WINDOW_SPAN, 1140 * MS, 1260 * MS)]
    t.kernels = [("k", 1140 * MS, 1150 * MS), ("k", 1170 * MS, 1250 * MS)]
    steps = [(10.0, 10.1, 1), (10.15, 10.25, 1), (10.3, 10.4, 1)]
    return RunRecord(kind="still", pixels=1, steps=steps, trace=t,
                     profiled_samples=1)


def test_program_readings_over_the_steps_outside_the_profiled_window():
    program, record = synthetic_program(), synthetic_record()
    steps, n = pr.window_steps(record, program)
    assert steps == {0, 2} and n == 2
    got = pr.read(record, program, samples_per_step=1)
    assert got["live_lane_pct"] == pytest.approx(100 * (600 + 800) / 2000)
    assert got["alpha_pending_pct"] == pytest.approx(10.0)
    assert got["alpha_ms_per_sample"] == pytest.approx(40.0)
    # step 0: one 3 ms compaction; step 2: two
    assert got["compact_ms_per_sample"] == pytest.approx(9.0 / 2)
    assert got["render_ms_per_sample"] == pytest.approx(120.0)
    assert got["bounce_ms_per_sample"] == {0: pytest.approx(59.0)}
    # the gap at 1150 ms starts in step 1's Render; the one at 1250 ms at
    # its end; the profiled window holds one sample
    assert got["loop_idle_ms_per_sample"] == pytest.approx(30.0)
    assert got["idle_ms_per_profiled_sample"] == pytest.approx(30.0)
    # the consistency the readings are held to
    assert (got["alpha_ms_per_sample"] + got["compact_ms_per_sample"]
            <= got["render_ms_per_sample"])
    assert (got["loop_idle_ms_per_sample"]
            <= got["idle_ms_per_profiled_sample"])


def test_program_readings_find_nothing_to_divide():
    program = TraceRecords([], {}, 0, 0)
    assert pr.live_lane_pct(program, {0}) is None
    assert pr.alpha_pending_pct(program, {0}) is None
    assert pr.device_ms_per_sample(program, "alpha", {0}, 0) is None
    assert pr.loop_idle_ms_per_sample(RunRecord(kind="still", pixels=1),
                                      program) is None


def test_traced_cpu_window_with_the_recorder_on():
    from pt_torch.core import stats
    cell = "heightfield_anim.video"
    rows = pr.readings(cell, [2147483659], 1.0, device="cpu",
                       overrides=TINY[cell], out=io.StringIO())
    assert not stats.tracing()
    (row,) = rows
    assert row["correct"] and row["steps"] >= 1
    got = row["program"]
    assert got["steps_read"] >= 1
    assert 0 < got["live_lane_pct"] <= 100
    # no card: no device intervals, no profiled window
    assert got["loop_idle_ms_per_sample"] is None
    assert got["compact_ms_per_sample"] == 0.0
