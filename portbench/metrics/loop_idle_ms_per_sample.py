"""loop_idle_ms_per_sample (ms), and `loop_idle_ms_per_sample.video`: the
device-idle ms of the profiled sub-window whose gap starts while the host
is inside the benchmark's `render` span and outside its `rebuild` span (the
render loop's own host work, apart from the frame's host path), per
profiled film-wide sample. The gaps are `idle_pct`'s: `trace.idle_gaps`
over the window's kernels and copies."""

from portbench.lib import trace as tr

RENDER = tr.SPAN_PREFIX + "render"
REBUILD = tr.SPAN_PREFIX + "rebuild"


def _inside(t, intervals):
    return any(s <= t <= e for s, e in intervals)


def read(run):
    if (run.trace is None or run.trace.window() is None
            or not run.profiled_samples):
        return None
    renders = [(s, e) for n, s, e in run.trace.spans if n == RENDER]
    if not renders:
        return None
    rebuilds = [(s, e) for n, s, e in run.trace.spans if n == REBUILD]
    w0, w1 = run.trace.window()
    gaps = tr.idle_gaps(run.trace.kernels + run.trace.copies, w0, w1)
    idle = sum(e - s for s, e in gaps
               if _inside(s, renders) and not _inside(s, rebuilds))
    return idle / 1e6 / run.profiled_samples
