"""idle_pct (%), and `idle_pct.video`: 100 x (1 - the union of device
activity over the profiled sub-window's length)."""

from portbench.lib import trace as tr


def read(run):
    if run.trace is None or run.trace.window() is None:
        return None
    w0, w1 = run.trace.window()
    if w1 <= w0:
        return None
    busy = tr.busy_ns(run.trace.kernels + run.trace.copies, w0, w1)
    return 100.0 * (1.0 - busy / (w1 - w0))
