"""Arithmetic the per-layer metric readers share: the traced sub-window's
kernels, split into traversal and the rest, and the bytes a traversal
launch must move at the least."""

from __future__ import annotations

from typing import List, Optional

from portbench.lib import trace as tr

# published peak of one H100 SXM's HBM3 (NVIDIA's data sheet), bytes a second
HBM_BYTES_PER_S = 3.35e12
# least bytes of one lane of a traversal launch: its ray in once (origin and
# direction, 3 f32 each, and the f32 limit; tmin is one scalar of the
# launch) and its result out once: Hit(t, tri, u, v) of a closest query, the
# one-byte flag of an any-hit query
RAY_IN_BYTES = 12 + 12 + 4
CLOSEST_OUT_BYTES = 16
ANYHIT_OUT_BYTES = 1


def window_kernels(run) -> Optional[List[tr.Interval]]:
    """The kernels of the traced sub-window, clipped to it; None when the
    run traced nothing."""
    if run.trace is None or run.trace.window() is None:
        return None
    w0, w1 = run.trace.window()
    return tr.clip(run.trace.kernels, w0, w1)


def split_traversal(run):
    """(traversal kernels, the other kernels) of the traced sub-window, or
    None."""
    kernels = window_kernels(run)
    if kernels is None:
        return None
    trav = [k for k in kernels if tr.matches(k[0], run.traversal_kernels)]
    rest = [k for k in kernels if not tr.matches(k[0], run.traversal_kernels)]
    return trav, rest


def seconds(intervals) -> float:
    return sum(e - s for _, s, e in intervals) / 1e9


def least_traversal_bytes(launches) -> int:
    """The bytes the traversal launches must move at the least, from their
    lane counts: each ray in once, each result out once."""
    total = 0
    for name, lanes in launches:
        out = CLOSEST_OUT_BYTES if name.startswith("closest") \
            else ANYHIT_OUT_BYTES
        total += lanes * (RAY_IN_BYTES + out)
    return total
