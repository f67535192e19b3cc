"""Reading a torch.profiler trace: device activity, host spans, idle gaps.

`Trace` holds plain (name, start_ns, end_ns) records, so the arithmetic
below runs on a synthetic trace as well as on a real one. `from_profiler`
fills it from a finished `torch.profiler.profile`: device kernels, device
copies and sets, the benchmark's own annotations (`record_function` spans
whose names start with `SPAN_PREFIX`), and the host's aten operations.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SPAN_PREFIX = "portbench."
WINDOW_SPAN = SPAN_PREFIX + "window"

Interval = Tuple[str, int, int]          # (name, start_ns, end_ns)


@dataclasses.dataclass
class Trace:
    kernels: List[Interval] = dataclasses.field(default_factory=list)
    copies: List[Interval] = dataclasses.field(default_factory=list)
    spans: List[Interval] = dataclasses.field(default_factory=list)
    ops: List[Interval] = dataclasses.field(default_factory=list)

    def window(self) -> Optional[Tuple[int, int]]:
        """(start, end) of the traced window: its span, else None."""
        w = [(s, e) for n, s, e in self.spans if n == WINDOW_SPAN]
        return w[0] if w else None


def from_profiler(prof) -> Trace:
    """The records of a stopped `torch.profiler.profile`."""
    from torch.autograd import DeviceType
    t = Trace()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(SPAN_PREFIX) or e.is_user_annotation():
                continue
            if name.startswith(("Memcpy", "Memset")):
                t.copies.append((name, start, end))
            else:
                t.kernels.append((name, start, end))
        elif name.startswith(SPAN_PREFIX):
            t.spans.append((name, start, end))
        elif name.startswith("aten::"):
            t.ops.append((name, start, end))
    return t


def clip(intervals: Sequence[Interval], w0: int, w1: int) -> List[Interval]:
    """The parts of `intervals` inside [w0, w1]."""
    out = []
    for n, s, e in intervals:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            out.append((n, s, e))
    return out


def union(intervals: Sequence[Interval]) -> List[Tuple[int, int]]:
    """The merged (start, end) cover of `intervals`, in order."""
    merged: List[List[int]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_ns(intervals: Sequence[Interval], w0: int, w1: int) -> int:
    """Nanoseconds of [w0, w1] in which some interval runs."""
    return sum(e - s for s, e in union(clip(intervals, w0, w1)))


def idle_gaps(intervals: Sequence[Interval], w0: int,
              w1: int) -> List[Tuple[int, int]]:
    """The idle stretches of [w0, w1] between the intervals."""
    gaps, cur = [], w0
    for s, e in union(clip(intervals, w0, w1)):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    return gaps


def time_by_name(intervals: Sequence[Interval]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for n, s, e in intervals:
        out[n] = out.get(n, 0) + (e - s)
    return out


def matches(name: str, patterns: Sequence[str]) -> bool:
    """Whether a kernel's name holds one of `patterns` as a whole word."""
    return any(re.search(r"(?<![\w])" + re.escape(p) + r"(?![\w])", name)
               for p in patterns)


def _covering(records: Sequence[Interval], t: int,
              innermost: bool) -> Optional[str]:
    if not records:
        return None
    starts = np.fromiter((s for _, s, _ in records), np.int64, len(records))
    ends = np.fromiter((e for _, _, e in records), np.int64, len(records))
    hit = np.flatnonzero((starts <= t) & (ends >= t))
    if not len(hit):
        return None
    length = ends[hit] - starts[hit]
    pick = hit[np.argmin(length) if innermost else np.argmax(length)]
    return records[pick][0]


def label_gap(trace: Trace, start: int) -> str:
    """What the host was doing when the device went idle at `start`: the
    innermost benchmark span and the outermost aten operation then."""
    span = _covering(trace.spans, start, innermost=True)
    op = _covering(trace.ops, start, innermost=False)
    span = span[len(SPAN_PREFIX):] if span else "outside spans"
    return f"{span}: {op}" if op else span


def breakdown(trace: Trace, top: int = 10) -> Optional[dict]:
    """The device operations that took most time and the longest idle gaps
    by what the host was doing, in seconds, within the traced window."""
    win = trace.window()
    if win is None:
        return None
    w0, w1 = win
    device = clip(trace.kernels + trace.copies, w0, w1)
    ops = sorted(time_by_name(device).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(device, w0, w1), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:200], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[label_gap(trace, s)[:200], (e - s) / 1e9]
                          for s, e in gaps]}
