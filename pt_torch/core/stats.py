"""Process-wide stat board, scope timers, and the span-and-counter recorder.

Port of `pt.core.stats` (≙ the reference's `Stats`/`Timer`/`MaxTimer`,
Core/Core.h:64-122, accumulation in Core/Core.cpp:63-80): timers add their
measurements to a string-keyed board, `flush_timers()` folds them into
per-frame stats, and `MaxTimer` also keeps the running max of each key.

A `Timer` reads the host clock, except one given a CUDA device: it records
a CUDA event at each end, on the device's current stream, and its
measurement is the device time between them. On the card PyTorch queues
kernels and returns before they run, so the host clock around device work
would measure the time to queue it. No timer synchronizes the card: a
device timer's events are folded into the board by `flush_timers()` once
`event.query()` says they have run, and until then the board keeps the
key's last value. The "Render" stat is such a timer.

The recorder. `start_trace(device)` turns it on and `stop_trace()` turns it
off and returns what it recorded (`TraceRecords`). In between:

- `span(name)` is a context manager that records the stage it encloses: its
  name, the index of the span around it on the same thread, the step it
  belongs to, its thread, its host start and end on `time.time_ns()` and,
  on a CUDA device, a CUDA event at each end, resolved in `stop_trace()`
  after one sync. A span opened with `step=True` (the "Render" timer: one
  `Renderer.render` or `render_adaptive` step) starts a new step id, which
  every span and counter inside it shares; the innermost such span wins. While a torch profiler runs, each span is also a `record_function`
  range of the same name.
- `count(name, value)` adds `value` (a host int, or a 0-d device tensor,
  kept on the device and summed in `stop_trace()`, never read before) to
  the counter `name` of the step that is open.
- Each `Timer` is also a span of its own name.

With the recorder off, `span()` returns one shared no-op context and
`count()` returns at once: neither allocates, records an event or launches
anything. Device time of a span is put on the unix clock through one
(CUDA event, `time.time_ns()`, `time.perf_counter_ns()`) anchor that
`start_trace` takes after a sync, reading both clocks as soon as the event
is seen to have run; `time.time_ns()` is also the clock of the torch
profiler's events.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

import torch

StatValue = Union[int, float, str]


class Stats:
    """String-keyed stat board, shared by the whole process
    (≙ Stats::AddStat/GetStats, Core/Core.h:64-92)."""

    _lock = threading.Lock()
    _stats: Dict[str, StatValue] = {}
    _pending: Dict[str, float] = {}       # timer sums awaiting the flush
    _max: Dict[str, float] = {}           # running max per MaxTimer key
    # device timers, per key: [ms of the event pairs that have run since
    # the board last showed the key (None: none), the pairs not yet run]
    _device: Dict[str, list] = {}

    @classmethod
    def add_stat(cls, name: str, value: StatValue) -> None:
        with cls._lock:
            cls._stats[name] = value

    @classmethod
    def add_measurement(cls, name: str, seconds: float) -> None:
        with cls._lock:
            cls._pending[name] = cls._pending.get(name, 0.0) + seconds

    @classmethod
    def add_max_measurement(cls, name: str, seconds: float) -> None:
        with cls._lock:
            cls._pending[name] = cls._pending.get(name, 0.0) + seconds
            if seconds > cls._max.get(name, 0.0):
                cls._max[name] = seconds
                cls._stats[f"Max: {name}"] = f"{seconds * 1e3:.2f} ms"

    @classmethod
    def add_device_measurement(cls, name: str, start, end) -> None:
        """Add the device time between two recorded CUDA events to `name`,
        once they have run. Pairs that have run are folded as they pile
        up, so a render that never flushes holds a bounded list."""
        with cls._lock:
            slot = cls._device.setdefault(name, [None, []])
            slot[1].append((start, end))
            if len(slot[1]) > 32:
                _fold_finished(slot)

    @classmethod
    def flush_timers(cls) -> None:
        """Fold the pending timer sums into the board (≙ Stats::FlushTimers,
        called once a frame, Application.cpp:343). A device timer shows the
        device time of its pairs that have run since it last showed; while
        none has, it keeps its last value."""
        with cls._lock:
            for name, seconds in cls._pending.items():
                cls._stats[name] = f"{seconds * 1e3:.2f} ms"
            cls._pending.clear()
            for name, slot in cls._device.items():
                _fold_finished(slot)
                if slot[0] is not None:
                    cls._stats[name] = f"{slot[0]:.2f} ms"
                    slot[0] = None

    @classmethod
    def reset_max(cls) -> None:
        with cls._lock:
            cls._max.clear()

    @classmethod
    def get_stats(cls) -> Dict[str, StatValue]:
        with cls._lock:
            return dict(cls._stats)

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._stats.clear()
            cls._pending.clear()
            cls._max.clear()
            cls._device.clear()


def _fold_finished(slot: list) -> None:
    """Move the leading event pairs of a device timer's slot that have run
    into its ms."""
    pairs = slot[1]
    while pairs and pairs[0][1].query():
        start, end = pairs.pop(0)
        slot[0] = (slot[0] or 0.0) + start.elapsed_time(end)


class Timer:
    """Scope timer adding host seconds to the board (≙ Timer's destructor,
    Core/Core.cpp:63-70), or, given a CUDA `device`, the device time between
    two CUDA events. While the recorder is on it is also a span of its own
    name; `step` makes that span a step."""

    def __init__(self, name: str, device=None, step: bool = False):
        self.name = name
        self._start = 0.0
        device = None if device is None else torch.device(device)
        self._device = (device if device is not None
                        and device.type == "cuda" else None)
        self._step = step
        self._span = _NO_SPAN
        self._events = None

    def __enter__(self) -> "Timer":
        if self._device is not None:
            # made before the span opens, so that the timer's events are
            # recorded next to the span's own
            self._events = _event_pair()
        self._span = span(self.name, step=self._step)
        self._span.__enter__()
        if self._device is not None:
            self._events[0].record(torch.cuda.current_stream(self._device))
        self._start = time.perf_counter()
        return self

    def _seconds(self) -> float:
        return time.perf_counter() - self._start

    def __exit__(self, *exc) -> None:
        if self._device is None:
            Stats.add_measurement(self.name, self._seconds())
        else:
            self._events[1].record(torch.cuda.current_stream(self._device))
        self._span.__exit__(*exc)
        if self._device is not None:
            Stats.add_device_measurement(self.name, *self._events)


class MaxTimer(Timer):
    """Scope timer that also keeps the running max of its key (≙ MaxTimer's
    destructor, Core/Core.cpp:72-80). Host seconds only."""

    def __init__(self, name: str):
        super().__init__(name)

    def __exit__(self, *exc) -> None:
        Stats.add_max_measurement(self.name, self._seconds())
        self._span.__exit__(*exc)


# -- the recorder -------------------------------------------------------------

def _event_pair():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


@dataclasses.dataclass
class SpanRecord:
    """One recorded span. Times are unix nanoseconds (`time.time_ns()`);
    the device times are None off a CUDA device, or for a span still open
    when the recorder stopped."""
    name: str
    parent: int               # index of the enclosing span, -1 at the top
    step: int                 # id of the innermost step span, -1 outside
    thread: int
    start_ns: int
    end_ns: Optional[int] = None
    index: Optional[int] = None         # the bounce of a bounce span
    device_start_ns: Optional[int] = None
    device_end_ns: Optional[int] = None

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_start_ns is None or self.device_end_ns is None:
            return None
        return (self.device_end_ns - self.device_start_ns) / 1e6


@dataclasses.dataclass
class TraceRecords:
    """What the recorder held when it stopped: the spans in the order they
    opened, the counters as {(name, step): total}, and the anchor pairing
    the unix clock with `time.perf_counter_ns()`."""
    spans: List[SpanRecord]
    counters: Dict[Tuple[str, int], int]
    anchor_unix_ns: int
    anchor_perf_ns: int

    def counter(self, name: str, steps=None) -> int:
        """The total of counter `name`, over `steps` (ids) or all."""
        return sum(v for (n, s), v in self.counters.items()
                   if n == name and (steps is None or s in steps))

    def device_ms(self, name: str, steps=None) -> float:
        """The summed device intervals of the spans named `name`, over
        `steps` (ids) or all; spans without device times add nothing."""
        return sum(s.device_ms or 0.0 for s in self.spans
                   if s.name == name and (steps is None or s.step in steps))

    def perf_to_unix_ns(self, perf_seconds: float) -> int:
        """A `time.perf_counter()` reading on the unix clock."""
        return self.anchor_unix_ns + int(perf_seconds * 1e9
                                         - self.anchor_perf_ns)


class _NoSpan:
    """The shared context `span()` returns while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "index", "starts_step", "i", "device",
                 "events", "_range")

    def __init__(self, rec: "_Recorder", name: str, index, step: bool):
        self.rec, self.name, self.index = rec, name, index
        self.starts_step = step
        self.device = rec.device
        self.events = _event_pair() if rec.device is not None else None
        self._range = None

    def __enter__(self) -> "_Span":
        rec = self.rec
        stack = rec.stack()
        parent, step = stack[-1] if stack else (-1, -1)
        with rec.lock:
            self.i = len(rec.spans)
            if self.starts_step:
                step = rec.next_step
                rec.next_step += 1
            rec.spans.append(SpanRecord(self.name, parent, step,
                                        threading.get_ident(),
                                        time.time_ns(), index=self.index))
            rec.events.append(self.events)
        stack.append((self.i, step))
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.events is not None:
            self.events[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc) -> None:
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self._range is not None:
            self._range.__exit__(*exc)
        self.rec.spans[self.i].end_ns = time.time_ns()
        self.rec.stack().pop()


class _Recorder:
    def __init__(self, device):
        device = torch.device(device)
        self.device = device if device.type == "cuda" else None
        self.lock = threading.Lock()
        self.spans: List[SpanRecord] = []
        self.events: list = []            # per span: its event pair or None
        self.counts: list = []            # (name, step, int or 0-d tensor)
        self.next_step = 0
        self._local = threading.local()
        self.anchor = None
        if self.device is not None:
            torch.cuda.synchronize(self.device)
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.anchor.record(torch.cuda.current_stream(self.device))
            # the clocks are read as the event is seen to have run: an idle
            # stream can take a few hundred microseconds to reach it
            while not self.anchor.query():
                pass
        self.anchor_unix_ns = time.time_ns()
        self.anchor_perf_ns = time.perf_counter_ns()

    def stack(self) -> list:
        """This thread's open spans: (index, step) pairs."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def records(self) -> TraceRecords:
        if self.device is not None:
            torch.cuda.synchronize(self.device)
            for rec, ev in zip(self.spans, self.events):
                if ev is None or rec.end_ns is None:
                    continue
                rec.device_start_ns = self._unix(ev[0])
                rec.device_end_ns = self._unix(ev[1])
        totals: Dict[Tuple[str, int], int] = {}
        on_device: Dict[Tuple[str, int], list] = {}
        for name, step, value in self.counts:
            if isinstance(value, torch.Tensor):
                on_device.setdefault((name, step), []).append(value)
            else:
                totals[(name, step)] = totals.get((name, step), 0) + value
        if on_device:
            sums = torch.stack([torch.stack(v).to(torch.int64).sum()
                                for v in on_device.values()]).tolist()
            for k, v in zip(on_device, sums):
                totals[k] = totals.get(k, 0) + int(v)
        return TraceRecords(self.spans, totals, self.anchor_unix_ns,
                            self.anchor_perf_ns)

    def _unix(self, event) -> int:
        return self.anchor_unix_ns + round(
            self.anchor.elapsed_time(event) * 1e6)


_recorder: Optional[_Recorder] = None


def tracing() -> bool:
    """Whether the recorder is on."""
    return _recorder is not None


def start_trace(device="cpu") -> None:
    """Turn the recorder on for work on `device` (CUDA events are recorded
    on a CUDA device). Syncs the device once."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("the recorder is already on")
    _recorder = _Recorder(device)


def stop_trace() -> TraceRecords:
    """Turn the recorder off and return its records, after one sync of its
    device."""
    global _recorder
    rec, _recorder = _recorder, None
    if rec is None:
        raise RuntimeError("the recorder is off")
    return rec.records()


def span(name: str, index: Optional[int] = None, step: bool = False):
    """A context that records the stage it encloses while the recorder is
    on (see the module's docstring); the shared no-op context otherwise.
    `index` is kept with the span (a bounce's index); `step` starts a new
    step id."""
    rec = _recorder
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, index, step)


def count(name: str, value) -> None:
    """Add `value` (a host int, or a 0-d device tensor left on the device)
    to counter `name` of the open step, while the recorder is on."""
    rec = _recorder
    if rec is None:
        return
    stack = rec.stack()
    step = stack[-1][1] if stack else -1
    rec.counts.append((name, step, value))
