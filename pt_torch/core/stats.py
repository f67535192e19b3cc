"""Process-wide stat board and scope timers.

Port of `pt.core.stats` (≙ the reference's `Stats`/`Timer`/`MaxTimer`,
Core/Core.h:64-122, accumulation in Core/Core.cpp:63-80): timers add their
measurements to a string-keyed board, `flush_timers()` folds them into
per-frame stats, and `MaxTimer` also keeps the running max of each key.

A `Timer` reads the host clock and nothing else. On the card PyTorch queues
kernels and returns before they run, as JAX dispatches asynchronously in
`pt`, so a timed block around device work (the "Render" stat) measures the
host's time to queue it, not the card's time to run it. No timer
synchronizes the card: that would stall the render path it measures.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Union

StatValue = Union[int, float, str]


class Stats:
    """String-keyed stat board, shared by the whole process
    (≙ Stats::AddStat/GetStats, Core/Core.h:64-92)."""

    _lock = threading.Lock()
    _stats: Dict[str, StatValue] = {}
    _pending: Dict[str, float] = {}       # timer sums awaiting the flush
    _max: Dict[str, float] = {}           # running max per MaxTimer key

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
    def flush_timers(cls) -> None:
        """Fold the pending timer sums into the board (≙ Stats::FlushTimers,
        called once a frame, Application.cpp:343)."""
        with cls._lock:
            for name, seconds in cls._pending.items():
                cls._stats[name] = f"{seconds * 1e3:.2f} ms"
            cls._pending.clear()

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


class Timer:
    """Scope timer adding host seconds to the board (≙ Timer's destructor,
    Core/Core.cpp:63-70)."""

    def __init__(self, name: str):
        self.name = name
        self._start = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        Stats.add_measurement(self.name, time.perf_counter() - self._start)


class MaxTimer(Timer):
    """Scope timer that also keeps the running max of its key (≙ MaxTimer's
    destructor, Core/Core.cpp:72-80)."""

    def __exit__(self, *exc) -> None:
        Stats.add_max_measurement(self.name, time.perf_counter() - self._start)
