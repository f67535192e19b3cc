"""Tiny atomic-counter thread pool.

Port of `pt.core.threads` (≙ the reference's `ThreadDispatch`,
Core/Threads.h:11-78): N worker threads pull indices from a single shared
counter until exhausted; blocking and cancellable variants. The port's
texture pool decodes on it (`pt_torch.scene.textures`).
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Optional


class ThreadDispatch:
    def __init__(self, thread_count: int):
        self.thread_count = max(1, thread_count)

    def dispatch_blocking(self, count: int, fn: Callable[[int], None]) -> None:
        """Run fn(i) for i in [0, count) across the pool; returns when done."""
        if count <= 0:
            return
        counter = itertools.count()
        errors: list[BaseException] = []
        lock = threading.Lock()

        def worker() -> None:
            while True:
                i = next(counter)
                if i >= count:
                    return
                try:
                    fn(i)
                except BaseException as e:  # propagate first error to caller
                    with lock:
                        errors.append(e)
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.thread_count, count))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def dispatch(self, count: int, fn: Callable[[int], None],
                 cancel: Optional[threading.Event] = None) -> threading.Thread:
        """Cancellable async variant (≙ stop_token overload, Core/Threads.h:44-78).

        Returns a join()-able thread; set `cancel` to stop early.
        """
        cancel = cancel or threading.Event()
        counter = itertools.count()
        errors: list = []

        def worker() -> None:
            while not cancel.is_set():
                i = next(counter)
                if i >= count:
                    return
                try:
                    fn(i)
                except BaseException as exc:
                    # an unguarded raise would silently kill this worker
                    # (its remaining indices never processed, join()
                    # reporting success); record it, log it, keep the
                    # other items going
                    import logging
                    logging.getLogger("pt_torch").exception(
                        "dispatch item %d failed: %s", i, exc)
                    errors.append(exc)

        def runner() -> None:
            threads = [threading.Thread(target=worker, daemon=True)
                       for _ in range(min(self.thread_count, count))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        outer = threading.Thread(target=runner, daemon=True)
        outer.errors = errors        # inspectable after join()
        outer.start()
        return outer
