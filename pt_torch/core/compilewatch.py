"""Compile watch: transient-error retry and a hang warning around the
render stages and the first-use kernel builds.

Port of `pt.core.compilewatch`. In `pt` it guards the stage jits against a
flaky remote-compile service. In the port, what compiles is the first use
of a kernel library (one nvcc per CUDA source, g++ for the SBVH library,
into `pt_torch/.build/`), and what runs is a stage's tensor code and kernel
launches. `stage_call(fn, *args, what=...)` is the one guard both go
through (≙ ShaderLibrary.cpp:246-257, where the reference warns on a failed
shader compile instead of wedging the renderer):

* it retries an error that `is_transient` names, with bounded backoff (3
  retries by default, 5 s * 2^i, `PT_COMPILE_BACKOFF_S` overriding the 5);
* a daemon watchdog logs a warning once a guarded call has been blocked
  longer than that call's `hang_warn_s`, and again once a minute.

Transient, of what the builds and stages can raise: an OSError whose errno
is EAGAIN, EINTR, ENOMEM, EMFILE, ENFILE, EBUSY or ETXTBSY (a fork of the
compiler refused for the moment, a process out of file handles, a library
file busy while another process replaces it), and the test hook's
`FakeTransientError`. Not transient: a compiler's error (`RuntimeError`
with its output: the same source fails the same way again), a build's
timeout (`subprocess.TimeoutExpired`: the watchdog has warned already, and
a retry would wait as long again), a CUDA error at a launch, and anything
else. A guarded stage is a pure function of its arguments, so a retry
recomputes exactly what the failed attempt would have.

Two faults of `pt`'s version are left out here: the in-flight entry is
removed before the backoff sleep, so the sleep is not reported as a
blocked call, and each call keeps its own `hang_warn_s`, so a call with a
shorter threshold than the one that started the watchdog is warned on its
own.

Guards nest: a stage's first call builds a kernel library under a guard
of its own. The innermost guarded call of a thread is the one watched:
its caller is not warned about while it runs, and the caller's clock
restarts when it returns. A transient error that an inner guard retried
until its retries ran out is marked, and no outer guard retries it again.

Test hook: `PT_FAKE_TRANSIENT_FAILS=N` makes the first N guarded calls
raise a `FakeTransientError` before running `fn`; `_reset_fake_failures()`
re-reads it.
"""

from __future__ import annotations

import errno
import logging
import os
import threading
import time
from typing import Any, Callable

log = logging.getLogger("pt_torch.compile")

#: errno values of an OSError that a retry can cure
TRANSIENT_ERRNOS = frozenset({errno.EAGAIN, errno.EINTR, errno.ENOMEM,
                              errno.EMFILE, errno.ENFILE, errno.EBUSY,
                              errno.ETXTBSY})

_DEFAULT_RETRIES = 3
_DEFAULT_BACKOFF_S = 5.0
_REPEAT_S = 60.0             # a blocked call is warned again this often

# -- watchdog state (one daemon thread per process, started lazily) --------
_cond = threading.Condition()
_in_flight: dict = {}        # (id, attempt) -> [t_start, what,
                             #    hang_warn_s, thread id, nesting depth]
_local = threading.local()   # .stack: this thread's in-flight keys
_watch_started = False
_fail_budget = None          # PT_FAKE_TRANSIENT_FAILS countdown


class FakeTransientError(RuntimeError):
    """Synthetic transient error for the retry tests."""


def is_transient(exc: BaseException) -> bool:
    if getattr(exc, "_pt_retried", False):   # an inner guard gave up on it
        return False
    if isinstance(exc, FakeTransientError):
        return True
    return isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS


def _due(now: float, warned: dict):
    """(the calls to warn about now, seconds until the next is due or
    None). A call is due `hang_warn_s` after it started, then once every
    `_REPEAT_S`."""
    due, wait = [], None
    deepest: dict = {}
    for _t0, _what, _warn, tid, depth in _in_flight.values():
        deepest[tid] = max(depth, deepest.get(tid, depth))
    for key, (t0, what, hang_warn_s, tid, depth) in _in_flight.items():
        if depth < deepest[tid]:
            continue          # a nested guarded call of its thread runs
        last = warned.get(key)
        at = t0 + hang_warn_s if last is None else last + _REPEAT_S
        if at <= now:
            due.append((key, now - t0, what))
            at = now + _REPEAT_S
        wait = at - now if wait is None else min(wait, at - now)
    return due, wait


def _watch_loop() -> None:
    warned: dict = {}
    while True:
        with _cond:
            now = time.monotonic()
            for key in [k for k in warned if k not in _in_flight]:
                del warned[key]
            due, wait = _due(now, warned)
            for key, _, _ in due:
                warned[key] = now
            if not due:
                _cond.wait(timeout=wait)
                continue
        for _, blocked, what in due:
            log.warning("%s has been blocked for %.0f s (a kernel build or "
                        "a stage that does not return); waiting: the call "
                        "cannot be cancelled safely (Ctrl-C aborts)", what,
                        blocked)


def _ensure_watchdog() -> None:
    global _watch_started
    with _cond:
        if _watch_started:
            return
        threading.Thread(target=_watch_loop, daemon=True,
                         name="pt_torch-compile-watchdog").start()
        _watch_started = True


def _maybe_fake_failure() -> None:
    """Test hook: PT_FAKE_TRANSIENT_FAILS=N fails the first N calls."""
    global _fail_budget
    if _fail_budget is None:
        _fail_budget = int(os.environ.get("PT_FAKE_TRANSIENT_FAILS", "0"))
    if _fail_budget > 0:
        _fail_budget -= 1
        raise FakeTransientError("synthetic transient failure "
                                 "(PT_FAKE_TRANSIENT_FAILS)")


def stage_call(fn: Callable, *args: Any, what: str = "render stage",
               retries: int = _DEFAULT_RETRIES,
               backoff_s: float | None = None,
               hang_warn_s: float = 90.0, **kwargs: Any) -> Any:
    """`fn(*args, **kwargs)` under the watchdog, retried on a transient
    error. Meant for functions whose failed attempt has no side effects (a
    stage computing new tensors, a build writing its library atomically).
    Any other error propagates at once, unchanged."""
    if backoff_s is None:
        backoff_s = float(os.environ.get("PT_COMPILE_BACKOFF_S",
                                         _DEFAULT_BACKOFF_S))
    _ensure_watchdog()
    stack = _local.__dict__.setdefault("stack", [])
    token = object()          # alive for the call: its id stays unique
    for attempt in range(retries + 1):
        key = (id(token), attempt)
        with _cond:
            _in_flight[key] = [time.monotonic(), what, hang_warn_s,
                               threading.get_ident(), len(stack)]
            _cond.notify()
        stack.append(key)
        try:
            _maybe_fake_failure()
            return fn(*args, **kwargs)
        except Exception as exc:          # noqa: BLE001 — filtered below
            # out of the watch before the backoff: sleeping is not blocked
            _leave(stack, key)
            if not is_transient(exc):
                raise
            if attempt >= retries:
                exc._pt_retried = True    # outer guards: retried already
                raise
            wait = backoff_s * (2.0 ** attempt)
            log.warning("%s failed with a transient error (attempt %d/%d): "
                        "%s; retrying in %.2f s", what, attempt + 1,
                        retries + 1, str(exc).splitlines()[0][:200], wait)
            time.sleep(wait)
        finally:
            _leave(stack, key)
    raise AssertionError("unreachable")   # the loop returns or raises


def _leave(stack: list, key) -> None:
    """Take `key` out of the watch (a second call does nothing); the
    enclosing guarded call of the thread, if any, is watched again from
    now on."""
    with _cond:
        if _in_flight.pop(key, None) is None:
            return
        stack.remove(key)
        if stack and stack[-1] in _in_flight:
            _in_flight[stack[-1]][0] = time.monotonic()
            _cond.notify()


def _reset_fake_failures() -> None:
    """Test helper: re-read PT_FAKE_TRANSIENT_FAILS on the next call."""
    global _fail_budget
    _fail_budget = None
