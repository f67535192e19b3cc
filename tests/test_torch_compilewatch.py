"""The port's compile watch (`pt_torch.core.compilewatch`), the counterpart
of `tests/test_watchdog.py:38-93`: the transient classifier, retries of
transient errors only, retries running out, and a render that survives
transient failures of its first stage calls. Then the two faults that
`pt`'s version has and the port's leaves out (the in-flight entry held
through the backoff sleep; one `hang_warn_s` for the whole watchdog), and
the guard around a first-use library build.
"""

import errno
import logging
import subprocess
import threading
import time

import numpy as np
import pytest

from pt.core import compilewatch as jwatch
from pt_torch.accel import native
from pt_torch.core import compilewatch
from pt_torch.core.compilewatch import (FakeTransientError, is_transient,
                                        stage_call)

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    monkeypatch.setenv("PT_COMPILE_BACKOFF_S", "0.01")
    monkeypatch.delenv("PT_FAKE_TRANSIENT_FAILS", raising=False)
    compilewatch._reset_fake_failures()
    yield
    compilewatch._reset_fake_failures()


def test_transient_classifier():
    """What the port's builds and stages can raise: an OSError of a busy or
    exhausted resource is transient; a compiler's error, a build's timeout
    and a CUDA launch error are not. `pt`'s remote-compile markers mean
    nothing here."""
    for code in (errno.EAGAIN, errno.EINTR, errno.ENOMEM, errno.EMFILE,
                 errno.ENFILE, errno.EBUSY, errno.ETXTBSY):
        assert is_transient(OSError(code, "busy"))
    assert is_transient(BlockingIOError(errno.EAGAIN, "fork"))
    assert is_transient(FakeTransientError("x"))
    assert not is_transient(ValueError("shape mismatch"))
    assert not is_transient(OSError(errno.ENOENT, "no such file"))
    assert not is_transient(RuntimeError("build of libx.so failed: error"))
    assert not is_transient(subprocess.TimeoutExpired("nvcc", 900))
    assert not is_transient(RuntimeError("closest_bf8 launch failed: an "
                                         "illegal memory access"))
    remote = RuntimeError("INTERNAL: http://127.0.0.1:8093/remote_compile: "
                          "read body: response body closed")
    assert jwatch.is_transient(remote) and not is_transient(remote)


def test_stage_call_retries_transients(monkeypatch):
    monkeypatch.setenv("PT_FAKE_TRANSIENT_FAILS", "2")
    compilewatch._reset_fake_failures()
    calls = []

    def fn(x):
        calls.append(x)
        return x + 1

    # two injected transient failures take two attempts; the third reaches
    # fn
    assert stage_call(fn, 41, what="test stage") == 42
    assert calls == [41]


def test_stage_call_propagates_real_errors():
    calls = []

    def bad():
        calls.append(1)
        raise ValueError("real bug")

    with pytest.raises(ValueError):
        stage_call(bad, what="test stage", retries=3)
    assert calls == [1]                 # no retry
    assert not compilewatch._in_flight


def test_stage_call_exhausts_retries(monkeypatch):
    monkeypatch.setenv("PT_FAKE_TRANSIENT_FAILS", "10")
    compilewatch._reset_fake_failures()
    with pytest.raises(FakeTransientError):
        stage_call(lambda: 1, what="test stage", retries=2)
    assert compilewatch._fail_budget == 7
    assert not compilewatch._in_flight


def test_render_survives_transient_stage_failures(monkeypatch):
    """A render() whose first stage calls hit transient errors completes
    (≙ ShaderLibrary.cpp:246-257: warn and keep rendering)."""
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.renderer import Renderer
    from pt_torch.scene.examples import make_default_scene

    r = Renderer(PathTracingSettings(sample_count=1, bounce_count=2),
                 device="cpu")
    r.set_scene(make_default_scene(), stream_textures=False)
    r.on_resize(32, 32)
    monkeypatch.setenv("PT_FAKE_TRANSIENT_FAILS", "3")
    compilewatch._reset_fake_failures()
    r.render(1)
    assert compilewatch._fail_budget == 0
    img = r.snapshot()
    assert np.isfinite(img).all() and img.max() > 0


def test_backoff_sleep_is_not_counted_as_blocked(monkeypatch):
    """`pt`'s fault: its in-flight entry stays registered through the
    retry's backoff sleep, so the sleep counts as a blocked call. Here the
    watch holds nothing while the retry sleeps."""
    seen = []
    real_sleep = time.sleep

    def sleep(s):
        with compilewatch._cond:
            seen.append(dict(compilewatch._in_flight))
        real_sleep(0)
    monkeypatch.setattr(compilewatch.time, "sleep", sleep)
    monkeypatch.setenv("PT_FAKE_TRANSIENT_FAILS", "2")
    compilewatch._reset_fake_failures()
    assert stage_call(lambda: 5, what="slept", backoff_s=1.0) == 5
    assert seen == [{}, {}]
    assert not compilewatch._in_flight


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_hang_warning_uses_each_calls_threshold():
    """`pt`'s fault: its watchdog thread keeps the `hang_warn_s` of the
    call that started it. Here a call with a shorter threshold than every
    earlier one is warned about on its own threshold."""
    rec = _Records()
    compilewatch.log.addHandler(rec)
    try:
        # start (or reuse) the watchdog with a long threshold first
        assert stage_call(lambda: 1, what="long", hang_warn_s=1e6) == 1
        release = threading.Event()
        out = []
        t = threading.Thread(target=lambda: out.append(stage_call(
            release.wait, 5.0, what="short stage", hang_warn_s=0.2)))
        t.start()
        deadline = time.monotonic() + 5.0
        while (not any("short stage" in m for m in rec.messages)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        release.set()
        t.join()
    finally:
        compilewatch.log.removeHandler(rec)
    warned = [m for m in rec.messages if "short stage" in m]
    assert warned and "has been blocked for" in warned[0], rec.messages
    assert out == [True]
    assert not any("long" in m.split(" has")[0] for m in rec.messages)


def test_first_use_build_is_guarded(monkeypatch, tmp_path):
    """The SBVH library's first-use build goes through `stage_call`: a fork
    refused once (EAGAIN) is retried, and the library then loads."""
    attempts = []
    real = native.compile_shared

    def flaky(*args, **kw):
        attempts.append(1)
        if len(attempts) == 1:
            raise BlockingIOError(errno.EAGAIN, "Resource temporarily "
                                  "unavailable")
        return real(*args, **kw)
    monkeypatch.setattr(native, "compile_shared", flaky)
    monkeypatch.setattr(native, "_LIB", tmp_path / "libptsah_torch.so")
    monkeypatch.setattr(native, "_lib_handle", None)
    lib = native._load()
    assert attempts == [1, 1]
    assert lib.pt_build_sbvh is not None


def test_nested_guard_does_not_retry_an_inner_give_up():
    """A stage whose first call builds a library under a guard of its own:
    a transient error the inner guard retried until it gave up is raised
    through the outer guard at once, not retried 4 x 4 times."""
    calls = []

    def build():
        calls.append(1)
        raise BlockingIOError(errno.EAGAIN, "fork refused")

    def stage():
        return stage_call(build, what="inner build", retries=2)

    with pytest.raises(BlockingIOError) as info:
        stage_call(stage, what="outer stage", retries=3)
    assert len(calls) == 3
    assert not is_transient(info.value)
    assert not compilewatch._in_flight


def test_nested_guard_watches_the_innermost_call():
    """While a nested build with a long threshold runs, the stage around it
    is not warned about on its own shorter one; once the build returns,
    the stage's clock starts again."""
    rec = _Records()
    compilewatch.log.addHandler(rec)
    try:
        def stage():
            stage_call(time.sleep, 0.6, what="inner build",
                       hang_warn_s=1e6)
            return 7
        assert stage_call(stage, what="outer stage", hang_warn_s=0.2) == 7
    finally:
        compilewatch.log.removeHandler(rec)
    assert not any("outer stage" in m for m in rec.messages), rec.messages
    assert not compilewatch._in_flight
