"""The port's stat board, samples-per-frame controller and run loop against
`pt` on the CPU.

* `Stats`, `Timer` and `MaxTimer` give `pt`'s board for the same calls on
  the same clock readings (the board is process-wide: each test starts and
  ends with it empty).
* `AdaptiveSampleController` gives `pt`'s samples-per-frame sequence for a
  seeded list of 500 frame times; `Renderer.on_update` applies it and posts
  "Samples Per Frame".
* `Application.run(target_frames=2)` on the brute backend at 24², as
  `tests/test_output.py::test_app_boot_and_progressive_loop`; its debug
  branch presents debug frames and accumulates nothing.
* `python -m pt_torch.run.cli stats --device cpu` prints the keys that
  `pt`'s `Application.run` puts on its board.
"""

import contextlib
import io
import itertools
import time

import numpy as np
import pytest

from pt.core.stats import MaxTimer as JMaxTimer
from pt.core.stats import Stats as JStats
from pt.core.stats import Timer as JTimer
from pt.run.adaptive import AdaptiveSampleController as JController
from pt_torch.core.stats import MaxTimer, Stats, Timer
from pt_torch.run.adaptive import AdaptiveSampleController

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def empty_boards():
    Stats.clear()
    JStats.clear()
    yield
    Stats.clear()
    JStats.clear()


def _drive(stats, timer, max_timer, clock, monkeypatch):
    """The same calls on one package's board, the clock reading `clock`."""
    ticks = iter(clock)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    stats.add_stat("Total Samples", 4)
    with timer("Render"):
        pass
    with timer("Render"):
        pass
    with max_timer("Frame"):
        pass
    stats.flush_timers()
    first = stats.get_stats()
    with max_timer("Frame"):
        pass
    with max_timer("Frame"):
        pass
    stats.add_measurement("Update", 0.25)
    stats.flush_timers()
    stats.reset_max()
    with max_timer("Frame"):
        pass
    stats.flush_timers()
    return first, stats.get_stats()


def test_stat_board_matches_pt(monkeypatch):
    clock = list(itertools.accumulate(
        np.random.default_rng(3).uniform(1e-4, 5e-2, 16).tolist()))
    ours = _drive(Stats, Timer, MaxTimer, clock, monkeypatch)
    theirs = _drive(JStats, JTimer, JMaxTimer, clock, monkeypatch)
    assert ours == theirs
    assert set(ours[1]) == {"Total Samples", "Render", "Frame", "Max: Frame",
                            "Update"}
    assert ours[1]["Update"] == "250.00 ms"


def test_adaptive_controller_matches_pt():
    dts = np.random.default_rng(14).uniform(0.002, 0.04, 500).tolist()
    for rate, cap in ((60.0, 64), (30.0, 4), (0.5, 64)):
        ours, theirs = AdaptiveSampleController(rate, cap), JController(
            rate, cap)
        seq = [ours.on_update(dt) for dt in dts]
        assert seq == [theirs.on_update(dt) for dt in dts]
        assert len(set(seq)) > 1          # the sequence moves both ways
    assert max(seq) > 1


def test_renderer_on_update_sets_the_samples_per_frame():
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.renderer import Renderer
    r = Renderer(PathTracingSettings(sample_count=1), device="cpu",
                 min_refresh_rate=30.0, max_samples_per_frame=2)
    ctl = JController(30.0, 2)
    for dt in (0.0, 0.01, 0.01, 0.01, 0.01):
        r.on_update(dt)
        spf = ctl.on_update(dt)
        assert r.settings.sample_count == spf
        assert Stats.get_stats()["Samples Per Frame"] == spf
    assert spf == 2


def _app(width=24):
    from pt_torch.render.integrator import PathTracingSettings
    from pt_torch.run.app import Application
    app = Application(device="cpu")
    app.renderer.set_settings(PathTracingSettings(
        sample_count=1, bounce_count=2, backend="brute"))
    app.init(width=width, height=width)
    app.renderer.wait_for_textures()
    return app


def test_app_boot_and_progressive_loop():
    from pt_torch.core.config import Config
    from pt_torch.run.app import Application
    app = _app()
    snapshots = []
    frames = app.run(target_frames=2, on_frame=lambda img, total:
                     snapshots.append((img.copy(), total)))
    assert frames == 2 and len(snapshots) == 2
    assert snapshots[1][1] > snapshots[0][1]       # samples accumulate
    assert np.isfinite(snapshots[-1][0]).all()
    assert type(app.renderer.accel.bvh).__name__ == "BruteTriangles"
    board = Stats.get_stats()
    assert {"Frame total", "Update", "Render", "Samples Per Frame",
            "Total Samples"} <= set(board)
    app.stop()
    app.shutdown()
    cfg = Config(min_refresh_rate=30.0, max_samples_per_frame=3)
    ctl = Application(cfg, device="cpu").renderer.adaptive
    assert (ctl.min_refresh_rate, ctl.max_samples_per_frame) == (30.0, 3)


def test_app_debug_branch_presents_debug_frames():
    from pt_torch.render.debug import DebugFlags, DebugRenderMode
    app = _app(16)
    app.debug_mode = DebugRenderMode.NORMAL
    app.debug_flags = DebugFlags(disable_shadows=True)
    seen = []
    assert app.run(target_frames=2, on_frame=lambda img, total:
                   seen.append((img, total))) == 2
    assert [total for _, total in seen] == [0, 0]     # nothing accumulates
    img = seen[0][0]
    assert img.shape == (16, 16, 3) and (0 <= img).all() and (img <= 1).all()
    assert np.array_equal(seen[0][0], seen[1][0])
    app.shutdown()


@pytest.fixture(scope="module")
def pt_run_keys():
    """The keys `pt`'s board holds after `pt`'s `stats` run: its
    Application on the Default (here at 16²), brute, 3 bounces, two frames
    of `run` (`pt/run/cli.py:212-222`)."""
    from pt.render.integrator import PathTracingSettings as JSettings
    from pt.run.app import Application as JApplication
    JStats.clear()
    app = JApplication()
    app.init(width=16, height=16)
    app.renderer.set_settings(JSettings(sample_count=1, bounce_count=3,
                                        backend="brute"))
    app.run(target_frames=2)
    keys = set(JStats.get_stats())
    app.shutdown()
    JStats.clear()
    return keys


def test_cli_stats_prints_pts_keys(pt_run_keys):
    from pt_torch.accel import kernels
    from pt_torch.run import cli
    kernels.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["stats", "--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert lines == sorted(lines)
    keys = {line.split(": ", 1)[0] for line in lines}
    assert keys == pt_run_keys, keys ^ pt_run_keys
    assert {"Render", "Frame total", "Total Samples", "Samples Per Frame",
            "Scene Load", "Mesh Upload", "Update",
            "Acceleration Structure Build"} <= keys
    assert not any(kernels.launches.values())      # brute: no kernel
