"""A whole run of each cell on the CPU at a tiny size, with the look for a
card skipped: sound, it comes out correct; with the timed path broken
underneath, `correct` comes out false for each fault the cell can have (a
step that leaves the film unchanged, half of the lanes left out, an answer
altered where it is produced). One chip: no exchange between chips."""

from unittest import mock

import pytest
import torch

from portbench.lib import main
from portbench.tests._tiny import TINY


def _run(cell, seed=2147483659, seconds=1.0, faults=None, trace=0):
    args = main.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)])
    return main.execute(args, device="cpu", overrides=TINY[cell],
                        faults=faults)


def _unchanged():
    """Each render step does its work and leaves the film as it was."""
    from pt_torch.run.renderer import Renderer
    real = Renderer._render_group

    def step(self, *args, **kwargs):
        film = self.accum.clone()
        real(self, *args, **kwargs)
        self.accum.copy_(film)
    return mock.patch.object(Renderer, "_render_group", step)


def _patched_radiance(fn):
    from pt_torch.run import renderer
    real = renderer._finite_or_zero
    return mock.patch.object(renderer, "_finite_or_zero",
                             lambda rad: fn(real(rad)))


def _half_left_out():
    def drop(rad):
        keep = torch.ones_like(rad)
        keep[rad.shape[0] // 2:] = 0.0
        return rad * keep
    return _patched_radiance(drop)


def _altered():
    return _patched_radiance(lambda rad: rad * 1.01)


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "altered": _altered}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    # a CPU run names its device and reports no device metric
    assert result["device"]["platform"] == "cpu"
    assert result["metrics"] == {}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(TINY))
def test_fault_is_not_correct(cell, fault):
    result = _run(cell, faults=FAULTS[fault])
    assert not result["correct"], (fault, result["checks"])


def test_window_closes_at_the_step_across_the_deadline():
    from portbench.lib import spec as bench_spec
    from portbench.lib.drive import Cell
    spec = bench_spec.load_spec()
    cell = Cell(spec, "heightfield_anim.video", 5, 4.0, True, device="cpu",
                overrides=TINY["heightfield_anim.video"])
    rec = cell.run()
    start = rec.frames[0][0]
    assert rec.frames[-1][1] >= start + 4.0
    assert all(end < start + 4.0 for _, end in rec.frames[:-1])
    # each frame's rays were read before its film's reset: one count a
    # frame, the last about the first (a count that ran on across the
    # resets would be twice it or more)
    assert len(rec.frames) >= 2 and len(rec.rays) == len(rec.frames)
    counts = [n for n, _ in rec.rays]
    assert 0 < counts[-1] < 1.5 * counts[0]
    # the host spans are there, one render span a frame
    names = [s[0] for s in rec.spans]
    assert names.count("render") == len(rec.frames)


def test_control_reads_above_the_limit_on_three_seeds():
    from portbench.readings import readings
    from portbench.reference.compare import load_limits
    limits = load_limits("heightfield_anim.video")
    rows = readings("heightfield_anim.video", [3, 2147483650, 77], 1.0,
                    "cpu", TINY["heightfield_anim.video"],
                    out=open("/dev/null", "w"))
    for row in rows:
        assert row["program"]["film_mismatch_pct"] <= limits[
            "film_mismatch_pct"]
        assert row["control"]["film_mismatch_pct"] > limits[
            "film_mismatch_pct"]
