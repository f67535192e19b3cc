"""The span-and-counter recorder of `pt_torch.core.stats` on the CPU.

* Off: `span` returns the one shared no-op context and `count` records
  nothing; a render made while it is off leaves no record.
* On, over two 48² steps of the Default scene (step 1 observes the
  compaction plan, step 2 compacts by it): "Render" is the step, with
  "raygen", "bounce" (its index), "compact", "observe" and "accumulate"
  inside it, and "trace", "shade", "nee", "roulette" inside each bounce;
  parents and step ids agree; the counters book to their step;
  closest_live <= closest_lanes, and closest_live + shadow_live is the
  step's ray count.
* On an alpha scene, static (the split trees) and animated (one Morton
  tree): every "alpha" span lies in a "trace" or a "nee" span, and
  alpha_pending <= alpha_lanes, four rounds a query.
* The film is bit-equal with the recorder on and off.
* A two-frame offline video: each frame's "Render" is a step of its own,
  after the rebuild of the moved tree; the rebuild and the image's "post"
  and "readback" lie outside every step.
* Under torch.profiler a span is also a `record_function` range, starting
  within 1 ms of its recorded start; a `Timer` is a span of its own name.
* A device timer's events reach the board at the first flush that finds
  them run; until then the board keeps the last value.
"""

import time

import pytest
import torch

import chip_smoke
from pt_torch.core import stats
from pt_torch.core.stats import Stats, Timer
from pt_torch.render.integrator import ALPHA_ROUNDS, PathTracingSettings
from pt_torch.run.renderer import Renderer
from pt_torch.scene.examples import make_default_scene

from torch_threads import one_torch_thread  # noqa: F401

SIZE = 48           # 2,304 lanes: the tails compact to the 1,024 class
BOUNCES = 3


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the recorder off."""
    if stats.tracing():
        stats.stop_trace()
    yield
    if stats.tracing():
        stats.stop_trace()


def _renderer(scene, size=SIZE, bounces=BOUNCES):
    r = Renderer(PathTracingSettings(sample_count=1, bounce_count=bounces),
                 device="cpu")
    r.set_scene(scene, stream_textures=False)
    r.on_resize(size, size)
    return r


def _steps(r, n):
    """`n` render(1) steps; the rays each traced."""
    rays = []
    for _ in range(n):
        before = r.rays_traced
        r.render(1)
        rays.append(r.rays_traced - before)
    return rays


@pytest.fixture(scope="module")
def default_trace():
    """Two traced steps of the Default scene: (records, rays a step, the
    film, the traced renderer)."""
    r = _renderer(make_default_scene())
    stats.start_trace("cpu")
    try:
        rays = _steps(r, 2)
    finally:
        records = stats.stop_trace()
    return records, rays, r.accum.clone(), r


def _children(records, i):
    return [s for s in records.spans if s.parent == i]


def test_off_is_one_shared_noop_and_records_nothing():
    assert not stats.tracing()
    a, b = stats.span("x"), stats.span("y", 3, step=True)
    assert a is b
    with a:
        stats.count("closest_live", torch.tensor(5))
    r = _renderer(make_default_scene(), size=16, bounces=2)
    r.render(1)
    stats.start_trace("cpu")
    records = stats.stop_trace()
    assert records.spans == [] and records.counters == {}
    with pytest.raises(RuntimeError):
        stats.stop_trace()


def test_render_step_nesting(default_trace):
    records, _, _, _ = default_trace
    spans = records.spans
    steps = [i for i, s in enumerate(spans) if s.name == "Render"]
    assert len(steps) == 2
    assert len({spans[i].step for i in steps}) == 2
    for i in steps:
        top = spans[i]
        assert top.parent == -1
        kids = _children(records, i)
        names = [k.name for k in kids]
        assert names[0] == "raygen"
        assert [k.index for k in kids if k.name == "bounce"] == list(
            range(BOUNCES))
        assert names.count("accumulate") == 1
        for b in (k for k in kids if k.name == "bounce"):
            inner = [s.name for s in _children(records, spans.index(b))]
            assert inner == ["trace", "shade", "nee", "roulette"]
        # every span under the step carries the step's id
        for s in spans:
            j, up = s, None
            while j.parent != -1:
                up = spans[j.parent]
                j = up
            if j is top:
                assert s.step == top.step
        assert all(s.end_ns >= s.start_ns for s in spans)
    first, second = (_children(records, i) for i in steps)
    # step 1 observes the plan (and compacts nothing), step 2 compacts
    assert [k.name for k in first].count("observe") == 1
    assert "compact" not in [k.name for k in first]
    assert "observe" not in [k.name for k in second]
    assert [k.name for k in second].count("compact") >= 2


def test_counters_book_to_their_step(default_trace):
    records, rays, _, _ = default_trace
    steps = [s.step for s in records.spans if s.name == "Render"]
    assert {s for _, s in records.counters} == set(steps)
    for step, n_rays in zip(steps, rays):
        lanes = records.counter("closest_lanes", [step])
        live = records.counter("closest_live", [step])
        shadow = records.counter("shadow_live", [step])
        assert 0 < live <= lanes
        assert live + shadow == n_rays
    # bounce 0 is every pixel; a compacted tail traces fewer lanes
    full = BOUNCES * SIZE ** 2
    assert records.counter("closest_lanes", [steps[0]]) == full
    assert records.counter("closest_lanes", [steps[1]]) < full


def test_film_bit_equal_with_the_recorder_on_and_off(default_trace):
    _, rays, film, _ = default_trace
    r = _renderer(make_default_scene())
    assert _steps(r, 2) == rays
    assert torch.equal(r.accum, film)


@pytest.fixture(scope="module", params=[False, True],
                ids=["split_trees", "one_tree"])
def alpha_trace(request):
    """One traced step of the small alpha scene, static (opaque and alpha
    subset trees) or animated (one Morton tree); and the film of an
    untraced step."""
    scene = chip_smoke.build_animated_scene(chip_smoke.port_namespace(), 8,
                                            24, animate=request.param)
    r = _renderer(scene, size=32)
    stats.start_trace("cpu")
    try:
        rays = _steps(r, 1)
    finally:
        records = stats.stop_trace()
    assert (r.accel.alpha_split is None) == request.param
    plain = _renderer(chip_smoke.build_animated_scene(
        chip_smoke.port_namespace(), 8, 24, animate=request.param), size=32)
    assert _steps(plain, 1) == rays
    return records, rays, r.accum, plain.accum


def test_alpha_spans_and_rounds(alpha_trace):
    records, rays, _, _ = alpha_trace
    spans = records.spans
    alpha = [s for s in spans if s.name == "alpha"]
    # a closest and a shadow query a bounce
    assert len(alpha) == 2 * BOUNCES
    assert {spans[s.parent].name for s in alpha} == {"trace", "nee"}
    lanes = records.counter("alpha_lanes")
    pending = records.counter("alpha_pending")
    assert 0 < pending <= lanes
    assert lanes == ALPHA_ROUNDS * records.counter("closest_lanes") * 2
    assert (records.counter("closest_live")
            + records.counter("shadow_live")) == rays[0]


def test_alpha_film_bit_equal_with_the_recorder_on_and_off(alpha_trace):
    _, _, traced, plain = alpha_trace
    assert torch.equal(traced, plain)


def test_offline_frames_are_steps(tmp_path):
    from pt_torch.out.saver import OutputInfo
    from pt_torch.run.offline import OfflineRenderer, RenderSettings
    scene = chip_smoke.build_animated_scene(chip_smoke.port_namespace(), 8)
    r = _renderer(scene, size=16, bounces=2)
    out = OutputInfo(str(tmp_path / "f.png"), 16, 16, framerate=24.0)
    stats.start_trace("cpu")
    try:
        written = OfflineRenderer(r).render(RenderSettings(
            output=out, frame_count=2, max_sample_count=1,
            samples_per_step=1))
    finally:
        records = stats.stop_trace()
    assert written == 2
    spans = records.spans
    renders = [i for i, s in enumerate(spans) if s.name == "Render"]
    assert len(renders) == 2
    assert len({spans[i].step for i in renders}) == 2
    for i in renders:
        assert spans[i].parent == -1 and spans[i].step >= 0
        assert _children(records, i)[0].name == "raygen"
    top = [s for s in spans if s.parent == -1]
    assert [s.name for s in top] == ["Acceleration Structure Build",
                                     "Render", "post", "readback"] * 2
    assert all(s.step == -1 for s in top if s.name != "Render")
    assert not {"frame", "snapshot", "handoff", "scene_update",
                "update_scene_data"} & {s.name for s in spans}


def test_span_is_a_record_function_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    stats.start_trace("cpu")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with stats.span("probe_stage"):
                torch.ones(8).sum()
            with Timer("Probe Timer"):
                pass
    finally:
        records = stats.stop_trace()
    names = [s.name for s in records.spans]
    assert names == ["probe_stage", "Probe Timer"]
    seen = {e.name(): e.start_ns() for e in
            prof.profiler.kineto_results.events()}
    assert {"probe_stage", "Probe Timer"} <= set(seen)
    for s in records.spans:
        assert abs(seen[s.name] - s.start_ns) < 1_000_000
    Stats.flush_timers()
    assert "Probe Timer" in Stats.get_stats()      # still a board timer
    Stats.clear()


def test_anchor_maps_perf_counter_to_the_unix_clock():
    stats.start_trace("cpu")
    perf, unix = time.perf_counter(), time.time_ns()
    records = stats.stop_trace()
    assert abs(records.perf_to_unix_ns(perf) - unix) < 1_000_000


class _FakeEvent:
    """A CUDA event stand-in: runs when `done` is set; `at` is its ms."""

    def __init__(self, at, done):
        self.at, self.done = at, done

    def query(self):
        return self.done[0]

    def elapsed_time(self, other):
        return other.at - self.at


def test_device_timer_reaches_the_board_once_run():
    Stats.clear()
    done = [False]
    Stats.add_device_measurement("Render", _FakeEvent(0.0, done),
                                 _FakeEvent(12.5, done))
    Stats.flush_timers()
    assert "Render" not in Stats.get_stats()       # not run: nothing yet
    done[0] = True
    Stats.flush_timers()
    assert Stats.get_stats()["Render"] == "12.50 ms"
    later = [False]
    Stats.add_device_measurement("Render", _FakeEvent(0.0, later),
                                 _FakeEvent(3.0, later))
    Stats.flush_timers()
    assert Stats.get_stats()["Render"] == "12.50 ms"   # the last value stays
    later[0] = True
    Stats.flush_timers()
    assert Stats.get_stats()["Render"] == "3.00 ms"
    # a render that never flushes folds its run pairs as they pile up
    for k in range(100):
        Stats.add_device_measurement("Loop", _FakeEvent(0.0, done),
                                     _FakeEvent(1.0, done))
    assert len(Stats._device["Loop"][1]) <= 33
    Stats.flush_timers()
    assert Stats.get_stats()["Loop"] == "100.00 ms"
    Stats.clear()
