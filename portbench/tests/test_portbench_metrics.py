"""Each metric's arithmetic on synthetic records: a synthetic profiler
trace, synthetic spans and step times, the window that crosses the
deadline, and the ray counter read before each frame's film reset."""

import pytest

from portbench.lib import layers
from portbench.lib import spec as bench_spec
from portbench.lib import trace as tr
from portbench.lib.drive import RunRecord

MS = 1_000_000          # ns in a millisecond


def metric(name):
    return bench_spec.load_metric(name).read


def synthetic_trace():
    """A 100 ms traced window: two traversal kernels (10 + 5 ms), three
    other kernels (20, 20 overlapping by 10, and 5 ms), one copy (5 ms)."""
    t = tr.Trace()
    t.spans = [(tr.WINDOW_SPAN, 0, 100 * MS),
               ("portbench.render", 0, 60 * MS),
               ("portbench.snapshot", 60 * MS, 100 * MS)]
    t.kernels = [
        ("void closest_kernel<bf8::Walk>(bf8::Tree)", 0, 10 * MS),
        ("void occluded_kernel<bf8::Walk>(bf8::Tree)", 10 * MS, 15 * MS),
        ("void at::native::elementwise_kernel<128, 4>", 20 * MS, 40 * MS),
        ("void at::native::reduce_kernel<512, 1>", 30 * MS, 50 * MS),
        ("void at::native::elementwise_kernel<128, 4>", 95 * MS, 100 * MS)]
    t.copies = [("Memcpy DtoH (Device -> Pageable)", 70 * MS, 75 * MS)]
    t.ops = [("aten::nonzero", 50 * MS, 70 * MS),
             ("aten::copy_", 75 * MS, 95 * MS)]
    return t


def traced_record(**kw):
    rec = RunRecord(kind=kw.pop("kind", "still"), pixels=1000,
                    trace=synthetic_trace(), profiled_samples=2,
                    traversal_kernels=["closest_kernel", "occluded_kernel",
                                       "warp_kernel"], **kw)
    return rec


def test_union_busy_and_gaps():
    t = synthetic_trace()
    device = t.kernels + t.copies
    # union: [0,15] [20,50] [70,75] [95,100] = 15 + 30 + 5 + 5 ms
    assert tr.busy_ns(device, 0, 100 * MS) == 55 * MS
    assert tr.idle_gaps(device, 0, 100 * MS) == [
        (15 * MS, 20 * MS), (50 * MS, 70 * MS), (75 * MS, 95 * MS)]
    # clipping to a narrower window
    assert tr.busy_ns(device, 5 * MS, 25 * MS) == 15 * MS


def test_breakdown_labels_gaps_by_host_span_and_op():
    b = tr.breakdown(synthetic_trace(), top=2)
    assert b["device_ops"][0][0].startswith("void at::native::elementwise")
    assert b["device_ops"][0][1] == pytest.approx(0.025)
    # the two longest gaps: 50-70 ms (render, then nonzero) and 75-95 ms
    assert [g[1] for g in b["idle_gaps"]] == [pytest.approx(0.02)] * 2
    assert b["idle_gaps"][0][0] == "render: aten::nonzero"
    assert b["idle_gaps"][1][0] == "snapshot: aten::copy_"


def test_traversal_split_is_by_whole_word():
    assert tr.matches("void closest_kernel<x>(y)", ["closest_kernel"])
    assert not tr.matches("void my_closest_kernel_2(y)", ["closest_kernel"])
    trav, rest = layers.split_traversal(traced_record())
    assert len(trav) == 2 and len(rest) == 3


@pytest.mark.parametrize("suffix", ["", ".video"], ids=["still", "video"])
def test_device_metrics(suffix):
    # the video's names read the same arithmetic as the still's
    def m(name):
        return metric(name + suffix)
    rec = traced_record(launches=[("closest_bf8", 1000),
                                  ("occluded_bf8", 1000)])
    assert m("idle_pct")(rec) == pytest.approx(45.0)
    assert m("trav_ms_per_sample")(rec) == pytest.approx(7.5)
    assert m("shade_ms_per_sample")(rec) == pytest.approx(22.5)
    assert m("launches_per_sample")(rec) == pytest.approx(2.5)
    least = 1000 * (28 + 16) + 1000 * (28 + 1)
    expect = 100 * least / layers.HBM_BYTES_PER_S / 0.015
    assert m("trav_roofline")(rec) == pytest.approx(expect)
    assert m("trav_roofline")(rec) < 100.0


def test_readers_find_nothing_and_report_nothing():
    rec = RunRecord(kind="still", pixels=10)
    for name in ("idle_pct", "trav_ms_per_sample", "shade_ms_per_sample",
                 "launches_per_sample", "trav_roofline", "Mrays_per_s",
                 "idle_pct.video", "trav_ms_per_sample.video",
                 "shade_ms_per_sample.video", "launches_per_sample.video",
                 "trav_roofline.video", "Mrays_per_s.video",
                 "samples_per_s.video",
                 "frame_host_ms", "rebuild_ms", "frame_ms_p90",
                 "peak_mem_gib", "samples_per_s"):
        assert metric(name)(rec) is None, name
    # no traversal launch counted: no roofline, never a 0
    assert metric("trav_roofline")(traced_record()) is None


def test_still_window_counts_the_step_across_the_deadline():
    # steps of 0.4 s against a 1 s window: the third starts inside it and
    # ends past it; it counts, and the window runs to its end
    steps = [(10.0, 10.4, 1), (10.4, 10.8, 1), (10.8, 11.2, 1)]
    rec = RunRecord(kind="still", pixels=8_294_400, steps=steps, samples=3,
                    window_s=steps[-1][1] - steps[0][0])
    assert metric("samples_per_s")(rec) == pytest.approx(
        3 * 8_294_400 / 1.2 / 1e6)


def test_video_frames_and_p90():
    # 20 frames: 19 of 100 ms and one of 300 ms; p90 over all of them
    t, frames = 0.0, []
    for ms in [100] * 19 + [300]:
        frames.append((t, t + ms / 1e3))
        t += ms / 1e3
    rec = RunRecord(kind="video", pixels=2_073_600, frames=frames,
                    samples=20, window_s=t)
    import numpy as np
    assert metric("frame_ms_p90")(rec) == pytest.approx(
        np.percentile([100] * 19 + [300], 90))
    assert metric("samples_per_s.video")(rec) == pytest.approx(
        20 * 2_073_600 / t / 1e6)
    assert metric("frame_ms_p90")(RunRecord(kind="still", pixels=1,
                                            frames=frames)) is None


def test_rays_are_summed_over_frame_resets():
    # the renderer's counter restarts with each frame's film: the run reads
    # each frame's count at its hand-off, so the rate counts every frame
    rays = [(5_000_000, 0.5), (5_100_000, 0.5), (4_900_000, 0.5)]
    rec = RunRecord(kind="video", pixels=1, rays=rays, window_s=9.0)
    assert metric("Mrays_per_s")(rec) == pytest.approx(10.0)


def test_host_spans_and_rebuild_events():
    frames = [(0.0, 0.3), (0.3, 0.6)]
    # frame 2's render fell in the profiled sub-window: its spans are not
    # counted, nor is the frame
    spans = [("update", 0.6, 0.7, 2), ("render", 0.0, 0.25, 0),
             ("snapshot", 0.25, 0.27, 0),
             ("handoff", 0.27, 0.28, 0), ("scene_update", 0.28, 0.29, 1),
             ("update", 0.29, 0.30, 1), ("render", 0.30, 0.55, 1),
             ("rebuild", 0.30, 0.31, 1), ("snapshot", 0.55, 0.58, 1),
             ("handoff", 0.58, 0.6, 1)]
    rec = RunRecord(kind="video", pixels=1, frames=frames, spans=spans,
                    event_ms={"update": [0.5, 0.7, 0.6],
                              "rebuild": [4.0, 5.0, 6.0]})
    # snapshot + handoff + scene_update + update: 20+10+10+10+30+20 ms
    assert metric("frame_host_ms")(rec) == pytest.approx(100.0 / 2)
    assert metric("rebuild_ms")(rec) == pytest.approx(0.6 + 5.0)


def test_setup_and_memory():
    rec = RunRecord(kind="still", pixels=1, setup_s=12.5,
                    peak_mem_bytes=3 * 2 ** 30)
    assert metric("setup_s")(rec) == 12.5
    assert metric("peak_mem_gib")(rec) == 3.0


def test_final_mismatch_reads_per_sample():
    from portbench.reference.compare import per_sample_pct
    assert per_sample_pct(0.0, 60) == 0.0
    assert per_sample_pct(100.0, 60) == pytest.approx(100.0)
    # pixels that each flip a sample with probability p read p whatever N
    p = 0.001
    for n in (2, 60, 240):
        share = 100.0 * (1.0 - (1.0 - p) ** n)
        assert per_sample_pct(share, n) == pytest.approx(100.0 * p)
