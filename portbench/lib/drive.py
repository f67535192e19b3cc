"""One run of one cell: set-up, warm-up, the measured window, the check.

The window drives the port's offline renderer,
`pt_torch.run.offline.OfflineRenderer.render`, the path of
`python -m pt_torch.run.cli render`, with the parameters of the cell's
traffic mix (`portbench/traffic/<mix>.json`). The mix's `kind` names the
module that drives and checks it, `portbench/kinds/<kind>.py`: its
`run(cell, renderer, workdir)` fills the cell's record and outputs, its
`check(cell, outputs, lowp=False, cache=None)` returns the numbers compared
with the plain reference. This file holds what every kind shares: the
record, the traced run's instruments, the set-up and the run.

Every step ends with a device sync in the renderer's `progress` callback,
so a step's time is the device's. A traced run (`trace`) wraps the calls
into each layer in spans with syncs, times the rebuild by CUDA events and
runs a short steady sub-window under torch.profiler.

The check compares what the window produced with the plain reference in
`portbench/reference/`, after the window has closed, the peak memory has
been read and the port's state is freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import pathlib
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.lib import spec as bench_spec
from portbench.lib import trace as tr
from portbench.lib.namespaces import port_namespace
from portbench.lib.scenecache import replay, scene_inputs

@dataclasses.dataclass
class RunRecord:
    """What a run measured, as the metric readers get it. Times are host
    `perf_counter` seconds; `trace` is the profiled sub-window."""
    kind: str
    pixels: int
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: List[tuple] = dataclasses.field(default_factory=list)
    frames: List[tuple] = dataclasses.field(default_factory=list)
    samples: int = 0
    peak_mem_bytes: Optional[int] = None
    # traced run: (rays, seconds) of each step or frame outside the
    # profiled sub-window, the rays read before the film's next reset
    rays: List[tuple] = dataclasses.field(default_factory=list)
    spans: List[tuple] = dataclasses.field(default_factory=list)
    event_ms: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    trace: Optional[tr.Trace] = None
    profiled_samples: int = 0
    launches: List[tuple] = dataclasses.field(default_factory=list)
    traversal_kernels: List[str] = dataclasses.field(default_factory=list)


class Tracing:
    """The traced run's instruments: spans with syncs, CUDA-event pairs,
    the profiled sub-window and the traversal launches' lane counts."""

    def __init__(self, record: RunRecord, device: torch.device):
        self.record = record
        self.cuda = device.type == "cuda"
        self.frame = 0
        self.events: List[tuple] = []
        self.prof = None
        self._window_span = None
        self.profiling = False

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def span(self, name: str, fn: Callable, timed: bool = False) -> Callable:
        """`fn` wrapped in a host span ending in a sync; with `timed` also
        between two CUDA events."""
        def call(*args, **kwargs):
            if self.profiling:
                # inside the profiled sub-window a span only annotates the
                # trace: no sync, so the device's timeline stays its own
                with torch.profiler.record_function(tr.SPAN_PREFIX + name):
                    return fn(*args, **kwargs)
            start = time.perf_counter()
            ev = None
            if timed and self.cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = fn(*args, **kwargs)
            if ev is not None:
                ev[1].record()
            self.sync()
            self.record.spans.append((name, start, time.perf_counter(),
                                      self.frame))
            if ev is not None:
                self.events.append((name, self.frame, ev))
            return out
        return call

    def start_profile(self) -> None:
        if self.prof is not None or not self.cuda:
            return
        self.sync()
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._window_span = torch.profiler.record_function(tr.WINDOW_SPAN)
        self._window_span.__enter__()
        self.profiling = True

    def stop_profile(self) -> None:
        """End the profiled sub-window; its trace is read after the window
        (`finish`)."""
        if not self.profiling:
            return
        self.sync()
        self._window_span.__exit__(None, None, None)
        self.profiling = False
        self.prof.stop()

    def finish(self) -> None:
        self.stop_profile()
        self.sync()
        if self.prof is not None:
            self.record.trace = tr.from_profiler(self.prof)
            self.prof = None
        for name, frame, (a, b) in self.events:
            self.record.event_ms.setdefault(name, []).append(
                a.elapsed_time(b))


def _count_lanes(tracing: Tracing, fn: Callable, name: str) -> Callable:
    """A traversal wrapper that notes its lanes while profiling."""
    def call(bvh, origins, *args, **kwargs):
        if tracing.profiling:
            tracing.record.launches.append((name, int(origins.shape[0])))
        return fn(bvh, origins, *args, **kwargs)
    return call


@contextlib.contextmanager
def traversal_counted(tracing: Optional[Tracing]):
    """Count the lanes of every traversal call the integrator makes (its
    imported kernel wrappers), while `tracing` profiles."""
    if tracing is None:
        yield
        return
    from pt_torch.render import integrator
    names = ("closest_bf8", "occluded_bf8", "closest_v4", "occluded_v4")
    saved = {n: getattr(integrator, n) for n in names}
    try:
        for n in names:
            setattr(integrator, n, _count_lanes(tracing, saved[n], n))
        yield
    finally:
        for n in names:
            setattr(integrator, n, saved[n])


def pixel_sample(seed: int, width: int, height: int, count: int):
    """`count` distinct pixels drawn from the seed: (xs, ys)."""
    rng = np.random.default_rng([seed & ((1 << 63) - 1), 1])
    idx = rng.choice(width * height, size=min(count, width * height),
                     replace=False)
    ys, xs = np.divmod(idx, width)
    return xs, ys


class Cell:
    """One run of a cell: `run()` returns the run's record and the outputs
    the check compares."""

    def __init__(self, spec: dict, cell: str, seed: int, seconds: float,
                 trace: bool, device="cuda", overrides: Optional[dict] = None,
                 t_process: Optional[float] = None):
        overrides = overrides or {}
        self.spec = spec
        self.cell = bench_spec.workload(spec, cell)
        self.config = bench_spec.load_config(spec, self.cell["config"])
        self.traffic = {**bench_spec.load_traffic(self.cell["traffic"]),
                        **overrides.get("traffic", {})}
        self.kind = bench_spec.load_kind(self.traffic["kind"])
        self.params = {**self.config.PARAMS, **overrides.get("params", {})}
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.t_process = (time.perf_counter() if t_process is None
                          else t_process)
        self.width = int(self.traffic["width"])
        self.height = int(self.traffic["height"])
        self.record: Optional[RunRecord] = None
        self.tracing: Optional[Tracing] = None
        self._traversal = (bench_spec.BENCH_DIR / "metrics"
                           / "traversal_kernels.txt").read_text().split()
        self.calls = None
        self.outputs: Dict[str, Any] = {}
        self.renderer = None
        # every step of the clip since the scene was built, in order
        self.dts: List[float] = []

    # -- set-up -----------------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def setup(self, workdir: pathlib.Path):
        from pt_torch.render.integrator import PathTracingSettings
        from pt_torch.run.renderer import Renderer
        ns = port_namespace()
        self.calls, _ = scene_inputs(self.config, self.params, ns)
        builder = ns.SceneBuilder(self.config.NAME)
        replay(self.calls, builder, ns)
        scene = builder.create_scene()
        r = Renderer(settings=PathTracingSettings(**self.config.SETTINGS),
                     device=self.device)
        r.set_scene(scene)
        r.on_resize(self.width, self.height)
        r.wait_for_textures()
        return r

    # -- the run ----------------------------------------------------------
    def window(self, seed: Optional[int] = None) -> RunRecord:
        """One measured window of the set-up renderer (set up on the first
        call) at `seed`, with a fresh record; for readings of several seeds
        in one process."""
        if seed is not None:
            self.seed = int(seed)
        self.record = RunRecord(kind=self.traffic["kind"],
                                pixels=self.width * self.height)
        if self.trace:
            self.record.traversal_kernels = self._traversal
            self.tracing = Tracing(self.record, self.device)
        workdir = pathlib.Path(tempfile.mkdtemp(prefix="portbench-"))
        try:
            if self.renderer is None:
                self.renderer = self.setup(workdir)
            self.kind.run(self, self.renderer, workdir)
            self.sync()
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        return self.record

    def run(self) -> RunRecord:
        """Set-up, the window, the peak memory; then the port's state is
        freed, so the check that follows has the card to itself."""
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        record = self.window()
        if self.device.type == "cuda":
            record.peak_mem_bytes = torch.cuda.max_memory_allocated()
        self.renderer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return record
