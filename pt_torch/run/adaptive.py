"""Adaptive samples-per-frame controller.

Port of `pt.run.adaptive` (≙ the reference's refresh-rate-targeted
controller, Renderer::OnUpdate, Renderer.cpp:1615-1657): it keeps the last
MinRefreshRate frame times; while their sum stays below about one second
the frame rate is above target, and after 2 s of stability the samples per
frame rise by one; above the threshold they fall by one after 10 s. The
thresholds and the hysteresis are `pt`'s.
"""

from __future__ import annotations

from collections import deque


class AdaptiveSampleController:
    def __init__(self, min_refresh_rate: float = 60.0,
                 max_samples_per_frame: int = 64):
        self.min_refresh_rate = max(1.0, min_refresh_rate)
        self.max_samples_per_frame = max_samples_per_frame
        self.samples_per_frame = 1
        self._timings: deque = deque()
        self._time_sum = 0.0
        self._since_reset = 0.0
        self._increase_threshold = 0.0   # the first increase may come at once
        self._decrease_threshold = 1.0

    def on_update(self, dt: float) -> int:
        """Feed one frame time; returns the samples per frame to use."""
        window = int(self.min_refresh_rate)
        if len(self._timings) == window:
            self._time_sum -= self._timings.popleft()
        self._time_sum += dt
        self._timings.append(dt)

        threshold = (self.min_refresh_rate + 1) / self.min_refresh_rate

        if (self._since_reset > self._increase_threshold
                and self._time_sum < threshold
                and self.samples_per_frame < self.max_samples_per_frame):
            self._increase_threshold = 2.0
            self.samples_per_frame += 1
            self._since_reset = 0.0
        elif (self._since_reset > self._decrease_threshold
              and self._time_sum > threshold
              and self.samples_per_frame > 1):
            self._increase_threshold = 10.0
            self.samples_per_frame -= 1
            self._since_reset = 0.0
        else:
            self._since_reset += dt
        return self.samples_per_frame
