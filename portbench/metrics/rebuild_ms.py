"""rebuild_ms (ms): device time of a frame's update_scene_data and its
accel rebuild (Renderer._ensure_accel), between CUDA events; the median
of each over the traced run's frames, added."""

import numpy as np


def read(run):
    if run.kind != "video":
        return None
    ms = [run.event_ms.get(n) for n in ("update", "rebuild")]
    if not all(ms):
        return None
    return float(sum(np.median(m) for m in ms))
