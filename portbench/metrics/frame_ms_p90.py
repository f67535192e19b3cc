"""frame_ms_p90 (ms): the 90th percentile over every frame of the window,
a frame running from the previous frame's hand-off to the saver to its own
(update, rebuild, render, snapshot)."""

import numpy as np


def read(run):
    if run.kind != "video" or not run.frames:
        return None
    ms = [(end - start) * 1e3 for start, end in run.frames]
    return float(np.percentile(ms, 90))
