"""samples_per_s (Msamples/s), and `samples_per_s.video`: pixel samples
added to the film over the whole window, over the window's time (first
step's start to the last step's end; a video's frames, one sample each,
from the first render to the last hand-off)."""


def read(run):
    if not run.window_s:
        return None
    return run.samples * run.pixels / run.window_s / 1e6
