"""shade_ms_per_sample (ms), and `shade_ms_per_sample.video`: integrator
device time, every kernel off the traversal list, per film-wide sample of
the profiled sub-window."""

from portbench.lib import layers


def read(run):
    split = layers.split_traversal(run)
    if split is None or not run.profiled_samples:
        return None
    return layers.seconds(split[1]) * 1e3 / run.profiled_samples
