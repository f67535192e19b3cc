"""launches_per_sample (launches), and `launches_per_sample.video`:
kernel launches the profiler saw, per film-wide sample."""

from portbench.lib import layers


def read(run):
    kernels = layers.window_kernels(run)
    if kernels is None or not run.profiled_samples:
        return None
    return len(kernels) / run.profiled_samples
