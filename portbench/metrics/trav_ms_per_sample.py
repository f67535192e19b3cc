"""trav_ms_per_sample (ms), and `trav_ms_per_sample.video`: device time
of the traversal kernels (K1/K2 in the still, K3/K4 in the video) a
film-wide sample."""

from portbench.lib import layers


def read(run):
    split = layers.split_traversal(run)
    if split is None or not run.profiled_samples or not split[0]:
        return None
    return layers.seconds(split[0]) * 1e3 / run.profiled_samples
