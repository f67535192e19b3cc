"""trav_roofline (%), and `trav_roofline.video`: the least time the
traversal launches could take at the HBM3 peak (each ray in once, each
result out once, from their lane counts) over the time their kernels took;
nothing counted, nothing reported."""

from portbench.lib import layers


def read(run):
    split = layers.split_traversal(run)
    if split is None or not split[0] or not run.launches:
        return None
    least = (layers.least_traversal_bytes(run.launches)
             / layers.HBM_BYTES_PER_S)
    return 100.0 * least / layers.seconds(split[0])
