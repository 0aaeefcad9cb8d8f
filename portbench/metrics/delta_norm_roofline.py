"""``delta_norm_kernel``'s share of its roofline: each launch (one a
round, every leaf of the users' stack against the global, ``param_bytes``
an element) bounded by its bytes at the HBM peak, over its measured
time."""
from portbench.work.kernels import delta_norm_bytes
from portbench.work.peaks import HBM_BW

KIND, UNIT, SOURCE, BETTER = "per_layer", "%", "device_trace", "higher"
LAYER = "kernels"


def read(r):
    k = r.kernel("delta_norm_kernel")
    if k is None or k[0] <= 0:
        return None
    secs, launches = k
    bound = launches * delta_norm_bytes(r.users, r.params, r.leaves,
                                        r.param_bytes) / HBM_BW
    return 100.0 * bound / secs
