"""``sgd_leaves_kernel``'s share of its roofline: each launch's bound
(the (users, params) stack's parameters and gradients read once and its
parameters written once, ``param_bytes`` an element, at the HBM peak)
over its measured time, summed over the profiled phase's launches."""
from portbench.work.kernels import fused_sgd_bytes
from portbench.work.peaks import HBM_BW

KIND, UNIT, SOURCE, BETTER = "per_layer", "%", "device_trace", "higher"
LAYER = "kernels"


def read(r):
    k = r.kernel("sgd_leaves_kernel")
    if k is None or k[0] <= 0:
        return None
    secs, launches = k
    bound = launches * fused_sgd_bytes(r.users, r.params,
                                       r.param_bytes) / HBM_BW
    return 100.0 * bound / secs
