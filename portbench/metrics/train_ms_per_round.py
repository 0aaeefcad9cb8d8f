"""ms a round of the local step: the span around
``HostBackend.sweep_train`` (every user's local SGD epoch through
``vmap(grad)`` and ``fused_sgd``, then Eq. 2's sums), closed by a
``synchronize`` on both sides; read in the traced run's spans phase."""
KIND, UNIT, SOURCE, BETTER = "per_layer", "ms", "host_clock", "lower"
LAYER = "local step"


def read(r):
    return r.span_ms("train")
