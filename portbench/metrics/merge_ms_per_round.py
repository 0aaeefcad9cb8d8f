"""ms a round of the Eq. 1 merge: the span around
``HostBackend.sweep_merge`` (the winners' rows through ``combine_kernel``
and the new global broadcast over the stack), synchronised on both
sides."""
KIND, UNIT, SOURCE, BETTER = "per_layer", "ms", "host_clock", "lower"
LAYER = "Eq. 1 merge"


def read(r):
    return r.span_ms("merge")
