"""ms a round of selection: the span around ``FLEngine._select_lanes``
(counter shares and refrain masks, Eq. 3 windows and backoffs, CSMA
contention on the host or the device), synchronised on both sides."""
KIND, UNIT, SOURCE, BETTER = "per_layer", "ms", "host_clock", "lower"
LAYER = "selection"


def read(r):
    return r.span_ms("select")
