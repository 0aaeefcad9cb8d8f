"""Share of the profiled phase in which no operation ran on the device:
1 - busy / window, busy the union of the trace's device intervals (the
profiler's own host cost is in it)."""
KIND, UNIT, SOURCE, BETTER = "per_layer", "%", "device_trace", "lower"
LAYER = "device"


def read(r):
    t = r.timing
    if not t.profile or t.profiled_s <= 0:
        return None
    return 100.0 * (1.0 - t.profile["busy_s"] / t.profiled_s)
