"""Host ms a round in the round backend's batch draws: the spans around
``HostBackend._draw_perms`` (the users' epoch permutations, NumPy) and
``_gather_rows`` (the index upload and the device gather's launch), no
synchronisation; read in the traced run's spans phase."""
KIND, UNIT, SOURCE, BETTER = "per_layer", "ms", "host_clock", "lower"
LAYER = "round backend, host"


def read(r):
    return r.span_ms("draw")
