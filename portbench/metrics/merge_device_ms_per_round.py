"""Device ms a round of the Eq. 1 merge: the program's ``merge`` span
(``_dispatch_sweep_merge``), timed by its two CUDA events; from the
program's round recorder, in the traced run's untraced window."""
from portbench.harness import recorder

KIND, UNIT, SOURCE, BETTER = "per_layer", "ms", "device_trace", "lower"
LAYER = "Eq. 1 merge"


def read(r):
    return recorder.span(recorder.window(r), "merge", "device_ms")
