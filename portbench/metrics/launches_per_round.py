"""Hand-written kernel launches a round (``kernels.ops.LAUNCHES``, one
counted where a wrapper launches its kernel), as the program's round
recorder counts them, in the traced run's untraced window."""
from portbench.harness import recorder

KIND, UNIT, SOURCE, BETTER = "per_layer", "launches", "host_clock", "lower"
LAYER = "kernels"


def read(r):
    s = recorder.window(r)
    return None if s is None else s["launches"]
