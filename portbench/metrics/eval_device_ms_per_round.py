"""Device ms a round of the evaluation: the program's ``eval`` span
(``_eval_lanes``: the 1000 test examples' forward passes, then the wait
for the correct count), timed by its two CUDA events; from the program's
round recorder, in the traced run's untraced window."""
from portbench.harness import recorder

KIND, UNIT, SOURCE, BETTER = "per_layer", "ms", "device_trace", "lower"
LAYER = "evaluation"


def read(r):
    return recorder.span(recorder.window(r), "eval", "device_ms")
