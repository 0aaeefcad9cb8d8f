"""Device ms a round of the local step: the program's ``train`` span
(``HostBackend.sweep_train`` queuing round t+1's local SGD and Eq. 2),
timed by its two CUDA events; from the program's round recorder, in the
traced run's untraced window."""
from portbench.harness import recorder

KIND, UNIT, SOURCE, BETTER = "per_layer", "ms", "device_trace", "lower"
LAYER = "local step"


def read(r):
    return recorder.span(recorder.window(r), "train", "device_ms")
