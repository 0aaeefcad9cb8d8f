"""Seconds of round 0's local step, the largest part of set-up: the
device time of the ``train`` span in the program's prologue (CUDA,
cuDNN and kernel start-up on the host, then the work), timed by its two
CUDA events; from the program's round recorder."""
from portbench.harness import recorder

KIND, UNIT, SOURCE, BETTER = "per_layer", "s", "device_trace", "lower"
LAYER = "local step"


def read(r):
    ms = recorder.span(recorder.prologue(r), "train", "device_ms")
    return None if ms is None else ms / 1e3
