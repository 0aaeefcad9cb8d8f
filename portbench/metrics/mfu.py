"""The whole round's share of the card's f32 peak (67 TFLOP/s, outside
the tensor cores; the run prints the card's power limit beside it): the
window's FLOPs (three forward passes an example of every local step, one
of every evaluated test example, counted from shapes) over the window's
seconds, in the traced run's untraced window."""
from portbench.work.peaks import PEAK_FLOPS_F32

KIND, UNIT, SOURCE, BETTER = "per_layer", "%", "host_clock", "higher"
LAYER = "whole round"


def read(r):
    t = r.timing
    if t.window_s <= 0:
        return None
    f = r.round_flops
    flops = (f["train"] + f["eval"]) * t.window_rounds
    return 100.0 * flops / t.window_s / PEAK_FLOPS_F32
