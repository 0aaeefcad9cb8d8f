"""The whole round's share of the card's peak in the configuration's
compute dtype (``Reading.peak_flops``: 67 TFLOP/s for f32 with TF32 off,
outside the tensor cores; 989 TFLOP/s for bf16; the run prints the
card's power limit beside it): the window's FLOPs (the kind's count from
shapes: three forward passes a trained example or token of every local
step, one an evaluated one) over the window's seconds, in the traced
run's untraced window."""
KIND, UNIT, SOURCE, BETTER = "per_layer", "%", "host_clock", "higher"
LAYER = "whole round"


def read(r):
    t = r.timing
    if t.window_s <= 0:
        return None
    f = r.round_flops
    flops = (f["train"] + f["eval"]) * t.window_rounds
    return 100.0 * flops / t.window_s / r.peak_flops
