"""Host ms a round spent waiting for the card: the program's own spans
``read`` (round t's priorities and losses, the loop's one read) and
``eval.wait`` (the evaluation's ``int(correct)``), from its round
recorder, in the traced run's untraced window."""
from portbench.harness import recorder

KIND, UNIT, SOURCE, BETTER = "per_layer", "ms", "host_clock", "lower"
LAYER = "whole round"


def read(r):
    s = recorder.window(r)
    waits = [recorder.span(s, n, "host_ms") for n in ("read", "eval.wait")]
    waits = [w for w in waits if w is not None]
    return sum(waits) if waits else None
