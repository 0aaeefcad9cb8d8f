"""ms a round the card sat idle while the host was in a phase that
queues no device work (the program's host-only spans: the batch draws'
permutations, NumPy selection, the uploads, the book-keeping): the sum
of those spans' device time between their two CUDA events, an event
queued behind work completing when the work drains; from the program's
round recorder, in the traced run's untraced window."""
from portbench.harness import recorder

KIND, UNIT, SOURCE, BETTER = "per_layer", "ms", "device_trace", "lower"
LAYER = "device"


def read(r):
    s = recorder.window(r)
    if s is None:
        return None
    spans = s["spans"]
    idle = [e["device_ms"] for e in spans.values() if e["host_only"]
            and not (e["parent"] and spans[e["parent"]]["host_only"])]
    if not idle or any(d is None for d in idle):
        return None
    return sum(idle)
