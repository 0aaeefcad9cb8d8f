"""Reading a ``torch.profiler`` window: device busy time (the union of
the device's operation intervals), device time and launches by operation
name, and the device's idle gaps, each named by the benchmark span that
was open on the host at the gap's midpoint (``engine`` where none was:
the engine's own loop)."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

SPAN_PREFIX = "portbench."


def _device_type_name(e) -> str:
    dt = getattr(e, "device_type", None)
    return getattr(dt, "name", str(dt))


def reduce(prof) -> dict:
    """``{"busy_s", "ops": {name: [seconds, count]}, "gaps": {span:
    seconds}}`` of a stopped profiler."""
    device: List[Tuple[float, float, str]] = []
    spans: List[Tuple[float, float, str]] = []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith(SPAN_PREFIX):
            # a span also shows on the device's timeline as an annotation:
            # it is no device operation
            if _device_type_name(e) != "CUDA":
                spans.append((tr.start, tr.end, e.name[len(SPAN_PREFIX):]))
        elif _device_type_name(e) == "CUDA":
            device.append((tr.start, tr.end, e.name))
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, t, name in device:
        ops[name][0] += (t - s) * 1e-6
        ops[name][1] += 1
    device.sort()
    merged: List[List[float]] = []
    for s, t, _ in device:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-6
    spans.sort(key=lambda sp: sp[0])
    gaps: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        open_ = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        # the innermost: the latest to open
        name = max(open_, key=lambda sp: sp[0])[2] if open_ else "engine"
        gaps[name] += (b - a) * 1e-6
    return {"busy_s": busy, "ops": dict(ops), "gaps": dict(gaps)}


def top(table: Dict, n: int = 10) -> List:
    """The ``n`` largest entries of ``{name: seconds}`` or ``{name:
    [seconds, count]}`` as ``[[name, seconds], ...]``."""
    secs = {k: (v[0] if isinstance(v, (list, tuple)) else v)
            for k, v in table.items()}
    return [[k, s] for k, s in sorted(secs.items(),
                                      key=lambda kv: -kv[1])[:n]]
