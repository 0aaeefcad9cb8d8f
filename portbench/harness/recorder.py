"""The program's own round recorder (``repro_torch.trace``), read after
a run: the mean per round over the traced run's untraced window, or over
the run's prologue. The loop's iteration t is the run's t-th evaluation,
so the window holds rounds ``warmup_rounds`` ...
``warmup_rounds + window_rounds - 1``; the last of them is left out, as
its evaluation callback starts the profiler inside the program's
``eval`` span. Each reader gives None where the program has no recorder
or the recorder holds no such round, and a device reading None off
CUDA."""
from __future__ import annotations

from typing import Iterable, Optional


def _summary(rounds: Iterable[int]) -> Optional[dict]:
    try:
        from repro_torch import trace
    except ImportError:        # a program without the recorder
        return None
    return trace.summary(rounds)


def window(r) -> Optional[dict]:
    w = r.cell.workload["warmup_rounds"]
    return _summary(range(w, w + r.timing.window_rounds - 1))


def prologue(r) -> Optional[dict]:
    """The run's set-up and what its loop queued before round 0."""
    return _summary([-1])


def span(summary: Optional[dict], name: str, key: str):
    """``key`` (``host_ms``, ``self_ms``, ``device_ms``) of span ``name``
    a round, or None."""
    if summary is None or name not in summary["spans"]:
        return None
    return summary["spans"][name][key]
