"""The port's round recorder: where a round loop's time goes, on the host
and on the device, and what each round launches and holds.

A round loop (``FLEngine._run_lanes``, ``_run_lanes_sparse``) runs under
``recorded``, which resets the recorder; the loop calls
``begin_round(t)`` at the head of iteration t, and what runs before the
first is the run's prologue (index ``PROLOGUE``). Code marks its phases
with ``span(name, host_only=...)``, a context manager. A span keeps its
name, its parent (the span open around it), its round, its start and end
on the host clock ``torch.profiler`` stamps its host events with
(``time.time_ns``: ``time.perf_counter_ns`` stamps, shifted by the
difference of the two clocks at the run's start, so a step of the wall
clock moves no duration) and, on a CUDA device, two timing events
recorded on the device's stream, from a pool the recorder reuses.

A span's ``device_ms`` is the time between its two events. An event
queued behind work completes when that work drains, so a span that
queues no device work (``host_only``) reads the device's idle time while
the host was inside it; any other span reads the device wall of its
work, gaps between its launches included.

Events are read only after a wait the program makes anyway: the code
that waits on the device calls ``synced(device)`` just after the wait,
which makes every round closed by then safe to read, and ``idle()``
just before a wait on work still queued, where the recorder reads them
while the device is busy (else the next sync does). The recorder adds no
synchronisation to a run and reads no event that may still be pending.
Its events go on the stream current when the run started. A run that
ends normally leaves its last round to be read after the run (the
reader waits for the device then); a run ended by an exception keeps
its closed rounds and drops the open one.

Per round the recorder keeps each span's host, self (host less its
children's) and device milliseconds, the kernel launches the round added
to ``kernels.ops.LAUNCHES`` (by kernel), the caching allocator's peak at
the round's end and, for the prologue and round 0, the peak at each
span's start and end. It keeps the prologue and the last ``KEEP``
rounds, from a run's start until the next run starts.
``summary(rounds)`` gives the mean per round over a range of round
indices. ``ENABLED`` switches the recorder for the runs that start
after it is set: off, a run records nothing.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

#: the recorder records the runs that start while this is true
ENABLED = True
#: rounds kept, the newest, besides the prologue
KEEP = 2 ** 16
#: a run's prologue: its set-up and what the loop queues before round 0
PROLOGUE = -1


def _new_event():
    return torch.cuda.Event(enable_timing=True)


def _current_stream(device):
    return torch.cuda.current_stream(device)


def _record(event, stream) -> None:
    event.record(stream)


def _peak(device) -> int:
    """``torch.cuda.max_memory_allocated``, without its flattening of
    every allocator statistic."""
    return torch.cuda.memory_stats_as_nested_dict(device)[
        "allocated_bytes"]["all"]["peak"]


def _wait(device) -> None:
    torch.cuda.synchronize(device)


class Round:
    """One closed round. ``layout`` is ``(names, parents, host_only)``:
    its spans in the order they opened, each one's parent position (-1:
    none) and whether it queues no device work. ``ns`` (n, 2): each
    span's start and end on the profiler's host clock; ``ms`` (n, 3):
    host, self and device ms (device NaN off CUDA). ``launches``: what
    the round added to each kernel's launch count (kernels it launched
    only); ``peak_bytes``: the allocator's peak when it closed (None off
    CUDA); ``span_peaks``: each span's peak at its start and at its end,
    in ``names``' order (the prologue and round 0 on CUDA, else None);
    ``wall_ms``: its first event to the next round's first (None without
    one)."""

    __slots__ = ("index", "layout", "ns", "ms", "launches", "peak_bytes",
                 "span_peaks", "wall_ms")

    def __init__(self, index: int, layout, ns, ms,
                 launches: Dict[str, int], peak_bytes: Optional[int] = None,
                 span_peaks=None, wall_ms: Optional[float] = None):
        self.index, self.layout, self.ns, self.ms = index, layout, ns, ms
        self.launches, self.peak_bytes = launches, peak_bytes
        self.span_peaks, self.wall_ms = span_peaks, wall_ms

    @property
    def names(self) -> Tuple[str, ...]:
        return self.layout[0]

    @property
    def parents(self) -> Tuple[int, ...]:
        return self.layout[1]

    @property
    def host_only(self) -> Tuple[bool, ...]:
        return self.layout[2]


class _Span:
    __slots__ = ("rec", "name", "host_only", "owner", "pos")

    def __init__(self, rec, name: str, host_only: bool):
        self.rec, self.name, self.host_only = rec, name, host_only

    def __enter__(self):
        self.owner, self.pos = self.rec._open(self.name, self.host_only)
        return self

    def __exit__(self, *exc):
        self.rec._close(self.owner, self.pos)
        return False


_NULL = contextlib.nullcontext()


class Recorder:
    """The store and the open round of the current run (``RECORDER`` is
    the process's one). On CUDA a closed round waits, as it closed, until
    a sync makes its events safe to read; it is built and stored then, off
    the device's critical path."""

    def __init__(self):
        self.device = None             # the CUDA device marked, or None
        self._pool: List = []          # resolved events of the device
        self._reset(None, False)

    def _reset(self, device, active: bool):
        if device != self.device:
            self._pool = []
        self.device = device
        self.active = active
        self.prologue: Optional[Round] = None
        self.rounds = collections.deque(maxlen=KEEP)
        self._stream = None
        self._origin = 0                   # profiler clock - perf_counter
        self._pending: List[tuple] = []    # closed, events maybe pending
        self._safe: List[tuple] = []       # closed before the last sync
        self._safe_after = None            # the next round's first event
        self._layouts: dict = {}
        self._after = None                 # first event of a dropped round
        self._index = PROLOGUE
        self._spans: List[list] = []
        self._stack: List[int] = []
        self._peaks = False            # read the peak at each span's ends
        self._counts: Dict[str, int] = {}
        self._launch0: Dict[str, int] = {}

    # ----------------------------------------------------------- a run
    def start(self, device) -> None:
        """Reset, and record a run on ``device`` if ``ENABLED``."""
        dev = None if device is None else torch.device(device)
        if dev is not None and dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._reset(dev if dev is not None and dev.type == "cuda" else None,
                    ENABLED)
        if self.active:
            from repro_torch.kernels import ops
            self._counts = ops.LAUNCHES
            if self.device is not None:
                self._stream = _current_stream(self.device)
            self._origin = time.time_ns() - time.perf_counter_ns()
            self._open_round(PROLOGUE)

    def finish(self, dropped: bool) -> None:
        """End the run: keep the open round, or drop it (``dropped``)."""
        if not self.active:
            return
        if not dropped:
            self._close_round()
        elif self._spans and self.device is not None:
            self._after = self._spans[0][5]
        self.active, self._spans, self._stack = False, [], []

    def begin_round(self, t: int) -> None:
        if not self.active:
            return
        if self._stack:
            raise RuntimeError(f"round {t} begins inside the span "
                               f"{self._spans[self._stack[-1]][0]!r}")
        self._close_round()
        self._open_round(t)

    def _open_round(self, index: int) -> None:
        self._index, self._spans = index, []
        self._launch0 = dict(self._counts)
        self._peaks = self.device is not None and index in (PROLOGUE, 0)

    def _close_round(self) -> None:
        before = self._launch0
        launches = {k: v - before.get(k, 0) for k, v in self._counts.items()
                    if v != before.get(k, 0)}
        closed = (self._index, self._spans, launches,
                  _peak(self.device) if self.device is not None else None,
                  self._peaks)
        if self.device is None:
            self._store(closed, None, None)
        else:
            self._pending.append(closed)

    def _store(self, closed, device_ms, wall_ms) -> None:
        index, spans, launches, peak, peaks = closed
        key = (tuple(s[0] for s in spans), tuple(s[1] for s in spans),
               tuple(s[2] for s in spans))
        layout = self._layouts.setdefault(key, key)
        ns = np.array([(s[3], s[4]) for s in spans], np.int64).reshape(-1, 2)
        ms = np.full((len(spans), 3), np.nan)
        ms[:, 0] = (ns[:, 1] - ns[:, 0]) * 1e-6
        ms[:, 1] = ms[:, 0]
        for i, s in enumerate(spans):
            if s[1] >= 0:
                ms[s[1], 1] -= ms[i, 0]
        if device_ms is not None:
            ms[:, 2] = device_ms
        r = Round(index, layout, ns + self._origin, ms, launches, peak,
                  [(s[7], s[8]) for s in spans] if peaks else None, wall_ms)
        if index == PROLOGUE:
            self.prologue = r
        else:
            self.rounds.append(r)

    # ----------------------------------------------------------- spans
    def _mark(self):
        event = self._pool.pop() if self._pool else _new_event()
        _record(event, self._stream)
        return event

    def _open(self, name: str, host_only: bool):
        spans = self._spans
        pos = len(spans)
        event = self._mark() if self.device is not None else None
        spans.append([name, self._stack[-1] if self._stack else -1,
                      bool(host_only), time.perf_counter_ns(), 0, event,
                      None, _peak(self.device) if self._peaks else None,
                      None])
        self._stack.append(pos)
        return spans, pos

    def _close(self, owner: list, pos: int) -> None:
        if owner is not self._spans:   # the run or round ended under it
            return
        s = owner[pos]
        s[4] = time.perf_counter_ns()
        if self.device is not None:
            s[6] = self._mark()
            if self._peaks:
                s[8] = _peak(self.device)
        self._stack.pop()

    # ------------------------------------------------------ resolution
    def synced(self, device) -> None:
        """``device``'s stream just drained: every event recorded so far
        has completed. The rounds closed by now are safe to read; they are
        resolved at the next ``idle``, or at the next sync."""
        if not (self._pending or self._safe) or device is None:
            return
        dev = torch.device(device)
        if dev.type != "cuda":
            return
        index = (dev.index if dev.index is not None
                 else torch.cuda.current_device())
        if index != self.device.index:
            return
        self._resolve(self._safe, self._safe_after)
        self._safe, self._pending = self._pending, []
        self._safe_after = (self._spans[0][5] if self.active and self._spans
                            else self._after)

    def idle(self) -> None:
        """The host is about to wait for queued device work: resolve the
        rounds a sync made safe, off the device's critical path."""
        if self._safe:
            self._resolve(self._safe, self._safe_after)
            self._safe = []

    def _resolve(self, closed: List[tuple], after) -> None:
        """Read the events of the ``closed`` rounds (in order) and store
        them; ``after`` is the first event of the round that follows the
        last of them (None: unknown)."""
        for i, c in enumerate(closed):
            nxt = after
            if i + 1 < len(closed):
                nxt = closed[i + 1][1][0][5] if closed[i + 1][1] else None
            spans = c[1]
            self._store(c, [s[5].elapsed_time(s[6]) for s in spans],
                        spans[0][5].elapsed_time(nxt)
                        if spans and nxt is not None else None)
            self._pool.extend(e for s in spans for e in (s[5], s[6]))

    def settle(self) -> None:
        """After a run, resolve what it left unresolved (waiting for the
        device); during one, nothing."""
        if (self._safe or self._pending) and not self.active:
            _wait(self.device)
            self._resolve(self._safe, self._safe_after)
            self._resolve(self._pending, self._after)
            self._safe, self._pending = [], []

    # ---------------------------------------------------------- reading
    def kept(self) -> List[Round]:
        """The kept rounds, prologue first (during a run, those resolved
        so far)."""
        self.settle()
        head = [self.prologue] if self.prologue is not None else []
        return head + list(self.rounds)

    def summary(self, rounds: Iterable[int]) -> Optional[dict]:
        want = set(rounds)
        got = [r for r in self.kept() if r.index in want]
        if not got:
            return None
        n = len(got)
        spans: Dict[str, dict] = {}
        launches: collections.Counter = collections.Counter()
        for r in got:
            names, parents, host_only = r.layout
            for i, name in enumerate(names):
                e = spans.get(name)
                if e is None:
                    e = spans[name] = {
                        "host_ms": 0.0, "self_ms": 0.0, "device_ms": 0.0,
                        "host_only": True,
                        "parent": names[parents[i]] if parents[i] >= 0
                        else None}
                h, s, d = (float(x) for x in r.ms[i])
                e["host_ms"] += h
                e["self_ms"] += s
                e["device_ms"] += d
                e["host_only"] = e["host_only"] and host_only[i]
            launches.update(r.launches)
        for e in spans.values():
            for k in ("host_ms", "self_ms", "device_ms"):
                e[k] /= n
            if np.isnan(e["device_ms"]):
                e["device_ms"] = None
        peaks = [r.peak_bytes for r in got if r.peak_bytes is not None]
        walls = [r.wall_ms for r in got if r.wall_ms is not None]
        return {"rounds": n, "spans": spans,
                "launches": sum(launches.values()) / n,
                "launches_by_kernel": {k: v / n for k, v in launches.items()},
                "peak_bytes": sum(peaks) / len(peaks) if peaks else None,
                "wall_ms": sum(walls) / len(walls) if walls else None}


#: the process's recorder
RECORDER = Recorder()


def span(name: str, host_only: bool = False):
    """A context manager recording the block as span ``name`` of the open
    round; ``host_only``: the block queues no device work. Outside a
    recorded run it records nothing."""
    rec = RECORDER
    return _Span(rec, name, host_only) if rec.active else _NULL


def begin_round(t: int) -> None:
    """Close the open round (the prologue before round 0) and open round
    ``t``; call it at the head of iteration t, outside every span."""
    RECORDER.begin_round(t)


def synced(device) -> None:
    """Tell the recorder that ``device``'s current stream just drained:
    call it right after a wait the program makes."""
    RECORDER.synced(device)


def idle() -> None:
    """Tell the recorder that the host is about to wait for work it
    queued: it reads the events a sync has made safe then."""
    RECORDER.idle()


def recorded(loop):
    """``loop``, a round-loop method of an engine, run under the
    recorder: reset at its start, on the engine backend's device."""
    @functools.wraps(loop)
    def run(engine, *args, **kwargs):
        RECORDER.start(getattr(engine.backend, "device", None))
        try:
            out = loop(engine, *args, **kwargs)
        except BaseException:
            RECORDER.finish(dropped=True)
            raise
        RECORDER.finish(dropped=False)
        return out
    return run


def summary(rounds: Iterable[int]) -> Optional[dict]:
    """The mean per round over the kept rounds whose index is in
    ``rounds`` (``PROLOGUE`` for the prologue): ``{"rounds": n, "spans":
    {name: {"host_ms", "self_ms", "device_ms", "host_only", "parent"}},
    "launches", "launches_by_kernel": {kernel: launches}, "peak_bytes",
    "wall_ms"}`` (``device_ms``, ``peak_bytes`` and ``wall_ms`` None off
    CUDA); None when no such round is kept."""
    return RECORDER.summary(rounds)


def kept() -> List[Round]:
    """The kept rounds, the prologue first."""
    return RECORDER.kept()


def peak_span(index: int = 0) -> Optional[Tuple[str, int]]:
    """``(span, bytes)``: the innermost span during which round
    ``index`` raised the allocator's peak to its value at the round's end
    (kept for the prologue and round 0 on CUDA); None where the round
    raised no peak inside a span."""
    r = next((r for r in RECORDER.kept() if r.index == index), None)
    if r is None or not r.span_peaks:
        return None
    top = r.peak_bytes
    inside = [i for i, (a, b) in enumerate(r.span_peaks) if a < top <= b]
    return (r.names[inside[-1]], top) if inside else None
