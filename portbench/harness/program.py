"""Driving the program under test, ``repro_torch``, through its entry:
``engine.build_host_engine(spec, init, loss_fn, user_data, eval_fn)``
then ``FLEngine.run()`` (on a fused cell the E = 1 sweep loop).

The cell's kind (``kinds/<kind>.py::program``) gives the program's
pieces: the loss, the users' data and the evaluation. One ``run()`` call
holds the whole run. Its evaluation callback, which the engine calls
once a round, is wrapped: after the program's own evaluation (every
round) and a ``synchronize``, the round counts, and the wrapper moves
the run through its phases:

* warm-up: the first ``warmup_rounds`` rounds, set-up; the first
  ``checked_rounds`` of them are captured for the reference;
* window: rounds back to back (closed loop) until ``seconds`` have passed
  since the warm-up's last round; every round in it counts, over all of
  its time;
* traced runs only: a profiled phase (``torch.profiler``, the benchmark's
  spans as ``record_function`` ranges, no added synchronisation), then a
  spans phase (each span around a call into a layer is closed by a
  ``synchronize``, except the host draw's), each at least ``PHASE_S``
  seconds and two rounds.

The run ends by raising ``WindowClosed`` from the callback. The spans
wrap the engine's and the backend's methods on their instances; the
program's code is not touched.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from . import trace as trace_mod
from ..reference.fl import RoundRecord, change_norms, leaf_norms

#: seconds of each traced phase (profiled, then synchronised spans)
PHASE_S = 2.0
#: rounds the engine is given: the window closes the run long before
ROUNDS = 10 ** 9


class Pieces(NamedTuple):
    """The program's pieces that a cell's kind gives
    ``build_host_engine``: the loss, the users' data and the
    evaluation."""
    loss: Callable
    users: list
    evaluate: Callable


class WindowClosed(Exception):
    """Raised from the evaluation callback when the run's phases are
    done."""


def nested(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"fc1.w": t}`` -> ``{"fc1": {"w": t}}`` (the program's trees)."""
    out: dict = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}{k}."))
    return out


@dataclass
class Timing:
    """What a run measured: set-up seconds; the window's rounds and
    seconds; the program's memory peak; with a trace, the profiled
    phase's rounds, seconds and reduced trace, and the spans phase's
    rounds and seconds a span name."""
    setup_s: float = 0.0
    window_rounds: int = 0
    window_s: float = 0.0
    peak_bytes: int = 0
    rounds_run: int = 0
    profiled_rounds: int = 0
    profiled_s: float = 0.0
    profile: Optional[dict] = None
    span_rounds: int = 0
    spans: Dict[str, float] = field(default_factory=dict)
    #: seconds from process start at which set-up's steps ended
    stamps: Dict[str, float] = field(default_factory=dict)


class Run:
    """One run of the program on ``inputs``. ``patch(engine)``, when
    given, runs after the engine is built and before the spans are put
    on (the tests plant faults underneath the timed path with it)."""

    def __init__(self, cell, inputs, seed: int, device, seconds: float,
                 trace: bool, t0: float,
                 patch: Optional[Callable] = None):
        self.cell, self.inputs, self.seed = cell, inputs, int(seed)
        self.device = torch.device(device)
        self.seconds, self.trace, self.t0 = float(seconds), trace, t0
        self.patch = patch
        self.timing = Timing()
        self.records: List[RoundRecord] = []
        self._pending: Dict[int, dict] = {}
        self._calls = {"train": 0, "select": 0, "merge": 0}
        self._phase = "warmup"
        self._round = 0
        self._mark = 0.0
        self._n = 0
        self._prof = None

    # ------------------------------------------------------------ build
    def build(self):
        from repro_torch.engine import ExperimentSpec, build_host_engine

        prog = self.cell.kind.program(self.cell, self.inputs, self.device)
        self._evaluate = prog.evaluate
        spec = ExperimentSpec(rounds=ROUNDS, seed=self.seed,
                              **self.cell.spec)
        self.engine = build_host_engine(
            spec, nested(dict(self.inputs.init)), prog.loss, prog.users,
            self._eval, device=self.device)
        self.backend = self.engine.backend
        if self.patch is not None:
            self.patch(self.engine)
        self._wrap()
        self.timing.stamps["engine"] = time.perf_counter() - self.t0
        return self

    # ------------------------------------------------------------ spans
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _span(self, name: str, fn: Callable, sync: bool) -> Callable:
        def wrapped(*a, **kw):
            if self._phase == "profile":
                with torch.profiler.record_function(
                        trace_mod.SPAN_PREFIX + name):
                    return fn(*a, **kw)
            if self._phase != "spans":
                return fn(*a, **kw)
            if sync:
                self._sync()
            s = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                self._sync()
            self.timing.spans[name] = (self.timing.spans.get(name, 0.0)
                                       + time.perf_counter() - s)
            return out
        return wrapped

    def _wrap(self):
        be, en = self.backend, self.engine
        be._draw_perms = self._span("draw", be._draw_perms, sync=False)
        be._gather_rows = self._span("draw", be._gather_rows, sync=False)
        train = self._span("train", be.sweep_train, sync=True)
        select = self._span("select", en._select_lanes, sync=True)
        merge = self._span("merge", be.sweep_merge, sync=True)

        def sweep_train(st, batched, need):
            r = self._calls["train"]
            self._calls["train"] += 1
            if r < self.checked:
                # the round's starting global: the trained models' anchor
                self._pending[r] = {"start": dict(flatten(st.glob[0]))}
            return train(st, batched, need)

        def select_lanes(lanes, counters, prios64, t):
            winners_all, sels = select(lanes, counters, prios64, t)
            r = self._calls["select"]
            self._calls["select"] += 1
            if r < self.checked:
                self._pending[r]["winners"] = list(winners_all[0])
            return winners_all, sels

        epoch_run = be._epoch_run

        def first_losses(stack, batched, *a, **kw):
            out = epoch_run(stack, batched, *a, **kw)
            r = self._calls["train"] - 1
            if 0 <= r < self.checked:
                # the users' losses on the round's first batch
                first = out[1][:, 0].double()
                self._pending[r]["first"] = first.cpu().numpy()
            return out

        def sweep_merge(st, tr, *a, **kw):
            r = self._calls["merge"]
            self._calls["merge"] += 1
            if r < self.checked:
                self._capture(r, tr)
            return merge(st, tr, *a, **kw)

        be.sweep_train, en._select_lanes = sweep_train, select_lanes
        be.sweep_merge, be._epoch_run = sweep_merge, first_losses

    @property
    def checked(self) -> int:
        return self.cell.workload["checked_rounds"]

    def _capture(self, r: int, tr):
        """Round r's trained models (their change norms from the round's
        global), losses and priorities, read before the merge overwrites
        the stack."""
        prios, losses = tr.read()
        p = self._pending[r]
        stack = {k: v[0] for k, v in flatten(tr.trained).items()}
        with torch.no_grad():
            p["local"] = change_norms(stack, p["start"])
        p["loss"], p["prio"] = losses[0].copy(), prios[0].copy()

    # ------------------------------------------------------- the rounds
    def _eval(self, params):
        if self._phase == "profile":
            with torch.profiler.record_function(
                    trace_mod.SPAN_PREFIX + "eval"):
                acc = self._evaluate(params)
        else:
            acc = self._evaluate(params)
        self._sync()
        now = time.perf_counter()
        r, self._round = self._round, self._round + 1
        if r == 0:
            self.timing.stamps["round0"] = now - self.t0
        if r < self.checked:
            p = self._pending.pop(r)
            self.records.append(RoundRecord(
                loss=p["loss"], first_loss=p["first"], prio=p["prio"],
                winners=p["winners"], local=p["local"],
                change=leaf_norms(flatten(params), self.inputs.init_host)))
        self._advance(now)
        return acc

    def _advance(self, now: float):
        w = self.cell.workload["warmup_rounds"]
        t = self.timing
        if self._phase == "warmup":
            if self._round >= w:
                t.setup_s = t.stamps["warmup"] = now - self.t0
                self._phase, self._mark, self._n = "window", now, 0
                if self.seconds <= 0:
                    self._close(now)
            return
        self._n += 1
        elapsed = now - self._mark
        if self._phase == "window" and elapsed >= self.seconds:
            t.window_rounds, t.window_s = self._n, elapsed
            if not self.trace:
                self._close(now)
            self._phase, self._n = "profile", 0
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._mark = time.perf_counter()
        elif (self._phase == "profile" and elapsed >= PHASE_S
              and self._n >= 2):
            t.profiled_rounds, t.profiled_s = self._n, elapsed
            self._prof.stop()
            self._phase, self._n = "spans", 0
            self._mark = time.perf_counter()
        elif self._phase == "spans" and elapsed >= PHASE_S and self._n >= 2:
            t.span_rounds = self._n
            self._close(now)

    def _close(self, now: float):
        self.timing.rounds_run = self._round
        if self.device.type == "cuda":
            self.timing.peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
        raise WindowClosed

    def go(self) -> Timing:
        """Run to the window's close; then free the program's state."""
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.build()
        try:
            self.engine.run()
        except WindowClosed:
            pass
        else:
            raise RuntimeError("the engine ended before the window closed")
        self._sync()
        if self._prof is not None:
            self.timing.profile = trace_mod.reduce(self._prof)
            self._prof = None
        self.engine = self.backend = self._evaluate = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return self.timing
