"""The port's round recorder (``repro_torch.trace``) on the CPU.

Through the engine: the spans of ``FLEngine._run_lanes`` in order and
nesting, every simple statement of an iteration inside a top-level span,
round indices matching the evaluations, the same bits with the recorder
on and off, nothing recorded off, an exception from the evaluation
keeping exactly the completed rounds, the bounded store, the sparse
loop's ``prepass``. On ``torch.profiler``'s host clock: a span's stamps
bracket a range opened inside it. The device path's resolution rules,
with stand-in CUDA events: no event is read before a wait, the round's
wall, the event pool, and the run's end.
"""
import ast
import inspect
import sys
import time
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import engine as teng, trace
from repro_torch.convert import params_from_numpy
from repro_torch.engine.engine import FLEngine

USERS, N, DIM, CLASSES = 8, 32, 6, 3


def _data():
    rng = np.random.default_rng(3)
    return [{"x": rng.normal(size=(N, DIM)).astype(np.float32),
             "y": rng.integers(0, CLASSES, N)} for _ in range(USERS)]


def _init():
    return params_from_numpy(
        {"w": np.zeros((DIM, CLASSES), np.float32),
         "b": np.zeros(CLASSES, np.float32)}, device="cpu")


def _apply(p, x):
    return x @ p["w"] + p["b"]


def _loss(p, batch):
    logp = torch.log_softmax(_apply(p, batch["x"]), -1)
    return -logp.gather(-1, batch["y"].long()[:, None]).mean()


class _Stop(Exception):
    pass


class _Eval:
    """``make_accuracy_eval`` that stamps each call (and raises at call
    ``fail``)."""

    def __init__(self, fail=None):
        rng = np.random.default_rng(5)
        self.fn = teng.make_accuracy_eval(
            _apply, rng.normal(size=(40, DIM)).astype(np.float32),
            rng.integers(0, CLASSES, 40), device="cpu")
        self.stamps, self.fail = [], fail

    def __call__(self, params):
        if len(self.stamps) == self.fail:
            raise _Stop
        self.stamps.append(time.time_ns())
        return self.fn(params)


def _engine(rounds=4, eval_fn=None, **kw):
    spec = teng.ExperimentSpec(rounds=rounds, seed=1, batch_size=8,
                               strategy="priority-distributed", **kw)
    return teng.build_host_engine(spec, _init(), _loss, _data(), eval_fn,
                                  device="cpu")


def _specs(rounds):
    return [teng.ExperimentSpec(rounds=rounds, seed=s, batch_size=8,
                                strategy=st) for s, st in
            ((1, "priority-distributed"), (2, "random-distributed"))]


#: the loops under test: (name, lanes, call(engine, rounds, tmp_path))
LOOPS = {
    "run": (1, lambda e, r, d: e.run()),
    "sweep2": (2, lambda e, r, d: e.run_sweep(_specs(r))),
    "sweep2-serial": (2, lambda e, r, d: e.run_sweep(_specs(r),
                                                     overlap=False)),
    "run-checkpoint": (1, lambda e, r, d: e.run(checkpoint_dir=str(d),
                                                checkpoint_every=2)),
}


def _expected(t, rounds, lanes, loop):
    """Round t's spans as (name, parent name) in the order they open."""
    last = t + 1 >= rounds
    draw = [("draw", None)]
    if not last:
        draw += [("draw.perms", "draw"), ("draw.gather", "draw")]
    serial = loop == "sweep2-serial"
    out = ([("draw", None)] if serial else draw) + [
        ("read", None), ("select", None), ("uploads", None),
        ("merge", None)]
    if not last:
        out += (draw if serial else []) + [("train", None)]
    out += [("book", None), ("eval", None)] + [("eval.wait", "eval")] * lanes
    if loop == "run-checkpoint" and (t + 1) % 2 == 0 and not last:
        out += [("checkpoint", None)]
    return out


def _names(r):
    return [(n, r.names[p] if p >= 0 else None)
            for n, p in zip(r.names, r.parents)]


def _loop_lines():
    """Line numbers of the simple statements in ``_run_lanes``' loop
    body, but ``begin_round``'s."""
    fn = FLEngine._run_lanes.__wrapped__
    src = textwrap.dedent(inspect.getsource(fn))
    loop = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.For) and ast.unparse(n.target) == "t")
    compound = (ast.If, ast.For, ast.While, ast.With, ast.Try)
    lines = set()
    for stmt in loop.body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.stmt) and not isinstance(n, compound) \
                    and "begin_round" not in ast.unparse(n):
                lines.add(n.lineno + fn.__code__.co_firstlineno - 1)
    return fn.__code__, lines


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_spans_tile_each_iteration_in_order(loop, tmp_path):
    lanes, call = LOOPS[loop]
    rounds = 4
    ev = _Eval()
    eng = _engine(rounds, ev)
    code, lines = _loop_lines()
    seen = []

    def local(frame, event, arg):
        if event == "line" and frame.f_lineno in lines:
            seen.append((frame.f_lineno, bool(trace.RECORDER._stack)))
        return local

    def tracer(frame, event, arg):
        return local if frame.f_code is code else None

    before = sys.gettrace()
    sys.settrace(tracer)
    try:
        call(eng, rounds, tmp_path)
    finally:
        sys.settrace(before)
    # every simple statement of the loop body ran inside a top-level span
    assert len({n for n, _ in seen}) > 15
    assert [n for n, inside in seen if not inside] == []

    kept = trace.kept()
    assert [r.index for r in kept] == [trace.PROLOGUE] + list(range(rounds))
    pro = kept[0]
    assert _names(pro) == [("setup.init", None),
                           ("setup.xstack", "setup.init"), ("draw", None),
                           ("draw.perms", "draw"), ("draw.gather", "draw"),
                           ("train", None)]
    for r in kept[1:]:
        assert _names(r) == _expected(r.index, rounds, lanes, loop)
        top = [i for i, p in enumerate(r.parents) if p < 0]
        ns = r.ns
        # top-level spans follow one another; children lie inside
        assert all(ns[i, 0] <= ns[i, 1] for i in range(len(ns)))
        assert all(ns[a, 1] <= ns[b, 0] for a, b in zip(top, top[1:]))
        for i, p in enumerate(r.parents):
            if p >= 0:
                assert ns[p, 0] <= ns[i, 0] <= ns[i, 1] <= ns[p, 1]
        # host ms = the stamps' span; self = host less the children's
        assert np.all(r.ms[:, 1] <= r.ms[:, 0] + 1e-9)
        assert np.isnan(r.ms[:, 2]).all()          # no device here
        assert r.host_only == tuple(
            n in ("draw.perms", "select", "uploads", "book")
            for n in r.names)
    # round t holds the t-th evaluation (one a lane)
    evals = [r for r in kept[1:] for _ in range(lanes)]
    assert len(ev.stamps) == len(evals)
    for stamp, r in zip(ev.stamps, evals):
        i = r.names.index("eval")
        assert r.ns[i, 0] <= stamp <= r.ns[i, 1]


def _bits(x):
    return {k: v.detach().contiguous().view(torch.int32).numpy().copy()
            for k, v in x.items()}


@pytest.mark.parametrize("loop", ["run", "sweep2"])
def test_recorder_on_and_off_give_the_same_bits(loop, monkeypatch,
                                                tmp_path):
    lanes, call = LOOPS[loop]
    out = {}
    for on in (True, False):
        monkeypatch.setattr(trace, "ENABLED", on)
        eng = _engine(5, _Eval())
        res = call(eng, 5, tmp_path)
        hists = [res] if loop == "run" else list(res)
        glob = (eng.global_params if loop == "run"
                else res.final_globals)
        out[on] = ([(h.winners, h.train_loss, h.priorities, h.accuracy)
                    for h in hists], _bits(glob))
        assert bool(trace.kept()) == on
    (h_on, g_on), (h_off, g_off) = out[True], out[False]
    assert h_on == h_off
    assert g_on.keys() == g_off.keys()
    assert all(np.array_equal(g_on[k], g_off[k]) for k in g_on)


def test_off_records_nothing(monkeypatch):
    _engine(3, _Eval()).run()
    assert trace.kept()
    monkeypatch.setattr(trace, "ENABLED", False)
    _engine(3, _Eval()).run()
    assert trace.kept() == []
    assert trace.summary(range(-1, 3)) is None
    assert not trace.RECORDER.active
    assert isinstance(trace.span("x"), type(trace._NULL))


@pytest.mark.parametrize("fail", [0, 3])
def test_an_eval_exception_keeps_the_completed_rounds(fail):
    with pytest.raises(_Stop):
        _engine(6, _Eval(fail=fail)).run()
    assert [r.index for r in trace.kept()] == [trace.PROLOGUE] + list(
        range(fail))
    assert not trace.RECORDER.active
    # outside a run a span records nothing
    with trace.span("after"):
        pass
    assert all("after" not in r.names for r in trace.kept())


def test_the_store_keeps_the_prologue_and_the_last_rounds(monkeypatch):
    monkeypatch.setattr(trace, "KEEP", 3)
    _engine(7, _Eval()).run()
    assert [r.index for r in trace.kept()] == [trace.PROLOGUE, 4, 5, 6]
    s = trace.summary(range(0, 7))
    assert s["rounds"] == 3
    assert trace.summary([0, 1]) is None
    assert trace.summary([trace.PROLOGUE])["spans"]["train"]["host_ms"] > 0


def test_sparse_loop_records_prepass():
    spec = dict(rounds=3, seed=0, batch_size=8, k_per_round=2,
                strategy="priority-distributed", round_mode="sparse")
    eng = teng.build_host_engine(teng.ExperimentSpec(**spec), _init(),
                                 _loss, _data(), _Eval(), device="cpu")
    eng.run_sweep([eng.spec])
    kept = trace.kept()
    assert [r.index for r in kept] == [trace.PROLOGUE, 0, 1, 2]
    assert _names(kept[0]) == [("setup.init", None),
                               ("setup.xstack", "setup.init")]
    for r in kept[1:]:
        assert _names(r) == [
            ("prepass", None), ("draw.perms", "prepass"), ("select", None),
            ("train", None), ("uploads", None), ("merge", None),
            ("book", None), ("eval", None), ("eval.wait", "eval")]


def test_span_stamps_are_on_the_profilers_host_clock():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        trace.RECORDER.start("cpu")
        with trace.span("outer"):
            time.sleep(0.002)
            with torch.profiler.record_function("inner"):
                time.sleep(0.002)
            time.sleep(0.002)
        trace.RECORDER.finish(dropped=False)
    inner = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner"]
    assert len(inner) == 1
    (start, end), = trace.kept()[0].ns
    assert start <= inner[0].start_ns() <= inner[0].end_ns() <= end
    assert trace.kept()[0].ms[0, 0] >= 6.0


# ------------------------------------------- the device path, stand-ins
class _Device:
    """A stand-in card: each recorded event completes at the time the
    test sets (``now``); an event is read only once a wait covered it."""

    def __init__(self):
        self.now, self.events, self.waits, self.created = 0.0, [], 0, 0
        self.peak = 0

    def max_allocated(self, device=None):
        self.peak = max(self.peak, int(self.now))
        return self.peak

    def new(self):
        self.created += 1
        return _Event(self)

    def wait(self, device=None):
        self.waits += 1
        for e in self.events:
            e.done = True


class _Event:
    def __init__(self, dev):
        self.dev, self.t, self.done = dev, None, False

    def record(self):
        self.t, self.done = self.dev.now, False
        self.dev.events.append(self)

    def elapsed_time(self, other):
        assert self.done and other.done, "read a pending event"
        return other.t - self.t


@pytest.fixture
def card(monkeypatch):
    dev = _Device()
    monkeypatch.setattr(trace, "RECORDER", trace.Recorder())
    monkeypatch.setattr(trace, "_new_event", dev.new)
    monkeypatch.setattr(trace, "_current_stream", lambda d: None)
    monkeypatch.setattr(trace, "_record", lambda ev, stream: ev.record())
    monkeypatch.setattr(trace, "_peak", dev.max_allocated)
    monkeypatch.setattr(trace, "_wait", dev.wait)
    return dev


def _round(card, phases):
    """Spans ``(name, host_only, device ms)`` one after another, the card
    advancing by each one's device ms inside it."""
    for name, host_only, ms in phases:
        with trace.span(name, host_only=host_only):
            card.now += ms


def _sync(card):
    """A wait the program makes: every event recorded so far is done."""
    for e in card.events:
        e.done = True
    trace.synced("cuda:0")


PHASES = [("draw", False, 1.0), ("read", False, 2.0), ("select", True, 0.5),
          ("train", False, 10.0), ("eval", False, 3.0)]


def test_device_marks_resolve_only_after_a_wait(card):
    rec = trace.RECORDER
    rec.start("cuda:0")
    _round(card, [("train", False, 7.0)])
    for t in range(3):
        trace.begin_round(t)
        _round(card, PHASES[:1])
        _sync(card)
        # a sync makes the rounds closed before it safe, and reads those
        # an earlier sync made safe
        assert [r.index for r in trace.kept()] == (
            [-1] + list(range(max(t - 1, 0))))[:t]
        if t % 2 == 0:
            trace.idle()                    # read while the card works
            assert [r.index for r in trace.kept()] == [-1] + list(
                range(t))
        _round(card, PHASES[1:])
    rec.finish(dropped=False)
    assert card.waits == 0                  # the run itself never waited
    kept = trace.kept()                     # the reader waits for the last
    assert card.waits == 1
    assert [r.index for r in kept] == [-1, 0, 1, 2]
    assert kept[0].ms[0, 2] == 7.0 and kept[0].wall_ms == 7.0
    for r in kept[1:]:
        assert list(r.ms[:, 2]) == [ms for _, _, ms in PHASES]
    # the wall runs to the next round's first event; the last has none
    assert [r.wall_ms for r in kept[1:]] == [16.5, 16.5, None]
    s = trace.summary(range(3))
    assert s["spans"]["train"]["device_ms"] == 10.0
    assert s["spans"]["select"]["host_only"]
    assert s["wall_ms"] == 16.5
    assert s["peak_bytes"] == pytest.approx((23 + 40 + 56) / 3)
    # the pool: a round reuses the events of the rounds resolved before
    assert card.created <= 2 * (1 + 2 * len(PHASES))


def test_device_marks_of_a_dropped_round(card):
    rec = trace.RECORDER
    rec.start("cuda:0")
    _round(card, [("train", False, 7.0)])
    trace.begin_round(0)
    _round(card, PHASES)
    trace.begin_round(1)
    _round(card, PHASES[:2])
    rec.finish(dropped=True)
    kept = trace.kept()
    assert [r.index for r in kept] == [-1, 0]
    assert kept[1].wall_ms == 16.5          # to the dropped round's start


def test_round_zero_names_the_span_that_set_its_peak(card):
    trace.RECORDER.start("cuda:0")
    _round(card, [("train", False, 7.0)])
    trace.begin_round(0)
    _round(card, [("draw", False, 1.0)])
    with trace.span("merge"):
        with trace.span("merge.inner"):
            card.now += 5.0
    card.now -= 5.0                         # freed: the peak stays
    with trace.span("train"):
        card.now += 9.0                     # the round's peak: 17
        with trace.span("setup.kernels", host_only=True):
            card.now -= 1.0                 # opened after the peak
    _round(card, [("eval", False, 1.0)])
    trace.begin_round(1)
    _round(card, [("eval", False, 9.0)])    # a later, higher peak
    trace.begin_round(2)
    _round(card, [("eval", False, 1.0)])
    trace.RECORDER.finish(dropped=False)
    assert trace.peak_span(0) == ("train", 17)
    assert trace.peak_span(trace.PROLOGUE) == ("train", 7)
    assert trace.peak_span(1) is None       # kept for round 0 only
    assert [r.peak_bytes for r in trace.kept()] == [7, 17, 26, 27]


def test_a_round_begins_outside_every_span():
    trace.RECORDER.start("cpu")
    try:
        with trace.span("draw"):
            with pytest.raises(RuntimeError, match="inside the span"):
                trace.begin_round(0)
    finally:
        trace.RECORDER.finish(dropped=True)
