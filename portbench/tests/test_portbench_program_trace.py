"""The readers of the program's round recorder (``repro_torch.trace``):
against a recorder filled by hand, each gives the mean over exactly the
traced run's untraced window but its last round, whose evaluation starts
the profiler (the prologue for ``first_train_s``), and None with no such
round or no window; a small traced CPU run prints the host-clock ones
and leaves out the device ones."""
from types import SimpleNamespace

import numpy as np
import pytest

import tiny
from portbench.harness import cells

from repro_torch import trace

#: the new readers and what each reads of a round built by ``_round``
READERS = ["host_wait_ms_per_round", "host_phase_idle_ms_per_round",
           "train_device_ms_per_round", "merge_device_ms_per_round",
           "eval_device_ms_per_round", "launches_per_round",
           "first_train_s"]
LAYOUT = (("draw", "draw.perms", "read", "select", "merge", "train",
           "book", "eval", "eval.wait"),
          (-1, 0, -1, -1, -1, -1, -1, -1, 7),
          (False, True, False, True, False, False, True, False, False))


def _round(t):
    """Round t: span i's host ms 10 t + i, device ms 100 t + i; t + 25
    launches."""
    n = len(LAYOUT[0])
    ms = np.stack([10.0 * t + np.arange(n), 10.0 * t + np.arange(n),
                   100.0 * t + np.arange(n)], axis=1)
    return trace.Round(t, LAYOUT, np.zeros((n, 2), np.int64), ms,
                       {"fused_sgd": 18 + t, "delta_norm": 1,
                        "gather_combine": 6})


def _want(name, ts):
    names = LAYOUT[0]

    def dev(span):
        return np.mean([100.0 * t + names.index(span) for t in ts])
    if name == "host_wait_ms_per_round":
        return np.mean([20.0 * t + names.index("read")
                        + names.index("eval.wait") for t in ts])
    if name == "host_phase_idle_ms_per_round":
        # draw.perms, select and book; no host-only span nests in another
        return dev("draw.perms") + dev("select") + dev("book")
    if name == "launches_per_round":
        return np.mean([25.0 + t for t in ts])
    if name == "first_train_s":
        return dev("train") / 1e3
    return dev(name.split("_")[0])


def _reading(warmup, window):
    cell = SimpleNamespace(workload={"warmup_rounds": warmup})
    return SimpleNamespace(cell=cell,
                           timing=SimpleNamespace(window_rounds=window))


@pytest.fixture
def recorder(monkeypatch):
    rec = trace.Recorder()
    monkeypatch.setattr(trace, "RECORDER", rec)
    return rec


@pytest.mark.parametrize("name", READERS)
def test_a_reader_takes_the_mean_over_the_window(name, recorder):
    mod = cells.load_module(cells.reader_path(name))
    assert mod.read(_reading(2, 5)) is None            # nothing recorded
    recorder.prologue = _round(trace.PROLOGUE)
    for t in range(10):
        recorder.rounds.append(_round(t))
    ts = [trace.PROLOGUE] if name == "first_train_s" else range(2, 6)
    assert mod.read(_reading(2, 5)) == pytest.approx(_want(name, ts))
    if name != "first_train_s":
        assert mod.read(_reading(2, 1)) is None        # no whole round
        assert mod.read(_reading(12, 3)) is None       # no such round


def test_a_small_traced_run_prints_the_host_clock_readings():
    # a window of several rounds, even on a loaded machine
    res = tiny.run(tiny.cell("cnn-paper-u10", users=6, k=2), trace=True,
                   seconds=2.0)
    m = res["metrics"]
    assert res["correct"] is True
    # no hand-written kernel launches on the CPU
    assert m["launches_per_round"] == {"value": 0.0, "unit": "launches"}
    assert m["host_wait_ms_per_round"]["value"] > 0
    # the CUDA events' readings are left out off the card
    for name in ("host_phase_idle_ms_per_round", "train_device_ms_per_round",
                 "merge_device_ms_per_round", "eval_device_ms_per_round",
                 "first_train_s"):
        assert name not in m
