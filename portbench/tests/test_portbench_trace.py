"""The profiler reduction on a hand-made trace: busy time is the union of
the device intervals, operations are summed by name, and each idle gap is
named by the innermost benchmark span open at its midpoint."""
from types import SimpleNamespace

import pytest


import tiny  # noqa: F401  (the checkout and src on the path)
from portbench.harness import trace


def _ev(name, start, end, device):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=SimpleNamespace(name="CUDA" if device else "CPU"))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_reduce():
    prof = _Prof([
        _ev("portbench.train", 0, 100, False),
        _ev("portbench.select", 100, 160, False),
        _ev("portbench.draw", 120, 140, False),
        _ev("portbench.train", 0, 300, True),      # the span's annotation
        _ev("aten::mm", 10, 20, False),
        _ev("gemm", 0, 50, True),
        _ev("sgd_leaves_kernel", 40, 90, True),    # overlaps the gemm
        _ev("loop_kernel", 130, 150, True),        # gap 90..130: mid 110
        _ev("gemm", 200, 210, True),               # gap 150..200: mid 175
    ])
    r = trace.reduce(prof)
    assert r["busy_s"] == pytest.approx((90 + 20 + 10) * 1e-6)
    assert r["ops"]["gemm"] == [pytest.approx(60e-6), 2]
    assert r["gaps"] == {"select": pytest.approx(40e-6),
                         "engine": pytest.approx(50e-6)}
    assert trace.top(r["ops"], 2) == [["gemm", pytest.approx(60e-6)],
                                      ["sgd_leaves_kernel",
                                       pytest.approx(50e-6)]]


def test_reduce_names_the_innermost_span():
    prof = _Prof([_ev("portbench.select", 0, 100, False),
                  _ev("portbench.draw", 20, 80, False),
                  _ev("k", 0, 10, True), _ev("k", 90, 95, True)])
    assert trace.reduce(prof)["gaps"] == {"draw": pytest.approx(80e-6)}
