"""The control comes out not correct: the reference put in the program's
place with its products' operands rounded to the precision below the
configuration's (TF32 for f32 with TF32 off), judged as a run of the
program is, at a size a test run holds (the card's readings at the
cells' own sizes are in PERF.md)."""
import pytest

import tiny
from portbench.harness import bench, traffic
from portbench.reference import ops

SEED = 2 ** 31 + 12345


def _small(name):
    if name == "paper-mlp":
        return tiny.mlp_cell(users=8, k=3)
    if name == "lm-tiny":
        return tiny.lm_cell()
    return tiny.cell(name, users=8, k=3)


@pytest.mark.parametrize("name", ["cnn-paper-u10", "paper-mlp", "lm-tiny"])
def test_the_tf32_control_is_not_correct(name):
    c = _small(name)
    with tiny.one_thread():
        inputs = traffic.make_inputs(c, SEED, "cpu")
        control = bench.reference_records(c, inputs, SEED, "cpu",
                                          ops=ops.control(c.config))
        ok, checks, failed = bench.check(c, inputs, SEED, "cpu", control)
    assert not ok and failed >= 1, checks


def test_the_reference_judged_against_itself_is_exact():
    c = tiny.mlp_cell(users=8, k=3)
    with tiny.one_thread():
        inputs = traffic.make_inputs(c, SEED, "cpu")
        own = bench.reference_records(c, inputs, SEED, "cpu")
        ok, checks, _ = bench.check(c, inputs, SEED, "cpu", own)
    assert ok
    assert all(v["value"] == 0.0 for v in checks.values()), checks
