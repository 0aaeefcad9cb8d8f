"""The --arch slice as a whole: federated finetune of the reduced yi-9b,
deepseek-v3-671b and kimi-k2-1t-a32b through
``launch.train.build_llm_engine`` in both packages, from equal params
(the JAX engine's own init, carried across as numpy) and the same token
streams (``make_token_stream``, numpy): 4 users, k = 2, 16-token
sequences, 4 a user, batch 2, 3 rounds, on the CPU. deepseek's cell
scales Eq. 3's N (``--cw-base``) by 2^10: its Eq. 2 product over 56
leaves starts near 3.4e4 (14 zero-initialised norm scales, each ratio
capped at 1), and at N = 2048 every window is under one slot.

Every history count exact; the global after every round within
``rtol=1e-5`` (port rule 4); the ``random-*`` strategies' winners equal
(they depend on no float of the training); ``priority-distributed``'s
Eq. 2 priorities within ``rtol=1e-5``. Within the port: a
``--sweep-seeds 2`` lane equals its sequential run bit for bit, and
``main(["--arch", ...])`` runs and prints its summary.
"""
import argparse
import json

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain
from repro_torch.tree import tree_leaves
from torch_port_util import HISTORY_COUNTS, bitwise_equal, tree_f32

ROUNDS = 3
ARGV = ["--users", "4", "--k", "2", "--llm-seq", "16",
        "--llm-seqs-per-user", "4", "--batch-size", "2", "--rounds",
        str(ROUNDS)]
#: each arch's cell: the arch, and deepseek's scaled Eq. 3 N
ARCH_ARGV = {"yi-9b": ["--arch", "yi-9b"],
             "deepseek-v3-671b": ["--arch", "deepseek-v3-671b",
                                  "--cw-base", "2097152"],
             "kimi-k2-1t-a32b": ["--arch", "kimi-k2-1t-a32b"]}


def _args(strategy, arch="yi-9b", **over):
    """The same parsed arguments for both launchers (the port's parser
    has every flag the reference's has, plus --device and --round-mode)."""
    ns = vars(ttrain.make_parser().parse_args(
        ARCH_ARGV[arch] + ARGV + ["--strategy", strategy, "--device",
                                  "cpu"]))
    ns.update(over)
    return argparse.Namespace(**ns)


def _capture(engine, store, to_np):
    """Wrap the engine's eval so it keeps a copy of the global each
    round."""
    inner = engine.eval_fn

    def ev(params):
        store.append(to_np(params))
        return inner(params)
    engine.eval_fn = ev


def _pair(strategy, arch):
    args = _args(strategy, arch)
    je = jtrain.build_llm_engine(args)
    init = jax.tree.map(np.asarray, je._init_params)
    te = ttrain.build_llm_engine(args, init=init)
    jg, tg = [], []
    _capture(je, jg, lambda p: jax.tree.map(np.asarray, p))
    _capture(te, tg, tree_f32)
    return je.run(), te.run(), jg, tg, te


@pytest.fixture(scope="module")
def runs():
    return {}


def _run(runs, strategy, arch="yi-9b"):
    if (strategy, arch) not in runs:
        runs[strategy, arch] = _pair(strategy, arch)
    return runs[strategy, arch]


@pytest.mark.parametrize("strategy,arch", [
    pytest.param(s, "yi-9b", id=s) for s in ("priority-distributed",
                                             "random-distributed",
                                             "random-centralized")] + [
    pytest.param("priority-distributed", a, id=f"{a}-priority-distributed")
    for a in ("deepseek-v3-671b", "kimi-k2-1t-a32b")])
def test_arch_rounds_match_jax(strategy, arch, runs):
    jh, th, jg, tg, _ = _run(runs, strategy, arch)
    for name in HISTORY_COUNTS:
        assert getattr(th, name) == getattr(jh, name), name
    assert np.array_equal(th.selections, jh.selections)
    assert len(jg) == len(tg) == ROUNDS
    for a, b in zip(tg, jg):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=1e-5)
    np.testing.assert_allclose(th.accuracy, jh.accuracy, rtol=1e-5)


def test_random_strategies_winners_equal(runs):
    for strategy in ("random-distributed", "random-centralized"):
        jh, th, *_ = _run(runs, strategy)
        assert th.winners == jh.winners, strategy


def test_priority_distributed_priorities_match_jax(runs):
    jh, th, *_ = _run(runs, "priority-distributed")
    assert th.winners == jh.winners
    np.testing.assert_allclose(np.asarray(th.priorities),
                               np.asarray(jh.priorities), rtol=1e-5)
    assert (np.asarray(th.priorities) >= 1.0).all()


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v3-671b"])
def test_sweep_lane_equals_its_sequential_run(arch):
    """``--sweep-seeds 2``: lane 1 is the run of the same cell with the
    spec's seed 1 (the lanes share the data and the init), bit for bit:
    the sweep's local step stacks 8 users where the run stacks 4, and no
    user's sum over its tokens may follow that count."""
    from repro_torch.engine import SweepSpec
    eng = ttrain.build_llm_engine(_args("priority-distributed", arch))
    res = eng.run_sweep(SweepSpec.grid(eng.spec, seed=range(0, 2)))
    # the seed-1 cell: the sweep's data and params, the spec's seed 1
    one = ttrain.build_llm_engine(_args("priority-distributed", arch),
                                  init=tree_f32(eng._init_params), seed=1)
    h = one.run()
    assert h.winners == res[1].winners
    assert h.train_loss == res[1].train_loss
    assert bitwise_equal(one.global_params, res.lane_params(1))


def test_main_runs_on_the_cpu_and_prints_its_summary(capsys):
    engine, summary = ttrain.main(ARCH_ARGV["yi-9b"] + ARGV + [
        "--device", "cpu", "--sweep-seeds", "2"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == summary
    assert summary["device"] == "cpu" and summary["sweep_cells"] == 2
    assert sum(summary["selections"]) == summary["uploads_total"] > 0
    assert summary["final_metric"] < 0          # -loss: "metric up"
    assert all(torch.isfinite(p).all()
               for p in tree_leaves(engine.global_params))
