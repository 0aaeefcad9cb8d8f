"""The port's per-round fallback paths on the CPU: ``round_mode="stacked"``
and ``"ragged"``, partial-cohort rounds (``random-centralized``, which
selects before training) and uneven cohorts, against the JAX engine and
against the port's own fused path.

The scenario is that of ``tools/check_winner_pins.py`` (8 users, a
16 -> 4 linear model, 4 rounds), the same arrays handed to both
packages. What must agree, and how tightly:
  * the three round paths of the port with each other, as
    ``tests/test_fused_round.py`` pins the reference's: equal winners,
    losses and globals ``rtol=1e-4, atol=1e-6``;
  * each path against the JAX engine in the same mode: every count of
    the history exactly, losses and globals ``rtol=1e-5, atol=1e-6``;
  * ``random-centralized`` winners equal ``tests/winner_pins.json``;
  * the gather merge of a stacked handle and the fused merge of the same
    trained rows: bit for bit.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import engine as jeng
from repro.channel import ChannelSpec as JChannelSpec
from repro.faults import FaultSpec as JFaultSpec
from repro.faults.robust import FaultMergeContext as JFaultMergeContext
from repro_torch import engine as teng
from repro_torch.channel import ChannelSpec
from repro_torch.channel.model import MergeContext
from repro_torch.engine.backends import HostBackend as THostBackend
from repro_torch.engine.types import TrainResult
from repro_torch.faults import FaultSpec
from repro_torch.faults.robust import FaultMergeContext

from torch_port_util import (LOSSY, PIN_USERS, SEEDS, assert_runs_agree,
                             assert_trees_close, bits, bitwise_equal,
                             pin_init, pin_jax_loss, pin_torch_engine,
                             pin_torch_loss, pin_user_data, run_pair,
                             threefry_noise, to_jax, to_torch)

PINS = json.load(open(os.path.join(os.path.dirname(__file__),
                                   "winner_pins.json")))["winners"]
MODES = ("stacked", "ragged")


def _run_port(mode, strategy, *, seed=1, epochs=1, rounds=4):
    eng = pin_torch_engine(dict(rounds=rounds, strategy=strategy, seed=seed,
                                local_epochs=epochs), round_mode=mode)
    return eng.run(), eng


def _assert_paths_agree(a, b):
    (ha, ea), (hb, eb) = a, b
    assert ha.winners == hb.winners
    np.testing.assert_allclose(ha.train_loss, hb.train_loss, rtol=1e-4)
    if ha.priorities:
        np.testing.assert_allclose(ha.priorities, hb.priorities, rtol=1e-4)
    assert_trees_close(ea.global_params, eb.global_params, rtol=1e-4,
                       atol=1e-6)


# ------------------------------------------- the three paths of the port
@pytest.mark.parametrize("strategy", teng.PAPER_STRATEGIES)
def test_fused_matches_stacked_and_ragged(strategy):
    """The port's twin of ``tests/test_fused_round.py``'s acceptance pin:
    the fused, stacked and ragged paths pick the same winners from the
    same client streams, with matching losses, priorities and globals."""
    fused = _run_port("fused", strategy)
    for mode in MODES:
        _assert_paths_agree(fused, _run_port(mode, strategy))


def test_paths_fold_local_epochs_alike():
    fused = _run_port("fused", "priority-distributed", epochs=3)
    for mode in MODES:
        _assert_paths_agree(fused, _run_port(mode, "priority-distributed",
                                             epochs=3))


# --------------------------------------------- each path against JAX
@pytest.mark.parametrize("strategy", ["priority-distributed",
                                      "random-centralized"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", SEEDS)
def test_round_mode_run_matches_jax_engine(strategy, mode, seed):
    want, got, je, te = run_pair(dict(strategy=strategy, seed=seed,
                                      round_mode=mode))
    assert_runs_agree(want, got, je, te)
    if strategy == "priority-distributed":
        np.testing.assert_allclose(got.priorities, want.priorities,
                                   rtol=1e-4)


#: the pinned lanes of ``random-centralized``: plain, channel off, faults off
PIN_LANES = {"": {},
             "/channel-off": dict(channel=(JChannelSpec(per_model="off"),
                                           ChannelSpec(per_model="off"))),
             "/faults-off": dict(faults=(JFaultSpec(), FaultSpec()))}


@pytest.mark.parametrize("lane", list(PIN_LANES))
@pytest.mark.parametrize("seed", SEEDS)
def test_random_centralized_equals_the_pins_and_jax(lane, seed):
    """Partial-cohort rounds under the default (fused) round mode: only
    the two winners train, as one stack."""
    want, got, je, te = run_pair(dict(strategy="random-centralized",
                                      seed=seed, **PIN_LANES[lane]))
    assert got.winners == PINS[f"random-centralized/seed{seed}{lane}"]
    assert_runs_agree(want, got, je, te)
    assert not got.priorities and te.backend._resident is None


# ------------------------------------------------------- uneven cohorts
def _uneven_data():
    """The reference's recipe (``tests/test_engine.py``): odd users drop
    40 examples, so their batch count (1 at batch 16) differs from the
    even users' (4) and nothing stacks."""
    return [{k: v[: len(v) - 40 * (u % 2)] for k, v in d.items()}
            for u, d in enumerate(pin_user_data())]


@pytest.mark.parametrize("strategy", ["priority-distributed",
                                      "random-centralized"])
def test_uneven_cohort_matches_jax_engine(strategy):
    data = _uneven_data()
    kw = dict(rounds=4, strategy=strategy, seed=0, batch_size=16)
    je = jeng.build_host_engine(jeng.ExperimentSpec(**kw),
                                to_jax(pin_init()), pin_jax_loss, data)
    te = teng.build_host_engine(teng.ExperimentSpec(**kw),
                                to_torch(pin_init()), pin_torch_loss, data,
                                device="cpu")
    assert not te.backend._rect
    assert not te.backend._can_stack(list(range(PIN_USERS)))
    assert_runs_agree(je.run(), te.run(), je, te)


# ------------------------------------------ one round, backend by backend
def _backends(mode="fused"):
    data = pin_user_data()
    kw = dict(lr=0.05, batch_size=16, seed=3, round_mode=mode, k_max=3)
    jb = jeng.HostBackend(pin_jax_loss, data, **kw)
    tb = THostBackend(pin_torch_loss, data, device="cpu", **kw)
    rng = np.random.default_rng(11)
    init = {"w": rng.standard_normal((16, 4)).astype(np.float32) * 0.3,
            "b": rng.standard_normal(4).astype(np.float32) * 0.3}
    return jb, tb, jb.init_state(to_jax(init)), tb.init_state(to_torch(init))


@pytest.mark.parametrize("ids,route", [([3], "ragged"),
                                       ([5, 0, 6], "stacked")])
def test_partial_round_takes_its_route_and_matches_jax(ids, route):
    """A one-user round cannot stack (``_can_stack`` needs two), so it
    takes the ragged route even under the fused mode; a three-user round
    stacks."""
    jb, tb, js, ts = _backends()
    jtr = jb.train_round(js, 0, ids, need_priority=True)
    ttr = tb.train_round(ts, 0, ids, need_priority=True)
    assert ("stacked" in ttr.local_handle) == (route == "stacked")
    assert list(ttr.losses) == ids
    np.testing.assert_allclose([ttr.losses[u] for u in ids],
                               [jtr.losses[u] for u in ids], rtol=1e-5)
    np.testing.assert_allclose(ttr.priorities, jtr.priorities, rtol=1e-5)
    assert (ttr.priorities[ids] > 1.0).all()
    for u in ids:
        assert_trees_close(tb.extract_local(ttr, u), jb.extract_local(jtr, u),
                           rtol=1e-5, atol=1e-6)
    winners = ids[::-1]
    assert_trees_close(tb.merge(ts, ttr, winners), jb.merge(js, jtr, winners),
                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_extract_local_is_a_fresh_copy(mode):
    _, tb, _, ts = _backends(mode)
    tr = tb.train_round(ts, 0, [1, 4], need_priority=False)
    key = "stacked" if mode == "stacked" else 4
    assert key in tr.local_handle
    local = tb.extract_local(tr, 4)
    view = tb._local(tr.local_handle, 4)
    assert bitwise_equal(local, view)
    for a, b in zip(local.values(), view.values()):
        assert a.data_ptr() != b.data_ptr()
        a.add_(1.0)                       # never writes into the handle
    assert not bitwise_equal(local, view)
    # the merge reads the handle, not the copy
    assert_trees_close(tb.merge(ts, tr, [4]), view, rtol=0, atol=0)


def test_gather_merge_drops_the_resident_stack():
    _, tb, _, ts = _backends()
    ids = list(range(PIN_USERS))
    s1 = tb.merge(ts, tb.train_round(ts, 0, ids, False), [2, 7])
    assert tb._resident_key is s1 and tb._resident is not None
    s2 = tb.merge(s1, tb.train_round(s1, 1, [0, 5], False), [5])
    assert tb._resident is None and tb._resident_key is None
    # the next full round starts from the broadcast of s2 again
    tr = tb.train_round(s2, 2, ids, True)
    assert tr.local_handle["fused_stack"]["w"].shape[0] == PIN_USERS


@pytest.mark.parametrize("handle_kind", ["stacked", "ragged"])
def test_gather_merge_is_the_fused_merge_bit_for_bit(handle_kind):
    """Given equal trained rows, the gather merge of a stacked handle
    (winners' row positions into the trained stack) and of a ragged one
    (the stacked winners) give the fused merge's bits."""
    _, tb, _, ts = _backends()
    ids = list(range(PIN_USERS))
    tr = tb.train_round(ts, 0, ids, need_priority=False)
    sub = [6, 1, 2, 5]
    rows = {u: tb.extract_local(tr, u) for u in sub}
    if handle_kind == "stacked":
        handle = {"stacked": {k: torch.stack([rows[u][k] for u in sub])
                              for k in ts},
                  "index": {u: i for i, u in enumerate(sub)}}
    else:
        handle = rows
    winners = [5, 6, 2]                   # delivery order != row order
    gathered = tb.merge(ts, TrainResult(losses={}, priorities=None,
                                        local_handle=handle), winners)
    fused = tb.merge(ts, tr, winners)
    for k in ts:
        assert np.array_equal(bits(gathered[k]), bits(fused[k]))


# ----------------------------------------------- the gather merge's forms
def test_stale_only_merge_without_fresh_winners_matches_jax():
    """A stale-only robust merge on an empty handle (no fresh winner):
    ``robust_merge`` takes ``trained=None``."""
    jb, tb, js, ts = _backends("stacked")
    rng = np.random.default_rng(5)
    stale = [{"w": rng.standard_normal((16, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
             for _ in range(2)]
    kw = dict(weights=np.zeros(PIN_USERS, np.float32),
              corrupt=np.ones(PIN_USERS, np.float32), quarantine=True,
              clip_norm=2.0)
    jctx = JFaultMergeContext(stale=[(to_jax(p), w) for p, w in
                                     zip(stale, (0.75, 0.25))], **kw)
    tctx = FaultMergeContext(stale=[(to_torch(p), w) for p, w in
                                    zip(stale, (0.75, 0.25))], **kw)
    empty = lambda b, s: b.train_round(s, 0, [], True)  # noqa: E731
    want = jb.merge(js, empty(jb, js), [], fault_ctx=jctx)
    got = tb.merge(ts, empty(tb, ts), [], fault_ctx=tctx)
    assert_trees_close(got, want, rtol=1e-5, atol=1e-6)
    assert tctx.n_quarantined == jctx.n_quarantined == 0


#: the active fault spec of ``benchmarks/faults_bench.py``
ACTIVE = dict(crash_prob=0.1, straggle_prob=0.2, corrupt_prob=0.1,
              outage_prob=0.1, max_retries=2, clip_norm=2.0)


@pytest.mark.parametrize("mode,strategy", [
    ("stacked", "priority-distributed"), ("ragged", "priority-distributed"),
    (None, "random-centralized")])
@pytest.mark.parametrize("faults", ["active", "stale-only"])
def test_faulty_gather_rounds_match_jax_engine(mode, strategy, faults):
    """The robust gather merge under the lossy channel and the active
    fault spec (stragglers captured through ``extract_local``), and with
    every arrival straggling, where every merge after round 0 holds a
    stale group and no fresh one."""
    kw = (dict(corrupt_mode="nan", **ACTIVE) if faults == "active"
          else dict(straggle_prob=1.0, staleness_discount=0.5))
    spec = dict(strategy=strategy, seed=0, round_mode=mode,
                faults=(JFaultSpec(**kw), FaultSpec(**kw)))
    if faults == "active":
        spec["channel"] = (JChannelSpec(**LOSSY), ChannelSpec(**LOSSY))
    want, got, je, te = run_pair(spec)
    assert_runs_agree(want, got, je, te)
    assert got.stale_merges > 0


@pytest.mark.parametrize("mode,strategy", [
    ("stacked", "priority-distributed"), ("ragged", "priority-distributed"),
    (None, "random-centralized")])
def test_aircomp_gather_merge_matches_jax_given_its_noise(mode, strategy):
    """The AirComp gather merge with receiver noise, the port handed the
    reference's threefry planes through ``_noise_draw``."""
    air = dict(fading="rayleigh", aircomp_sigma=0.05, aircomp_gain_floor=0.3)
    want, got, je, te = run_pair(
        dict(strategy=strategy, seed=0, round_mode=mode,
             merge_backend="aircomp",
             channel=(JChannelSpec(**air), ChannelSpec(**air))),
        noise_draw=threefry_noise)
    assert_runs_agree(want, got, je, te)


@pytest.mark.parametrize("mode", MODES)
def test_aircomp_gather_merge_one_call_matches_jax(mode):
    """One AirComp gather merge on a stacked or ragged handle, the same
    winners, coefficients and threefry planes on both sides."""
    jb, tb, js, ts = _backends(mode)
    tb._noise_draw = threefry_noise
    jtr = jb.train_round(js, 0, [2, 6, 3], need_priority=False)
    ttr = tb.train_round(ts, 0, [2, 6, 3], need_priority=False)
    coeffs = np.linspace(0.4, 1.0, PIN_USERS).astype(np.float32)
    jctx = jeng.MergeContext(coeffs=coeffs, noise_sigma=0.05,
                             key=jax.random.fold_in(jax.random.PRNGKey(99), 4))
    tctx = MergeContext(coeffs=coeffs, noise_sigma=0.05, key=(99, 4))
    assert_trees_close(tb.merge(ts, ttr, [6, 3], merge_ctx=tctx),
                       jb.merge(js, jtr, [6, 3], merge_ctx=jctx),
                       rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- guards
OBJ = teng.ObjectiveSpec(aggregator="fedavgm")


@pytest.mark.parametrize("mode", MODES)
def test_objective_refuses_the_fallback_modes(mode):
    with pytest.raises(ValueError, match="fused round only"):
        THostBackend(pin_torch_loss, pin_user_data(), round_mode=mode,
                     objective=OBJ, device="cpu")


def test_objective_refuses_an_uneven_cohort():
    with pytest.raises(ValueError, match="rectangular"):
        THostBackend(pin_torch_loss, _uneven_data(), batch_size=16,
                     objective=OBJ, device="cpu")


def test_objective_refuses_partial_rounds():
    tb = THostBackend(pin_torch_loss, pin_user_data(), objective=OBJ,
                      device="cpu")
    state = tb.init_state(to_torch(pin_init()))
    with pytest.raises(RuntimeError, match="unfused round"):
        tb.train_round(state, 0, [0, 1], need_priority=False)
    with pytest.raises(ValueError, match="trains_before_selection"):
        pin_torch_engine(dict(rounds=1, strategy="random-centralized",
                              objective=OBJ))


@pytest.mark.parametrize("prefer_vmap,mode,want", [
    (True, None, "fused"), (False, None, "ragged"),
    (False, "stacked", "stacked"), (True, "ragged", "ragged")])
def test_prefer_vmap_and_an_explicit_round_mode(prefer_vmap, mode, want):
    eng = teng.build_host_engine(
        teng.ExperimentSpec(rounds=1), to_torch(pin_init()), pin_torch_loss,
        pin_user_data(), device="cpu", prefer_vmap=prefer_vmap,
        round_mode=mode)
    assert eng.backend._mode == want
    assert eng.backend._prefer_vmap is (want != "ragged")
    assert len(eng.run().winners) == 1
