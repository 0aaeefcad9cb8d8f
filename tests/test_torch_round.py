"""The slice as a whole: FL rounds of the port against the JAX engine,
on the CPU, over the scenario of ``tools/check_winner_pins.py`` (8
users, a 16 -> 4 linear model, 4 rounds, seeds 0 and 1).

What must agree, and how tightly:
  * exactly — everything that is pure numpy: stream derivation, Eq. 3
    draws, the CSMA event loop, the fairness counter. The
    ``random-distributed`` winners depend on no training float and must
    equal ``tests/winner_pins.json``;
  * winner for winner — the priority strategies against the JAX
    engine's ``run()``; a flipped winner is reported with the priority
    gap that flipped it, never absorbed by a looser bar;
  * to tolerance — priorities ``rtol=1e-5`` in round 0 and ``1e-4``
    after (differences feed back through the merged globals), the final
    global ``rtol=1e-4, atol=1e-6``; one round from equal inputs
    ``rtol=1e-5``.
"""
import json
import os

import numpy as np
import pytest

from repro import engine as jeng
from repro_torch import engine as teng
from repro_torch.engine.backends import HostBackend as THostBackend

from torch_port_util import (PIN_USERS, assert_trees_close, f32, to_jax,
                             to_torch)
from torch_port_util import pin_init as _init
from torch_port_util import pin_jax_engine as _jax_engine
from torch_port_util import pin_jax_loss as _jax_loss
from torch_port_util import pin_torch_engine as _torch_engine
from torch_port_util import pin_torch_loss as _torch_loss
from torch_port_util import pin_user_data as _user_data

ROUNDS, SEEDS, NUM_USERS = 4, (0, 1), PIN_USERS
PINS = json.load(open(os.path.join(os.path.dirname(__file__),
                                   "winner_pins.json")))["winners"]


# ----------------------------------------------------- (a) winner pins
@pytest.mark.parametrize("seed", SEEDS)
def test_random_distributed_winners_equal_the_pins(seed):
    eng = _torch_engine(dict(rounds=ROUNDS, strategy="random-distributed",
                             seed=seed))
    hist = eng.run()
    assert hist.winners == PINS[f"random-distributed/seed{seed}"]
    assert hist.delivered == hist.winners
    assert hist.uploads_total == sum(len(w) for w in hist.winners)
    assert len(hist.train_loss) == ROUNDS and not hist.priorities


# ---------------------------------- (b) priority strategies vs JAX run()
@pytest.mark.parametrize("strategy", ["priority-distributed",
                                      "priority-centralized"])
@pytest.mark.parametrize("seed", SEEDS)
def test_priority_strategy_run_matches_jax_engine(strategy, seed):
    kw = dict(rounds=ROUNDS, strategy=strategy, seed=seed)
    jengine, tengine = _jax_engine(kw), _torch_engine(kw)
    want, got = jengine.run(), tengine.run()

    for t in range(ROUNDS):
        if got.winners[t] != want.winners[t]:
            jp, tp = np.asarray(want.priorities[t]), \
                np.asarray(got.priorities[t])
            print(f"\n{strategy}/seed{seed} round {t}: winners "
                  f"{got.winners[t]} (port) vs {want.winners[t]} (jax); "
                  f"max |priority gap| {np.abs(jp - tp).max():.3e}, "
                  f"closest pair of jax priorities "
                  f"{np.diff(np.sort(jp)).min():.3e} apart")
        assert got.winners[t] == want.winners[t]
        np.testing.assert_allclose(got.priorities[t], want.priorities[t],
                                   rtol=1e-5 if t == 0 else 1e-4)
    assert got.winners == PINS[f"{strategy}/seed{seed}"]
    assert got.collisions == want.collisions
    assert got.contention_slots == want.contention_slots
    assert got.uploads_total == want.uploads_total
    assert np.array_equal(got.selections, want.selections)
    assert got.round_seconds == want.round_seconds
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-4)
    assert_trees_close(tengine.global_params, jengine.global_params,
                       rtol=1e-4, atol=1e-6)
    assert np.array_equal(tengine.counter.uploads, jengine.counter.uploads)


def test_eval_fn_runs_on_the_schedule_of_the_reference():
    calls = []

    def eval_fn(params):
        calls.append(float(params["w"].abs().sum()))
        return len(calls) / 10.0

    spec = teng.ExperimentSpec(rounds=5, eval_every=2,
                               strategy="priority-distributed")
    eng = teng.build_host_engine(spec, to_torch(_init()), _torch_loss,
                                 _user_data(), eval_fn, device="cpu")
    hist = eng.run()
    assert hist.eval_round == [0, 2, 4]
    assert hist.accuracy == [0.1, 0.2, 0.3]
    assert calls[0] > 0.0                     # round 0 already merged


# ------------------------------------- (c) one round from equal inputs
def _one_round_backends(local_epochs=1):
    data = _user_data()
    jb = jeng.HostBackend(_jax_loss, data, lr=0.05, batch_size=16,
                          local_epochs=local_epochs, seed=3,
                          round_mode="fused", k_max=3)
    tb = THostBackend(_torch_loss, data, lr=0.05, batch_size=16,
                      local_epochs=local_epochs, seed=3,
                      round_mode="fused", k_max=3, device="cpu")
    rng = np.random.default_rng(11)
    init = {"w": rng.standard_normal((16, 4)).astype(np.float32) * 0.3,
            "b": rng.standard_normal(4).astype(np.float32) * 0.3}
    return jb, tb, init


@pytest.mark.parametrize("local_epochs", [1, 2])
def test_one_round_train_and_merge_match_jax_backend(local_epochs):
    jb, tb, init = _one_round_backends(local_epochs)
    ids = list(range(NUM_USERS))
    jstate, tstate = jb.init_state(to_jax(init)), \
        tb.init_state(to_torch(init))
    jtr = jb.train_round(jstate, 0, ids, need_priority=True)
    ttr = tb.train_round(tstate, 0, ids, need_priority=True)
    assert ttr.priorities.dtype == np.float64
    assert ttr.losses.shape == (NUM_USERS,)
    np.testing.assert_allclose(ttr.priorities, jtr.priorities, rtol=1e-5)
    np.testing.assert_allclose(ttr.losses, jtr.losses, rtol=1e-5)
    assert (ttr.priorities >= 1.0).all()
    assert_trees_close(ttr.local_handle["fused_stack"],
                       jtr.local_handle["fused_stack"], rtol=1e-5,
                       atol=1e-6)
    local5 = tb.extract_local(ttr, 5)

    winners = [6, 2]                            # delivery order, k_pad 3
    jnew = jb.merge(jstate, jtr, winners)
    tnew = tb.merge(tstate, ttr, winners)
    assert_trees_close(tnew, jnew, rtol=1e-5, atol=1e-6)
    # the old global is only read; the new one is fresh; a captured
    # local survives the stack's overwrite
    assert_trees_close(tstate, init, rtol=0, atol=0)
    assert ttr.local_handle["fused_stack"] is None
    assert not np.allclose(f32(local5["w"]), f32(tnew["w"]))

    # round 1 trains the resident stack in place: the global returned
    # by the merge must not move with it
    before = {k: v.clone() for k, v in tnew.items()}
    jtr2 = jb.train_round(jnew, 1, ids, need_priority=True)
    ttr2 = tb.train_round(tnew, 1, ids, need_priority=True)
    assert_trees_close(tnew, before, rtol=0, atol=0)
    np.testing.assert_allclose(ttr2.priorities, jtr2.priorities, rtol=1e-4)
    np.testing.assert_allclose(ttr2.losses, jtr2.losses, rtol=1e-4)


def test_resident_stack_rule_and_unmerged_rounds():
    """The merged stack is reused only for the very state object the
    merge returned; any other state (an unmerged round, a caller's own
    params) is re-broadcast."""
    _, tb, init = _one_round_backends()
    ids = list(range(NUM_USERS))
    s0 = tb.init_state(to_torch(init))
    tr0 = tb.train_round(s0, 0, ids, need_priority=False)
    assert np.array_equal(tr0.priorities, np.ones(NUM_USERS))
    s1 = tb.merge(s0, tr0, [1])
    assert tb._resident_key is s1
    # a round that merges nothing drops the trained stack ...
    tb.train_round(s1, 1, ids, need_priority=False)
    assert tb._resident is None
    # ... and the next round starts from the global again, not from the
    # abandoned trained models: same draws -> same result as a backend
    # that was handed s1 fresh
    _, tb2, _ = _one_round_backends()
    for _ in range(2):                           # align the batch streams
        tb2._ensure_xstack()
        tb2._draw_big()
    a = tb.train_round(s1, 2, ids, need_priority=True)
    b = tb2.train_round({k: v.clone() for k, v in s1.items()}, 2, ids,
                        need_priority=True)
    np.testing.assert_array_equal(a.priorities, b.priorities)
    with pytest.raises(ValueError):
        tb.merge(s1, tr0, [1])                   # a handle merges once


def test_client_streams_snapshot_and_restore():
    _, tb, _ = _one_round_backends()
    tb._ensure_xstack()
    snap = tb.client_stream_states()
    first = tb._draw_big()
    assert not np.array_equal(first, tb._draw_big())
    tb.restore_client_streams(snap)
    assert np.array_equal(first, tb._draw_big())


# --------------------------------------- (d) unported options all raise
def _spec(**kw):
    return teng.ExperimentSpec(rounds=1, **kw)


def _build(spec=None, **kw):
    return teng.build_host_engine(spec or _spec(), to_torch(_init()),
                                  _torch_loss, _user_data(), device="cpu",
                                  **kw)


@pytest.mark.parametrize("mode", ["sparse"])
def test_unported_round_modes_raise(mode):
    """The winner-sparse mode is ported: named as an argument or in the
    spec it builds and runs (the sparse path, selection before training);
    an unknown mode still raises."""
    for eng in (_build(round_mode=mode), _build(_spec(round_mode=mode))):
        assert eng.backend._mode == mode and eng.backend.sparse_capable()
        hist = eng.run()
        assert len(hist.winners) == 1 and hist.uploads_total >= 1
    with pytest.raises(ValueError):
        THostBackend(_torch_loss, _user_data(), round_mode="bogus",
                     device="cpu")


def test_sparse_auto_selection_raises_and_names_the_way_out():
    """16 users at k = 2 (k * 8 <= U) auto-select the sparse path, as the
    reference's factory does; an explicit round mode wins."""
    data = _user_data() * 2                      # 16 users, k = 2
    auto = teng.build_host_engine(_spec(), to_torch(_init()), _torch_loss,
                                  data, device="cpu")
    assert auto.backend._mode == "sparse"
    assert len(auto.run().winners) == 1
    eng = teng.build_host_engine(_spec(), to_torch(_init()), _torch_loss,
                                 data, device="cpu", round_mode="fused")
    assert eng.backend._mode == "fused"
    assert len(eng.run().winners) == 1


@pytest.mark.parametrize("obj", [
    teng.ObjectiveSpec(aggregator="fedavgm"),
    teng.ObjectiveSpec(local="feddyn", alpha=0.1),
    teng.ObjectiveSpec(local="fedprox", mu=0.1),
], ids=["fedavgm", "feddyn", "fedprox"])
def test_objective_spec_options_build_and_run(obj):
    eng = _build(_spec(objective=obj))
    assert eng.backend.objective_active() is True
    assert eng.backend.objective_needs_h() is obj.uses_h
    hist = eng.run()
    assert len(hist.winners) == 1 and hist.uploads_total >= 1


def test_unported_faults_mesh_objective_and_uneven_cohort_raise():
    from repro_torch.faults import FaultSpec
    # the fault and channel layers are ported: these build
    _build(_spec(faults=FaultSpec(),
                 channel=teng.ChannelSpec(per_model="off")))
    with pytest.raises(NotImplementedError, match="mesh"):
        _build(mesh=object())
    # the objectives layer is ported: a non-plain objective builds
    assert THostBackend(_torch_loss, _user_data(), device="cpu",
                        objective=teng.ObjectiveSpec(aggregator="fedavgm")
                        ).objective_active()
    # an uneven cohort builds and runs its rounds user by user
    uneven = _user_data()
    uneven[3] = {k: v[:40] for k, v in uneven[3].items()}
    backend = THostBackend(_torch_loss, uneven, device="cpu")
    assert not backend._rect and not backend._can_stack(list(range(8)))
    hist = teng.FLEngine(_spec(), backend, to_torch(_init())).run()
    assert len(hist.winners) == 1 and hist.uploads_total >= 1
    # a plain objective is the untouched path, not an unported one
    _build(_spec(objective=teng.ObjectiveSpec()))


def test_unported_run_options_and_merge_contexts_raise(tmp_path):
    eng = _build()
    # the sweep and checkpoints are ported: these run
    assert len(eng.run_sweep([eng.spec])) == 1
    assert len(_build().run(checkpoint_dir=str(tmp_path)).winners) == 1
    assert eng.backend.sweep_capable() is True
    assert _build(round_mode="stacked").backend.sweep_capable() is False
    assert eng.backend.sparse_capable() is False
    assert _build(round_mode="sparse").backend.sparse_capable() is True
    assert eng.backend.objective_active() is False
    assert eng.backend.objective_needs_h() is False
    tr = eng.backend.train_round(eng.state, 0, list(range(NUM_USERS)), True)
    # a partial-cohort round trains its users as one stack
    part = eng.backend.train_round(eng.state, 0, [0, 1], True)
    assert "stacked" in part.local_handle and list(part.losses) == [0, 1]
    assert (part.priorities[[0, 1]] > 1.0).all()
    assert (part.priorities[2:] == 1.0).all()
    empty = eng.backend.train_round(eng.state, 0, [], True)
    assert empty.losses == {} and empty.local_handle == {}


def test_launch_train_rejects_unported_flags():
    from repro_torch.launch import train
    # --sweep-seeds and --ckpt are ported (tests/test_torch_sweep.py);
    # --arch runs the dense, vlm, moe, ssm and hybrid families
    # (tests/test_torch_llm_round.py); the audio family has no round in
    # the reference (its users hold tokens, no frames), and the launcher
    # says so before it builds anything, naming ROADMAP
    for arch in ("whisper-small",):
        with pytest.raises(ValueError, match="ROADMAP"):
            train.main(["--device", "cpu", "--arch", arch, "--users", "2",
                        "--llm-seq", "4", "--llm-seqs-per-user", "2"])


def test_launch_train_runs_the_paper_cell_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import train
    out = tmp_path / "hist.json"
    train.main(["--device", "cpu", "--rounds", "2", "--n-train", "400",
                "--n-test", "100", "--users", "4", "--batch-size", "16",
                "--out", str(out)])
    summary = json.loads(capsys.readouterr().out)
    assert summary["device"] == "cpu" and summary["uploads_total"] >= 1
    saved = json.loads(out.read_text())
    assert len(saved["accuracy"]) == 2 and len(saved["train_loss"]) == 2


@pytest.mark.parametrize("argv", [
    ["--users", "16", "--k", "2"],
    ["--users", "4", "--k", "2", "--round-mode", "sparse"],
], ids=["auto", "explicit"])
def test_launch_train_runs_the_sparse_route_on_the_cpu(capsys, argv):
    """``--round-mode sparse``, and the factory's own choice of it when k
    * 8 <= users (no flag), run the winner-sparse path end to end."""
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--rounds", "2", "--n-train", "640",
            "--n-test", "100", "--batch-size", "16", *argv]
    assert train.build_paper_engine(
        train.make_parser().parse_args(argv)).backend._mode == "sparse"
    train.main(argv)
    summary = json.loads(capsys.readouterr().out)
    assert summary["device"] == "cpu" and summary["uploads_total"] >= 1
