"""The port's sweep path (``FLEngine.run_sweep``, E lanes trained as one
(E, U, ...) stack) against the JAX package's ``run_sweep`` and against
the port's own per-round loop, on the pin scenario of
``tests/test_sweep.py`` (8 users, a 16 -> 4 linear model), inputs made
with numpy and fed to both packages: every lane's winners and history
counts exact, losses, priorities and final globals within rtol 1e-5;
the port's sweep equals its per-round runs winner for winner (losses and
priorities rtol 1e-6, as the reference's own test holds them). Also the
E = 1 delegation of ``run``, the overlap pipeline (bitwise), the AirComp
sweep fed the reference's threefry planes, the fault and objective
sweeps (m / v / h rtol 1e-5), the batch draws bit for bit, and the
launcher's ``--sweep-seeds`` / ``--ckpt``."""
import json

import jax
import numpy as np
import pytest
import torch

from repro import engine as jeng
from repro.channel import ChannelSpec as JChannelSpec
from repro.engine.engine import _Lane as JLane
from repro.faults import FaultSpec as JFaultSpec
from repro.objectives import ObjectiveSpec as JObjectiveSpec
from repro_torch import engine as teng
from repro_torch.channel import ChannelSpec as TChannelSpec
from repro_torch.engine.engine import _Lane as TLane
from repro_torch.faults import FaultSpec as TFaultSpec
from repro_torch.objectives import ObjectiveSpec as TObjectiveSpec
from torch_port_util import (HISTORY_COUNTS, PIN_USERS, assert_trees_close,
                             bitwise_equal, pin_jax_engine, pin_torch_engine,
                             threefry_noise, tree_f32)

TOL = dict(rtol=1e-5, atol=1e-6)


def _split(spec_kws):
    """Each spec's fields for the JAX and the port side: a value that is
    a ``(jax value, port value)`` pair goes one to each."""
    j = [{k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()}
         for kw in spec_kws]
    t = [{k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()}
         for kw in spec_kws]
    return j, t


def sweep_pair(spec_kws, noise_draw=None, **kw):
    """JAX ``run_sweep`` and the port's over the same cells."""
    jkw, tkw = _split(spec_kws)
    jres = pin_jax_engine(jkw[0]).run_sweep(
        [jeng.ExperimentSpec(**k) for k in jkw], **kw)
    te = pin_torch_engine(tkw[0])
    if noise_draw is not None:
        te.backend._noise_draw = noise_draw
    tres = te.run_sweep([teng.ExperimentSpec(**k) for k in tkw], **kw)
    return jres, tres


def per_round(spec_kw):
    """The port's per-round loop (``run_round``), never the sweep."""
    eng = pin_torch_engine(spec_kw)
    hist = teng.FLHistory(selections=np.zeros(PIN_USERS, np.int64))
    for t in range(eng.spec.rounds):
        eng.run_round(t, hist)
    return hist, eng


def assert_lanes_agree(jres, tres, priorities=True):
    assert len(jres) == len(tres)
    for e, (want, got) in enumerate(zip(jres, tres)):
        for name in HISTORY_COUNTS:
            assert getattr(got, name) == getattr(want, name), (e, name)
        np.testing.assert_array_equal(got.selections, want.selections)
        np.testing.assert_allclose(got.train_loss, want.train_loss,
                                   rtol=1e-5)
        if priorities:
            np.testing.assert_allclose(got.priorities, want.priorities,
                                       rtol=1e-5)
    assert_trees_close(tres.final_globals, jres.final_globals, **TOL)


@pytest.mark.parametrize("strategy", teng.PAPER_STRATEGIES)
def test_run_sweep_matches_jax_and_per_round_runs(strategy):
    specs = [dict(rounds=5, strategy=strategy, seed=s, batch_size=32)
             for s in (1, 2, 5)]
    jres, tres = sweep_pair(specs)
    assert_lanes_agree(jres, tres)
    for e, sp in enumerate(specs):
        seq, eng = per_round(sp)
        assert tres[e].winners == seq.winners, f"lane {e} diverged"
        np.testing.assert_array_equal(tres[e].selections, seq.selections)
        assert tres[e].collisions == seq.collisions
        assert tres[e].contention_slots == seq.contention_slots
        if strategy != "random-centralized":
            # pre-select lanes train the full cohort inside a sweep
            np.testing.assert_allclose(tres[e].train_loss, seq.train_loss,
                                       rtol=1e-6)
            np.testing.assert_allclose(tres[e].priorities, seq.priorities,
                                       rtol=1e-6)
            assert bitwise_equal(tres.lane_params(e), eng.global_params)


def test_mixed_strategy_sweep_matches_jax_and_per_round_runs():
    specs = [dict(rounds=4, strategy=s, seed=3)
             for s in teng.PAPER_STRATEGIES]
    jres, tres = sweep_pair(specs)
    assert_lanes_agree(jres, tres)
    for e, sp in enumerate(specs):
        assert tres[e].winners == per_round(sp)[0].winners, sp["strategy"]


def test_sweep_cells_can_vary_selection_layer():
    base = dict(rounds=4, strategy="priority-distributed", seed=0)
    jsw = jeng.SweepSpec.grid(jeng.ExperimentSpec(**base),
                              cw_base=[512.0, 2048.0],
                              counter_threshold=[0.16, 0.5])
    tsw = teng.SweepSpec.grid(teng.ExperimentSpec(**base),
                              cw_base=[512.0, 2048.0],
                              counter_threshold=[0.16, 0.5])
    jres = pin_jax_engine(base).run_sweep(jsw)
    tres = pin_torch_engine(base).run_sweep(tsw)
    assert tres.labels == jres.labels
    assert_lanes_agree(jres, tres)


def test_run_is_the_e1_special_case():
    spec = dict(rounds=5, strategy="priority-distributed", seed=4)
    eng = pin_torch_engine(spec)
    assert eng._delegates()
    h_run = eng.run()
    res = pin_torch_engine(spec).run_sweep([eng.spec])
    assert res[0].winners == h_run.winners
    assert res[0].train_loss == h_run.train_loss
    assert res[0].priorities == h_run.priorities
    assert bitwise_equal(res.lane_params(0), eng.global_params)
    # the E = 1 sweep is the per-round loop's bits
    seq, peng = per_round(spec)
    assert seq.winners == h_run.winners and seq.train_loss == h_run.train_loss
    assert bitwise_equal(peng.global_params, eng.global_params)


def test_overlap_on_off_bit_parity():
    specs = [teng.ExperimentSpec(rounds=6, strategy=s, seed=e)
             for e, s in enumerate(teng.PAPER_STRATEGIES)]
    r_on = pin_torch_engine({}).run_sweep(specs, overlap=True)
    r_off = pin_torch_engine({}).run_sweep(specs, overlap=False)
    assert r_on.overlap and not r_off.overlap
    for a, b in zip(r_on, r_off):
        assert a.winners == b.winners
        assert a.train_loss == b.train_loss          # exact, not approx
        assert a.priorities == b.priorities
        assert a.collisions == b.collisions
        assert a.contention_slots == b.contention_slots
        np.testing.assert_array_equal(a.selections, b.selections)
    assert bitwise_equal(r_on.final_globals, r_off.final_globals)


def test_run_then_run_round_continues_the_batch_streams():
    spec = dict(rounds=3, strategy="priority-distributed", seed=6)
    eng = pin_torch_engine(spec)
    eng.run()                                      # delegated sweep path
    cont = teng.FLHistory(selections=np.zeros(PIN_USERS, np.int64))
    eng.run_round(3, cont)                         # continue per round
    ref, _ = per_round(dict(spec, rounds=4))       # pure per-round run
    assert cont.winners[0] == ref.winners[3]
    assert cont.priorities[0] == ref.priorities[3]


def test_run_falls_back_when_backend_seed_mismatches():
    from torch_port_util import (pin_init, pin_torch_loss, pin_user_data,
                                 to_torch)
    spec = teng.ExperimentSpec(rounds=3, strategy="priority-distributed",
                               seed=2)

    def engine():
        backend = teng.HostBackend(pin_torch_loss, pin_user_data(), seed=5,
                                   device="cpu")
        return teng.FLEngine(spec, backend, to_torch(pin_init()))
    eng = engine()
    assert not eng._delegates()
    h = eng.run()
    ref = engine()
    hist = teng.FLHistory(selections=np.zeros(PIN_USERS, np.int64))
    for t in range(3):
        ref.run_round(t, hist)
    assert h.winners == hist.winners and h.train_loss == hist.train_loss


def test_run_sweep_rejects_non_sweep_backend():
    eng = pin_torch_engine(dict(rounds=2), round_mode="stacked")
    assert not eng._delegates()
    with pytest.raises(ValueError, match="sweep-capable"):
        eng.run_sweep([eng.spec])


def test_sweep_batches_draw_the_reference_indices():
    """Lane, epoch, user order, each from ``client_rng(seed_e, u)``: the
    (E, U, ep*take) index tensor equals the JAX backend's draw for draw,
    round after round."""
    kw = dict(rounds=2, local_epochs=2, batch_size=16)
    je, te = pin_jax_engine(kw), pin_torch_engine(kw)
    seeds = [3, 0, 7]
    jst = je.backend.sweep_init(je._init_params, seeds)
    tst = te.backend.sweep_init(te._init_params, seeds)
    for _ in range(2):
        np.testing.assert_array_equal(te.backend._draw_perms(tst.rngs),
                                      je.backend._draw_sweep_big(jst))
    batched = te.backend.sweep_batches(tst)
    assert batched["x"].shape == (3 * PIN_USERS, 2 * 4, 16, 16)


def test_aircomp_sweep_matches_jax_given_threefry_planes():
    """Three SNR points of the noisy AirComp merge: each lane's noise
    plane comes from its own key, and the port is handed the reference's
    threefry planes through ``_noise_draw``."""
    def cell(snr):  # the SNR point: transmit power, dBm
        return dict(rounds=4, seed=0, merge_backend="aircomp", channel=(
            JChannelSpec(fading="rayleigh", aircomp_gain_floor=0.3,
                         aircomp_sigma=0.05, tx_power_dbm=snr),
            TChannelSpec(fading="rayleigh", aircomp_gain_floor=0.3,
                         aircomp_sigma=0.05, tx_power_dbm=snr)))
    jres, tres = sweep_pair([cell(s) for s in (10.0, 20.0, 30.0)],
                            noise_draw=threefry_noise)
    assert_lanes_agree(jres, tres)


ACTIVE = dict(crash_prob=0.1, straggle_prob=0.3, corrupt_prob=0.2,
              outage_prob=0.1, max_retries=1, clip_norm=2.0)
LOSSY = dict(fading="rayleigh", per_snr_threshold_db=20.0)


def test_fault_sweep_matches_jax():
    cells = [dict(rounds=6, seed=s, k_per_round=3,
                  faults=(JFaultSpec(**ACTIVE), TFaultSpec(**ACTIVE)),
                  channel=(JChannelSpec(**LOSSY), TChannelSpec(**LOSSY)))
             for s in (0, 1, 2)]
    jres, tres = sweep_pair(cells)
    assert_lanes_agree(jres, tres)
    assert sum(h.stale_merges for h in tres) > 0
    for e, (jk, tk) in enumerate(zip(*_split(cells))):
        assert tres[e].winners == per_round(tk)[0].winners


OBJECTIVES = [
    None,
    dict(local="fedprox", mu=0.1),
    dict(local="feddyn", alpha=0.1),
    dict(aggregator="fedavgm", beta=0.9, server_lr=0.5),
    dict(aggregator="fedadam", server_lr=0.1),
    dict(local="feddyn", alpha=0.05, aggregator="fedavgm", beta=0.5,
         server_lr=0.8),
]


def _objective_lanes(pkg_lane, spec_cls, obj_cls, kws):
    return [pkg_lane(spec_cls(rounds=5, seed=e % 2,
                              objective=None if o is None else obj_cls(**o),
                              channel=ch), PIN_USERS)
            for e, (o, ch) in enumerate(kws)]


def test_objective_sweep_matches_jax_state_included():
    """The five active objectives and a plain lane in one sweep under the
    lossy channel: histories, globals and every lane's m / v / h."""
    je, te = pin_jax_engine({}), pin_torch_engine({})
    jlanes = _objective_lanes(JLane, jeng.ExperimentSpec, JObjectiveSpec,
                              [(o, JChannelSpec(**LOSSY)) for o in OBJECTIVES])
    tlanes = _objective_lanes(
        lambda sp, U: TLane(sp, U, device="cpu"), teng.ExperimentSpec,
        TObjectiveSpec, [(o, TChannelSpec(**LOSSY)) for o in OBJECTIVES])
    jres, jst, _ = je._run_lanes(jlanes, init_state=je._init_params,
                                 overlap=True, verbose=False)
    tres, tst, _ = te._run_lanes(tlanes, init_state=te._init_params,
                                 overlap=True, verbose=False)
    assert_lanes_agree(jres, tres)
    js = je.backend.sweep_objective_state(jst)
    ts = te.backend.sweep_objective_state(tst)
    for key in ("m", "v", "h"):
        assert_trees_close(ts[key], jax.device_get(js[key]), **TOL)
    assert np.abs(ts["h"]["w"][2]).max() > 0        # the feddyn lane moved


def test_inert_objective_lanes_are_the_plain_lane_bitwise():
    inert = [None, dict(local="fedprox", mu=0.0),
             dict(local="feddyn", alpha=0.0),
             dict(aggregator="fedavgm", beta=0.0, server_lr=1.0)]
    te = pin_torch_engine({})
    specs = [teng.ExperimentSpec(
        rounds=4, seed=0, objective=None if o is None
        else TObjectiveSpec(**o)) for o in inert] + [
        teng.ExperimentSpec(rounds=4, seed=0, objective=TObjectiveSpec(
            local="fedprox", mu=0.1))]
    res = te.run_sweep(specs)
    for e in range(1, 4):
        assert res[e].winners == res[0].winners
        assert bitwise_equal(res.lane_params(e), res.lane_params(0))
    assert not bitwise_equal(res.lane_params(4), res.lane_params(0))


def test_device_contention_sweep_runs_on_the_cpu():
    specs = [teng.ExperimentSpec(rounds=3, seed=s,
                                 contention_backend="device")
             for s in (0, 1)]
    res = pin_torch_engine({}).run_sweep(specs)
    for h in res:
        assert len(h.winners) == 3
        assert all(1 <= len(w) <= 2 for w in h.winners)


def test_launch_train_sweep_seeds_and_ckpt(capsys, tmp_path):
    from repro.checkpoint import load_checkpoint
    from repro_torch.checkpoint import load_checkpoint as t_load
    from repro_torch.launch import train
    from repro.models.paper_models import get_paper_model as j_model
    from repro_torch.models.paper_models import get_paper_model as t_model
    ck = tmp_path / "final.npz"
    train.main(["--device", "cpu", "--rounds", "2", "--n-train", "400",
                "--n-test", "100", "--users", "4", "--batch-size", "16",
                "--sweep-seeds", "3", "--ckpt", str(ck)])
    summary = json.loads(capsys.readouterr().out)
    assert summary["sweep_cells"] == 3
    assert summary["sweep_labels"] == ["seed=0", "seed=1", "seed=2"]
    assert len(summary["sweep_best_metric"]) == 3
    tmpl_t = t_model("mlp", "fashion")[0](0, device="cpu")
    got = t_load(str(ck), tmpl_t)
    assert any(np.abs(l).max() > 0 for l in jax.tree.leaves(tree_f32(got)))
    # the reference reads the port's file, leaf for leaf
    tmpl_j = j_model("mlp", "fashion")[0](jax.random.PRNGKey(0))
    assert_trees_close(tree_f32(load_checkpoint(str(ck), tmpl_j)), got,
                       rtol=0, atol=0)
    assert torch.is_tensor(jax.tree.leaves(got)[0])


def test_paper_strategy_sweep_equals_the_pins():
    """The four paper strategies x seeds 0 and 1 as ONE sweep: every
    lane's winners are the pinned ones (``tests/winner_pins.json``)."""
    import os
    with open(os.path.join(os.path.dirname(__file__),
                           "winner_pins.json")) as f:
        pins = json.load(f)
    base = teng.ExperimentSpec(rounds=pins["rounds"])
    sweep = teng.SweepSpec.grid(base, strategy=list(teng.PAPER_STRATEGIES),
                                seed=[0, 1])
    res = pin_torch_engine(dict(rounds=pins["rounds"])).run_sweep(sweep)
    for label, hist in zip(sweep.labels, res):
        key = label.replace("strategy=", "").replace(",seed=", "/seed")
        assert hist.winners == pins["winners"][key], key
