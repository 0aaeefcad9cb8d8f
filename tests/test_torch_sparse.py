"""The port's winner-sparse round path (``round_mode="sparse"``: Eq. 2
priorities before selection, then only the winners train as one compact
(K_max, ...) stack) against the JAX package's, on the setup of
``tests/test_sparse.py`` (12 users of 24 examples, a 6 -> 3 softmax model,
K = 2, batch 4), inputs made with numpy and handed to both packages:
every history count exact; losses, priorities and merged globals within
rtol 1e-5 per round. Within the port, bit for bit: sparse-prepass equals
the fused path (plain, channel, faults, AirComp, objectives, the inert
objective twin equal to plain), over three chunk widths, and the sparse
sweep equals the dense sweep and its lanes' sequential sparse runs. The
stale mode against JAX, its checkpoint / resume, its winnerless rounds and
pads; the factory's auto-selection and the refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jeng
from repro.engine.engine import _Lane as JLane
from repro.objectives import ObjectiveSpec as JObjectiveSpec
from repro_torch import engine as teng
from repro_torch.channel import ChannelSpec
from repro_torch.checkpoint import load_fl_checkpoint
from repro_torch.engine.backends import HostBackend
from repro_torch.engine.engine import _Lane as TLane
from repro_torch.faults import FaultSpec
from repro_torch.objectives import ObjectiveSpec
from torch_port_util import (HISTORY_COUNTS, LOSSY, assert_trees_close,
                             bitwise_equal, to_jax, to_torch, tree_f32)

NUM_USERS, N_PER_USER, DIM, CLASSES = 12, 24, 6, 3
TOL = dict(rtol=1e-5, atol=1e-6)


def _user_data(num_users=NUM_USERS):
    """Rectangular cohort, skewed labels (Eq. 2 separates users)."""
    rng = np.random.default_rng(11)
    data = []
    for u in range(num_users):
        probs = np.ones(CLASSES) / CLASSES
        probs[u % CLASSES] += 1.0
        probs /= probs.sum()
        data.append({
            "x": rng.normal(size=(N_PER_USER, DIM)).astype(np.float32),
            "y": rng.choice(CLASSES, N_PER_USER, p=probs)})
    return data


DATA = _user_data()


def _init():
    return {"w": np.zeros((DIM, CLASSES), np.float32),
            "b": np.zeros((CLASSES,), np.float32)}


def _jax_loss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    oh = jax.nn.one_hot(batch["y"], CLASSES)
    return -jnp.mean(jnp.sum(oh * jax.nn.log_softmax(logits), -1))


def _torch_loss(params, batch):
    logp = torch.log_softmax(batch["x"] @ params["w"] + params["b"], -1)
    return -logp.gather(-1, batch["y"].long()[:, None]).mean()


def _kw(mode="sparse", strategy="priority-distributed", *, rounds=5, seed=0,
        **kw):
    return dict(rounds=rounds, strategy=strategy, seed=seed, k_per_round=2,
                batch_size=4, round_mode=mode, **kw)


def port(spec_kw, data=DATA, **kw):
    return teng.build_host_engine(teng.ExperimentSpec(**spec_kw),
                                  to_torch(_init()), _torch_loss, data,
                                  device="cpu", **kw)


def jax_engine(spec_kw):
    return jeng.build_host_engine(jeng.ExperimentSpec(**spec_kw),
                                  to_jax(_init()), _jax_loss, DATA)


def run(spec_kw, **kw):
    eng = port(spec_kw, **kw)
    return eng.run(), eng


def assert_same_run(a, ea, b, eb):
    """Two port runs hold the same bits: every history count, losses,
    priorities and the final global."""
    for name in HISTORY_COUNTS:
        assert getattr(a, name) == getattr(b, name), name
    assert a.train_loss == b.train_loss
    assert a.priorities == b.priorities
    assert bitwise_equal(ea.global_params, eb.global_params)


# -------------------------------------------- port sparse = JAX sparse
@pytest.mark.parametrize("strategy", teng.PAPER_STRATEGIES)
def test_sparse_prepass_matches_jax_round_by_round(strategy):
    """Both engines' per-round loops side by side: every history count
    exact, and after each round the losses, priorities and merged global
    within rtol 1e-5."""
    je, te = jax_engine(_kw(strategy=strategy)), port(_kw(strategy=strategy))
    assert te.backend._mode == je.backend._mode == "sparse"
    jh = jeng.FLHistory(selections=np.zeros(NUM_USERS, np.int64))
    th = teng.FLHistory(selections=np.zeros(NUM_USERS, np.int64))
    for t in range(5):
        je.run_round(t, jh)
        te.run_round(t, th)
        for name in HISTORY_COUNTS:
            assert getattr(th, name) == getattr(jh, name), (t, name)
        np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=1e-5)
        np.testing.assert_allclose(th.priorities, jh.priorities, rtol=1e-5)
        assert_trees_close(te.global_params, je.global_params, **TOL)
    np.testing.assert_array_equal(th.selections, jh.selections)


def test_sparse_stale_matches_jax():
    """Stale priorities: the winners of JAX's stale run, globals within
    rtol 1e-5, the priority caches within rtol 1e-5."""
    kw = _kw(rounds=6, sparse_priority="stale")
    je, te = jax_engine(kw), port(kw)
    jh, th = je.run(), te.run()
    for name in HISTORY_COUNTS:
        assert getattr(th, name) == getattr(jh, name), name
    np.testing.assert_allclose(th.train_loss, jh.train_loss, rtol=1e-5)
    np.testing.assert_allclose(th.priorities, jh.priorities, rtol=1e-5)
    np.testing.assert_allclose(te.backend.priority_cache_state(),
                               je.backend.priority_cache_state(), rtol=1e-5)
    assert_trees_close(te.global_params, je.global_params, **TOL)


# ------------------------------------ port sparse-prepass = port fused
def test_one_winner_stack_is_a_copy_of_the_global():
    """k = 1: the sparse path trains a one-row stack, which must be a copy
    of the global (a one-row broadcast made contiguous would be the
    global's own storage, trained in place): the fused run's bits."""
    hf, ef = run(_kw("fused") | {"k_per_round": 1})
    hs, es = run(_kw("sparse") | {"k_per_round": 1})
    assert_same_run(hs, es, hf, ef)


@pytest.mark.parametrize("strategy", teng.PAPER_STRATEGIES)
def test_sparse_prepass_bit_equal_to_fused(strategy):
    """Winners and the global bit for bit; losses and priorities too where
    the strategy uses Eq. 2 (without it the sparse path skips the prepass
    and reports the winners' losses)."""
    hf, ef = run(_kw("fused", strategy))
    hs, es = run(_kw("sparse", strategy))
    assert hs.winners == hf.winners and hs.delivered == hf.delivered
    if hf.priorities:
        assert hs.train_loss == hf.train_loss
        assert hs.priorities == hf.priorities
    assert bitwise_equal(es.global_params, ef.global_params)


@pytest.mark.parametrize("chunk", [1, 5, 256])
def test_sparse_chunk_width_gives_the_same_bits(chunk):
    """The prepass trains C users at a time: C = 1, 5 (a last chunk of 2)
    and 256 (the whole cohort) give the fused path's bits."""
    hf, ef = run(_kw("fused"))
    backend = HostBackend(_torch_loss, DATA, batch_size=4, seed=0,
                          round_mode="sparse", k_max=2, sparse_chunk=chunk,
                          device="cpu")
    es = teng.FLEngine(teng.ExperimentSpec(**_kw("sparse")), backend,
                       to_torch(_init()))
    assert_same_run(es.run(), es, hf, ef)


TWINS = {
    "channel": dict(channel=ChannelSpec(**LOSSY)),
    "faults": dict(rounds=8, channel=ChannelSpec(**LOSSY),
                   faults=FaultSpec(crash_prob=0.1, straggle_prob=0.3,
                                    corrupt_prob=0.2, clip_norm=2.0)),
    "aircomp-sigma0": dict(merge_backend="aircomp", channel=ChannelSpec(
        fading="rayleigh", aircomp_gain_floor=0.3)),
    "aircomp-sigma0.05": dict(merge_backend="aircomp", channel=ChannelSpec(
        fading="rayleigh", aircomp_gain_floor=0.3, aircomp_sigma=0.05)),
    "fedprox+fedadam": dict(objective=ObjectiveSpec(
        local="fedprox", mu=0.1, aggregator="fedadam", server_lr=0.1)),
    "feddyn+fedavgm-attempts": dict(
        rounds=8, channel=ChannelSpec(**LOSSY), objective=ObjectiveSpec(
            local="feddyn", alpha=0.1, aggregator="fedavgm", beta=0.5,
            server_lr=0.8)),
}


@pytest.mark.parametrize("twin", list(TWINS))
def test_sparse_prepass_layers_bit_equal_to_fused(twin):
    """The channel (lost uploads), the robust merge under faults (a
    straggler's row read by position, its weight by user id), AirComp
    (coefficients by user id; noiseless and on the counter-based planes
    both routes draw alike) and two objectives (FedDyn's h rows written
    by user id from positions, with rounds of attempts and no
    deliveries): every history count, losses, priorities and the global
    bit for bit against the fused path."""
    hf, ef = run(_kw("fused", **TWINS[twin]))
    hs, es = run(_kw("sparse", **TWINS[twin]))
    assert_same_run(hs, es, hf, ef)
    if twin == "faults":
        assert hs.stale_merges > 0 and hs.quarantined_updates >= 0
    if twin == "feddyn+fedavgm-attempts":
        assert any(w and not d for w, d in zip(hs.winners, hs.delivered))
        for part in ("h", "m", "v"):
            for a, b in zip(jax.tree.leaves(ef.backend.objective_state()[
                    part]), jax.tree.leaves(
                    es.backend.objective_state()[part])):
                assert np.array_equal(a, b)


def test_sparse_inert_objective_twin_bit_equal_to_plain():
    """FedDyn at alpha 0 with FedAvgM at beta 0 / server_lr 1 on the
    sparse path: the plain sparse run's bits."""
    inert = ObjectiveSpec(local="feddyn", alpha=0.0, aggregator="fedavgm",
                          beta=0.0, server_lr=1.0)
    hp, ep = run(_kw())
    hi, ei = run(_kw(objective=inert))
    assert_same_run(hi, ei, hp, ep)


# --------------------------------------------------------- stale mode
def test_sparse_stale_checkpoint_resume_bit_identical(tmp_path):
    """A checkpointed stale run resumed by a fresh engine equals the
    uninterrupted run bit for bit; the payload carries the cache."""
    kw = _kw(rounds=6, sparse_priority="stale")
    want, ref = run(kw)
    first = port(kw)
    h1 = first.run(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    payload = load_fl_checkpoint(str(tmp_path))
    assert payload["kind"] == "run" and payload["round"] == 3
    cache = payload["priority_cache"]
    assert cache.shape == (NUM_USERS,) and (cache > 1.0).any()
    again = port(kw)
    h2 = again.run(checkpoint_dir=str(tmp_path))
    assert_same_run(h1, first, want, ref)
    assert_same_run(h2, again, want, ref)
    np.testing.assert_array_equal(again.backend.priority_cache_state(),
                                  ref.backend.priority_cache_state())


def test_sparse_stale_winnerless_round_draws_nothing_and_keeps_the_stack():
    """A stale round without winners trains nothing, consumes no client
    stream and leaves the resident stack in place."""
    eng = port(_kw(sparse_priority="stale"))
    be = eng.backend
    state = eng.state
    prios, losses = be.sparse_priorities(state, True)
    assert losses is None and (prios == 1.0).all()
    tr = be.sparse_train(state, [4, 9])
    state = be.merge(state, tr, [4, 9], attempts=[4, 9])
    resident = be._resident
    assert resident is not None and be._resident_key is state
    streams = be.client_stream_states()
    empty = be.sparse_train(state, [])
    assert empty.local_handle == {"sparse_stack": None, "winners": []}
    assert empty.losses == {}
    assert be.client_stream_states() == streams
    assert be._resident is resident and be._resident_key is state
    # the stale cache holds the winners' trained priorities
    cache = be.priority_cache_state()
    assert (cache[[4, 9]] > 1.0).all() and (np.delete(cache, [4, 9]) == 1).all()


def test_sparse_short_round_pads_at_index_zero_with_zero_weight():
    """One winner under k_max = 2: the pad row trains on user 0's index-0
    batches, rides at weight 0, and the merge is the one-winner Eq. 1 —
    the global equal to the winner's trained row."""
    eng = port(_kw(sparse_priority="stale"))
    be, state = eng.backend, eng.state
    tr = be.sparse_train(state, [7])
    stack = tr.local_handle["sparse_stack"]
    assert all(t.shape[0] == 2 for t in jax.tree.leaves(stack))
    assert list(tr.losses) == [7]
    row = be.extract_local(tr, 7)
    new = be.merge(state, tr, [7], attempts=[7])
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(new),
                                                 jax.tree.leaves(row)))


# ------------------------------------------------------------ sweeps
def test_sparse_sweep_matches_jax_dense_sweep_and_sequential_runs():
    """A 4-lane sparse sweep (two strategies x two seeds): every lane's
    history counts equal JAX's sparse sweep (globals rtol 1e-5), and bit
    for bit the port's dense sweep and each lane's sequential sparse
    run."""
    grid = dict(strategy=["priority-distributed", "random-distributed"],
                seed=[0, 1])
    jsw = jeng.SweepSpec.grid(jeng.ExperimentSpec(**_kw()), **grid)
    jres = jax_engine(_kw()).run_sweep(jsw)
    res = {}
    for mode in ("fused", "sparse"):
        sw = teng.SweepSpec.grid(teng.ExperimentSpec(**_kw(mode)), **grid)
        res[mode] = port(_kw(mode)).run_sweep(sw)
    assert res["sparse"].overlap is False
    for e, (j, d, s) in enumerate(zip(jres, res["fused"], res["sparse"])):
        for name in HISTORY_COUNTS:
            assert getattr(s, name) == getattr(j, name), (e, name)
            assert getattr(s, name) == getattr(d, name), (e, name)
        np.testing.assert_allclose(s.train_loss, j.train_loss, rtol=1e-5)
        assert s.train_loss == d.train_loss and s.priorities == d.priorities
        assert bitwise_equal(res["sparse"].lane_params(e),
                             res["fused"].lane_params(e))
        h1, e1 = run(dict(_kw(), strategy=sw.specs[e].strategy,
                          seed=sw.specs[e].seed))
        assert h1.winners == s.winners
        if h1.priorities:
            # a run without Eq. 2 reports its winners' losses; its lane,
            # in a sweep with a priority lane, the prepass losses
            assert h1.train_loss == s.train_loss
        assert bitwise_equal(e1.global_params, res["sparse"].lane_params(e))
    assert_trees_close(res["sparse"].final_globals, jres.final_globals,
                       **TOL)


@pytest.mark.parametrize("layer", ["faults", "aircomp-sigma0.05",
                                   "feddyn+fedavgm-attempts"])
def test_sparse_layer_sweep_bit_equal_to_dense_sweep(layer):
    """The robust, AirComp and objective sweep merges on the (E, K_max,
    ...) stack by position: each lane the dense sweep's bits."""
    specs = {mode: [teng.ExperimentSpec(**_kw(mode, seed=s, **TWINS[layer]))
                    for s in (0, 1)] for mode in ("fused", "sparse")}
    d = port(_kw("fused")).run_sweep(specs["fused"])
    s = port(_kw()).run_sweep(specs["sparse"])
    for e in range(2):
        for name in HISTORY_COUNTS:
            assert getattr(s[e], name) == getattr(d[e], name), (e, name)
        assert s[e].train_loss == d[e].train_loss
        assert bitwise_equal(s.lane_params(e), d.lane_params(e))


def test_sparse_stale_sweep_equals_jax_and_its_sequential_runs():
    kw = _kw(rounds=6, sparse_priority="stale")
    grid = dict(seed=[0, 1, 2])
    jres = jax_engine(kw).run_sweep(
        jeng.SweepSpec.grid(jeng.ExperimentSpec(**kw), **grid))
    sw = teng.SweepSpec.grid(teng.ExperimentSpec(**kw), **grid)
    tres = port(kw).run_sweep(sw)
    for e, (j, t) in enumerate(zip(jres, tres)):
        for name in HISTORY_COUNTS:
            assert getattr(t, name) == getattr(j, name), (e, name)
        h1, e1 = run(dict(kw, seed=sw.specs[e].seed))
        assert h1.winners == t.winners and h1.train_loss == t.train_loss
        assert bitwise_equal(e1.global_params, tres.lane_params(e))
    assert_trees_close(tres.final_globals, jres.final_globals, **TOL)


def test_sparse_sweep_checkpoint_raises(tmp_path):
    eng = port(_kw())
    with pytest.raises(NotImplementedError, match="checkpoint"):
        eng.run_sweep([eng.spec], checkpoint_dir=str(tmp_path))


def test_sparse_sweep_objective_state_matches_jax():
    """FedDyn + FedAdam and FedProx lanes through both packages' sparse
    lane loops: history counts exact, globals and m / v / h within rtol
    1e-5 of JAX's."""
    objs = [dict(local="feddyn", alpha=0.1, aggregator="fedadam",
                 server_lr=0.1), dict(local="fedprox", mu=0.1)]
    jspecs = [jeng.ExperimentSpec(**_kw(objective=JObjectiveSpec(**o),
                                        seed=s)) for s, o in enumerate(objs)]
    tspecs = [teng.ExperimentSpec(**_kw(objective=ObjectiveSpec(**o),
                                        seed=s)) for s, o in enumerate(objs)]
    je, te = jax_engine(_kw()), port(_kw())
    jres, jst, _ = je._run_lanes_sparse(
        [JLane(sp, NUM_USERS) for sp in jspecs], init_state=to_jax(_init()),
        verbose=False)
    tres, tst, _ = te._run_lanes_sparse(
        [TLane(sp, NUM_USERS, device="cpu") for sp in tspecs],
        init_state=to_torch(_init()), verbose=False)
    for j, t in zip(jres, tres):
        for name in HISTORY_COUNTS:
            assert getattr(t, name) == getattr(j, name), name
    assert_trees_close(tres.final_globals, jres.final_globals, **TOL)
    want = je.backend.sweep_objective_state(jst)
    got = te.backend.sweep_objective_state(tst)
    for part in ("m", "v", "h"):
        for a, b in zip(jax.tree.leaves(tree_f32(want[part])),
                        jax.tree.leaves(tree_f32(got[part]))):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)


# ----------------------------------------------------------- factory
def test_factory_auto_selects_sparse_and_an_explicit_mode_wins():
    """16 users at k = 2 (k * 8 <= U) auto-select the sparse path, with
    the spec's priority mode; 12 users stay fused; an explicit mode wins,
    as an argument or in the spec."""
    data = _user_data(16)
    spec = dict(rounds=2, k_per_round=2, batch_size=4)
    eng = port(spec, data=data)
    assert eng.backend._mode == "sparse" and eng.backend.sparse_capable()
    assert eng.backend.sweep_sparse_capable()
    assert len(eng.run().winners) == 2
    stale = port(dict(spec, sparse_priority="stale"), data=data)
    assert stale.backend._sparse_priority == "stale"
    assert port(spec).backend._mode == "fused"
    assert port(spec, data=data, round_mode="fused").backend._mode == "fused"
    assert port(dict(spec, round_mode="stacked"),
                data=data).backend._mode == "stacked"
    assert port(spec, data=data,
                prefer_vmap=False).backend._mode == "ragged"


def test_sparse_refusals():
    """A ragged cohort under "sparse" and a sparse backend without k_max
    raise ValueError; an uneven cohort auto-selects a dense path; a mesh
    still raises NotImplementedError."""
    ragged = [dict(d) for d in _user_data(16)]
    ragged[0] = {k: v[:8] for k, v in ragged[0].items()}
    with pytest.raises(ValueError, match="rectangular"):
        port(_kw(), data=ragged)
    auto = port(dict(rounds=1, k_per_round=2, batch_size=4), data=ragged)
    assert auto.backend._mode == "fused" and not auto.backend._rect
    assert len(auto.run().winners) == 1
    with pytest.raises(ValueError, match="k_max"):
        HostBackend(_torch_loss, DATA, round_mode="sparse", device="cpu")
    with pytest.raises(ValueError, match="sparse_priority"):
        HostBackend(_torch_loss, DATA, round_mode="sparse", k_max=2,
                    sparse_priority="bogus", device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        port(_kw(), mesh=object())
    eng = port(_kw())
    with pytest.raises(ValueError, match="exceed k_max"):
        eng.backend.sparse_train(eng.state, [0, 1, 2])


def test_stale_sparse_sweeps_on_one_engine_start_from_ones():
    """The port keeps a stale sparse sweep's priority cache on that
    sweep's ``SweepState``, so every sweep starts from the all-ones
    cache: two stale sweeps on one engine give equal first rounds (and
    equal runs). A deliberate difference: the reference keeps one cache
    per lane count on the backend (``src/repro/engine/backends.py:403``,
    ``:1982-1989``), so there a second stale sweep of the same engine
    starts from the priorities the first one left."""
    kw = _kw(rounds=4, sparse_priority="stale")
    eng = port(kw)
    sw = teng.SweepSpec.grid(teng.ExperimentSpec(**kw), seed=[0, 1])
    first, second = eng.run_sweep(sw), eng.run_sweep(sw)
    for a, b in zip(first, second):
        assert a.winners[0] == b.winners[0]
        assert a.train_loss[0] == b.train_loss[0]
        assert a.priorities[0] == b.priorities[0]
        assert a.winners == b.winners and a.train_loss == b.train_loss
    for e in range(len(sw.specs)):
        assert bitwise_equal(first.lane_params(e), second.lane_params(e))
