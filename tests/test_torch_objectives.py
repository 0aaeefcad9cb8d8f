"""The objectives layer of the port against the JAX package, on the CPU.

  (a) the server step op: the port's wrapper (its plain version on a CPU
      tensor) against ``repro.kernels.ref`` and the Pallas kernel in
      interpret mode, kinds 0 / 1 / 2 — f32 ``rtol=1e-5, atol=1e-6``,
      bf16 ``atol=0.02`` (one ulp of the output type), the bars of
      ``tests/test_kernels.py`` — and its passthrough contracts bitwise;
  (b) the local gradient law (``objective_epoch_scan``) against the
      reference's, ``rtol=1e-5``; with ``prox == 0`` and a zero h it is
      the plain loop bit for bit;
  (c) the engine end to end on the pin scenario of
      ``tools/check_winner_pins.py`` (8 users, 16 -> 4 linear model, 4
      rounds, seeds 0 and 1) for every active spec of
      ``tests/test_objectives.py`` against the JAX engine's ``run()``:
      every count of the history exactly, globals and the m / v / h
      state ``rtol=1e-5, atol=1e-6``; FedDyn under a lossy channel with
      failure faults, attempted-but-undelivered rounds included;
  (d) the contracts within the port: inert specs bit-transparent,
      FedDyn's first round FedProx's, a winnerless merge keeps m, v and
      the global bitwise; the engine's refusals.
"""
import jax
import numpy as np
import pytest
import torch

from repro.channel import ChannelSpec as JChannelSpec
from repro.faults import FaultSpec as JFaultSpec
from repro.kernels import ops as jops, ref as jref
from repro.objectives import ObjectiveSpec as JObjectiveSpec
from repro.objectives.local import objective_epoch_scan as j_scan
from repro_torch import engine as teng
from repro_torch.core.client import sgd_epoch_scan
from repro_torch.engine.backends import HostBackend as THostBackend
from repro_torch.faults import FaultSpec
from repro_torch.kernels import ops as tops
from repro_torch.objectives import ObjectiveSpec, objective_epoch_scan

from torch_port_util import (LOSSY, PIN_USERS, SEEDS, arr_j, arr_t,
                             assert_runs_agree, bits, bitwise_equal, f32,
                             pin_init, pin_jax_loss, pin_torch_loss,
                             pin_user_data, run_pair, run_port, to_jax,
                             to_torch)

SHAPES = [(127,), (2, 129, 5), (10,), (784, 200)]
DTYPES = ["float32", "bfloat16"]
#: [kind, beta1, beta2, server_lr, eps] — identity, FedAvgM, FedAdam
KINDS = {
    "identity": np.asarray([0, 0.0, 0.0, 1.0, 1e-3], np.float32),
    "momentum": np.asarray([1, 0.9, 0.0, 0.5, 1e-3], np.float32),
    "adam": np.asarray([2, 0.9, 0.99, 0.1, 1e-3], np.float32),
}

#: tests/test_objectives.py:266-273 and :302-309, in each package
INERT = [dict(), dict(local="fedprox", mu=0.0),
         dict(local="feddyn", alpha=0.0),
         dict(aggregator="fedavgm", beta=0.0, server_lr=1.0),
         dict(local="feddyn", alpha=0.0, aggregator="fedavgm", beta=0.0,
              server_lr=1.0)]
ACTIVE = [dict(local="fedprox", mu=0.1), dict(local="feddyn", alpha=0.1),
          dict(aggregator="fedavgm", beta=0.9, server_lr=0.5),
          dict(aggregator="fedadam", server_lr=0.1),
          dict(local="feddyn", alpha=0.05, aggregator="fedavgm", beta=0.5,
               server_lr=0.8)]


def _ids(specs):
    return [f"{s.get('local', 'fedavg')}/{s.get('aggregator', 'fedavg')}"
            for s in specs]


def _atol(dtype):
    return 1e-6 if dtype == "float32" else 0.02


def _opt_case(shape, seed):
    """(avg, old, m, v) with v >= 0, as the reference's test makes them."""
    rng = np.random.default_rng(seed)
    mk = lambda: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return mk(), mk(), mk(), np.abs(mk())


def _both(case, dtype):
    return ([arr_t(a, dtype) for a in case], [arr_j(a, dtype) for a in case])


# --------------------------------------------------- (a) the server step
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_server_opt_matches_jax_ref(kind, shape, dtype):
    (t, j) = _both(_opt_case(shape, seed=len(shape)), dtype)
    got = tops.server_opt_combine(*t, KINDS[kind])
    want = jref.server_opt_combine_ref(*j, KINDS[kind])
    for g, w in zip(got, want):
        assert g.shape == shape and str(g.dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(f32(g), f32(w), rtol=1e-5,
                                   atol=_atol(dtype))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("shape", [(127,), (2, 129, 5), (784, 200)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_server_opt_matches_pallas_interpret(kind, shape, dtype):
    (t, j) = _both(_opt_case(shape, seed=7), dtype)
    got = tops.server_opt_combine(*t, KINDS[kind])
    want = jops.server_opt_combine(*j, KINDS[kind], interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(f32(g), f32(w), rtol=1e-5,
                                   atol=_atol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("consts", [[0, 0.9, 0.99, 0.5, 1e-3],
                                    [1, 0.0, 0.0, 1.0, 1e-3]],
                         ids=["identity", "momentum-inert"])
def test_server_opt_inert_is_bitwise_passthrough(dtype, consts):
    avg, old, m, v = [arr_t(a, dtype) for a in _opt_case((3, 33), seed=5)]
    out, nm, nv = tops.server_opt_combine(avg, old, m, v, consts)
    assert np.array_equal(bits(out), bits(avg))
    # the law keeps v where it does not update it, and kind 0 keeps m
    assert np.array_equal(bits(nv), bits(v))
    if consts[0] == 0:
        assert np.array_equal(bits(nm), bits(m))


@pytest.mark.parametrize("dtype", DTYPES)
def test_server_opt_near_inert_momentum_is_not_a_passthrough(dtype):
    avg, old, m, v = [arr_t(a, dtype) for a in _opt_case((3, 33), seed=6)]
    out, _, nv = tops.server_opt_combine(avg, old, m, v,
                                         [1, 0.0, 0.0, 0.5, 1e-3])
    assert not np.array_equal(bits(out), bits(avg))
    assert np.array_equal(bits(nv), bits(v))


def test_server_opt_adam_law_and_fresh_outputs():
    avg, old, m, v = _opt_case((4, 6), seed=4)
    b1, b2, slr, eps = 0.9, 0.99, 0.1, 1e-3
    t = [arr_t(a) for a in (avg, old, m, v)]
    out, nm, nv = tops.server_opt_combine(*t, [2, b1, b2, slr, eps])
    d = old - avg
    wm = b1 * m + (1 - b1) * d
    wv = b2 * v + (1 - b2) * d * d
    np.testing.assert_allclose(f32(nm), wm, rtol=1e-5)
    np.testing.assert_allclose(f32(nv), wv, rtol=1e-5)
    np.testing.assert_allclose(f32(out), old - slr * wm / (np.sqrt(wv) + eps),
                               rtol=1e-5)
    # the inputs are only read
    for a, x in zip(t, (avg, old, m, v)):
        assert np.array_equal(f32(a), x)


# ---------------------------------------------- (b) the local gradient law
def _scan_case(seed=3, U=3, nb=4, bs=16):
    """A stacked cohort, its batches, the anchor and an h state. Feature
    3 is zero in every example and its weights start at -0.0, so its
    gradient rows are signed zeros and an unguarded ``g + 0 * (w - w_g)``
    would flip bits of the trained weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(U, nb, bs, 16)).astype(np.float32)
    x[..., 3] = 0.0
    y = rng.integers(0, 4, size=(U, nb, bs)).astype(np.int32)
    glob = {"w": (rng.normal(size=(16, 4)) * 0.3).astype(np.float32),
            "b": (rng.normal(size=(4,)) * 0.3).astype(np.float32)}
    glob["w"][3] = -0.0
    h = {k: (rng.normal(size=(U,) + v.shape) * 0.05).astype(np.float32)
         for k, v in glob.items()}
    return {"x": x, "y": y}, glob, h, U


def _port_scan(prox, h, use_h=True):
    data, glob, h0, U = _scan_case()
    stack = {k: torch.from_numpy(np.repeat(v[None], U, 0)) for k, v in
             glob.items()}
    hh = to_torch(h if h is not None else h0) if use_h else None
    run = objective_epoch_scan(pin_torch_loss, 0.05, use_h)
    args = (stack, {k: torch.from_numpy(v) for k, v in data.items()},
            to_torch(glob), prox) + ((hh,) if use_h else ())
    return run(*args)


@pytest.mark.parametrize("prox", [0.0, 0.1])
@pytest.mark.parametrize("h_zero", [True, False], ids=["h0", "h"])
def test_objective_epoch_scan_matches_jax(prox, h_zero):
    data, glob, h, U = _scan_case()
    if h_zero:
        h = {k: np.zeros_like(v) for k, v in h.items()}
    run = j_scan(pin_jax_loss, 0.05, True)
    stack = jax.tree.map(lambda v: np.repeat(v[None], U, 0), glob)
    want, wl = jax.vmap(run, in_axes=(0, 0, None, None, 0))(
        to_jax(stack), {"x": arr_j(data["x"]), "y": data["y"]}, to_jax(glob),
        np.float32(prox), to_jax(h))
    got, gl = _port_scan(prox, h)
    for k in glob:
        np.testing.assert_allclose(f32(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f32(gl), np.asarray(wl), rtol=1e-5)


@pytest.mark.parametrize("use_h", [False, True], ids=["fedprox", "feddyn"])
def test_objective_epoch_scan_inert_is_the_plain_loop_bitwise(use_h):
    data, glob, h, U = _scan_case()
    zero_h = {k: np.zeros_like(v) for k, v in h.items()}
    got, gl = _port_scan(0.0, zero_h, use_h=use_h)
    stack = {k: torch.from_numpy(np.repeat(v[None], U, 0)) for k, v in
             glob.items()}
    want, wl = sgd_epoch_scan(pin_torch_loss, 0.05)(
        stack, {k: torch.from_numpy(v) for k, v in data.items()})
    assert bitwise_equal(got, want) and torch.equal(gl, wl)
    # the signed zeros of feature 3 survived: a guard was needed
    assert np.signbit(f32(got["w"])[:, 3]).any()


# -------------------------------------------- (c) the engine against JAX
def _pair(kw):
    return JObjectiveSpec(**kw), ObjectiveSpec(**kw)


def _assert_objective_states_agree(je, te):
    js, ts = je.backend.objective_state(), te.backend.objective_state()
    for part in ("m", "v", "h"):
        if js[part] is None:
            assert ts[part] is None, part
            continue
        for leaf in js[part]:
            np.testing.assert_allclose(ts[part][leaf],
                                       np.asarray(js[part][leaf]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("obj", ACTIVE, ids=_ids(ACTIVE))
@pytest.mark.parametrize("seed", SEEDS)
def test_active_objective_run_matches_jax_engine(obj, seed):
    want, got, je, te = run_pair(dict(strategy="priority-distributed",
                                      seed=seed, objective=_pair(obj)))
    assert got.winners == want.winners
    assert_runs_agree(want, got, je, te)
    _assert_objective_states_agree(je, te)
    assert te.backend.objective_active()
    st = te.backend.objective_state()
    assert (st["h"] is not None) == ("feddyn" in str(obj))
    assert (st["m"] is not None) == ("aggregator" in obj)


def test_feddyn_under_lossy_channel_and_failure_faults_matches_jax():
    """tests/test_objectives.py:371-380 on the pin scenario with the
    lossy channel: rounds whose attempts all fail still advance h."""
    obj = dict(local="feddyn", alpha=0.1, aggregator="fedavgm", beta=0.5,
               server_lr=0.8)
    flt = dict(quarantine=False, crash_prob=0.4, outage_prob=0.3,
               max_retries=1)
    want, got, je, te = run_pair(dict(
        strategy="priority-distributed", seed=0, objective=_pair(obj),
        channel=(JChannelSpec(**LOSSY), teng.ChannelSpec(**LOSSY)),
        faults=(JFaultSpec(**flt), FaultSpec(**flt))), rounds=6)
    assert_runs_agree(want, got, je, te)
    _assert_objective_states_agree(je, te)
    undelivered = [t for t, (w, d) in enumerate(zip(got.winners,
                                                    got.delivered))
                   if w and not d]
    assert undelivered, (got.winners, got.delivered)
    for leaf in te.global_params.values():
        assert torch.isfinite(leaf).all()


# ----------------------------------------- (d) the contracts in the port
@pytest.mark.parametrize("obj", INERT, ids=_ids(INERT))
def test_inert_objective_is_bit_transparent(obj):
    h_ref, e_ref = run_port()
    hist, eng = run_port(objective=ObjectiveSpec(**obj))
    assert hist.winners == h_ref.winners
    assert bitwise_equal(eng.global_params, e_ref.global_params)
    assert eng.backend.objective_active() == bool(obj)


def test_feddyn_first_round_is_fedprox():
    """With h = 0 FedDyn's first-round law IS FedProx with mu = alpha:
    the globals after round 0 are bit-equal. h moves the global once a
    user whose h was updated is merged again: here in round 4, the first
    to merge a user of round 0, after which the trajectories differ."""
    a = 0.1
    dyn = ObjectiveSpec(local="feddyn", alpha=a)
    prox = ObjectiveSpec(local="fedprox", mu=a)
    _, e_dyn = run_port(rounds=1, objective=dyn)
    _, e_prox = run_port(rounds=1, objective=prox)
    assert bitwise_equal(e_dyn.global_params, e_prox.global_params)
    h_dyn, e_dyn4 = run_port(rounds=5, objective=dyn)
    _, e_prox4 = run_port(rounds=5, objective=prox)
    assert set(h_dyn.winners[4]) & set(sum(h_dyn.winners[:4], []))
    assert not bitwise_equal(e_dyn4.global_params, e_prox4.global_params)


def _backend(obj):
    return THostBackend(pin_torch_loss, pin_user_data(), lr=0.05,
                        batch_size=16, seed=3, round_mode="fused", k_max=2,
                        objective=obj, device="cpu")


def test_winnerless_merge_keeps_m_v_and_the_global_bitwise():
    be = _backend(ObjectiveSpec(local="feddyn", alpha=0.1,
                                aggregator="fedadam", server_lr=0.1))
    ids = list(range(PIN_USERS))
    state = be.init_state(to_torch(pin_init()))
    state = be.merge(state, be.train_round(state, 0, ids, True), [4, 1],
                     attempts=[4, 1])
    before = be.objective_state()
    assert np.any(before["m"]["w"] != 0) and np.any(before["h"]["w"] != 0)
    # attempts, no deliveries: the global and m / v stay, h advances
    new = be.merge(state, be.train_round(state, 1, ids, True), [],
                   attempts=[2, 6])
    after = be.objective_state()
    assert bitwise_equal(new, state)
    for part in ("m", "v"):
        for leaf in before[part]:
            assert np.array_equal(after[part][leaf].view(np.int32),
                                  before[part][leaf].view(np.int32))
    for leaf in before["h"]:
        changed = np.any(after["h"][leaf] != before["h"][leaf],
                         axis=tuple(range(1, before["h"][leaf].ndim)))
        assert changed.tolist() == [u in (2, 6) for u in ids]


def test_objective_state_round_trips():
    be = _backend(ObjectiveSpec(local="feddyn", alpha=0.1,
                                aggregator="fedavgm", server_lr=0.5))
    assert be.objective_state() == {"m": None, "v": None, "h": None}
    ids = list(range(PIN_USERS))
    state = be.init_state(to_torch(pin_init()))
    be.merge(state, be.train_round(state, 0, ids, True), [3], attempts=[3])
    snap = be.objective_state()
    be2 = _backend(be._objective)
    be2.restore_objective_state(snap)
    again = be2.objective_state()
    for part in snap:
        for leaf in snap[part]:
            assert np.array_equal(again[part][leaf], snap[part][leaf])
    # the snapshot is a copy: a later merge does not write into it
    h3 = snap["h"]["w"][3].copy()
    be.merge(state, be.train_round(state, 1, ids, True), [3], attempts=[3])
    assert np.array_equal(snap["h"]["w"][3], h3)
    assert _backend(None).objective_state() is None


def test_objective_state_widens_bf16_to_f32():
    be = _backend(ObjectiveSpec(local="feddyn", alpha=0.1,
                                aggregator="fedadam", server_lr=0.1))
    m = {"w": torch.tensor([[1.5, -0.25]], dtype=torch.bfloat16)}
    be._obj_m, be._obj_v, be._obj_h = m, m, None
    snap = be.objective_state()
    assert snap["h"] is None
    for part in ("m", "v"):
        assert snap[part]["w"].dtype == np.float32
        assert snap[part]["w"].tolist() == [[1.5, -0.25]]


def test_engine_refuses_a_backend_without_the_objective():
    spec = teng.ExperimentSpec(rounds=1, objective=ObjectiveSpec(
        local="fedprox", mu=0.1))
    with pytest.raises(ValueError, match="objective"):
        teng.FLEngine(spec, _backend(None), to_torch(pin_init()))


def test_engine_refuses_an_objective_with_a_partial_cohort_strategy():
    obj = ObjectiveSpec(local="fedprox", mu=0.1)
    spec = teng.ExperimentSpec(rounds=1, strategy="random-centralized",
                               objective=obj)
    with pytest.raises(ValueError, match="trains_before_selection"):
        teng.FLEngine(spec, _backend(obj), to_torch(pin_init()))
    be = _backend(obj)
    with pytest.raises(RuntimeError, match="unfused"):
        be.train_round(be.init_state(to_torch(pin_init())), 0, [0, 1], True)


def test_unported_objective_programs_still_raise(tmp_path):
    obj = ObjectiveSpec(local="feddyn", alpha=0.1, aggregator="fedadam")
    _, eng = run_port(rounds=1, objective=obj)
    # the objective sweep and checkpoints are ported: these run
    res = eng.run_sweep([eng.spec])
    assert len(res) == 1 and len(res[0].winners) == 1
    _, fresh = run_port(rounds=2, objective=obj)
    fresh.run(checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert (tmp_path / "fl_ckpt.pkl").exists()
    # and so is the sparse round path with the objective on
    sparse = THostBackend(pin_torch_loss, pin_user_data(), round_mode="sparse",
                          k_max=2, objective=obj, device="cpu")
    hist = teng.FLEngine(teng.ExperimentSpec(rounds=2, objective=obj),
                         sparse, to_torch(pin_init())).run()
    assert len(hist.winners) == 2 and sparse.objective_state()["h"] is not None


def _bf16_loss(params, batch):
    """The pin scenario's loss with bf16 params: the batch meets the
    weights in their dtype."""
    x = batch["x"].to(params["w"].dtype)
    logp = torch.log_softmax((x @ params["w"] + params["b"]).float(), -1)
    return -logp.gather(-1, batch["y"].long()[:, None]).mean()


def _bf16_backend():
    return THostBackend(_bf16_loss, pin_user_data(), lr=0.05, batch_size=16,
                        seed=3, round_mode="fused", k_max=2,
                        objective=ObjectiveSpec(local="feddyn", alpha=0.1,
                                                aggregator="fedadam",
                                                server_lr=0.1),
                        device="cpu")


def test_bf16_objective_state_restores_dtype_bits_and_the_next_round():
    """A bf16 model's m / v / h leave as f32 (numpy has no bf16) and
    come back bf16 with the live bits, and the round after the restore
    equals the uninterrupted run's bit for bit."""
    ids = list(range(PIN_USERS))
    init = to_torch(pin_init(), "bfloat16")
    live = _bf16_backend()
    state = live.init_state(init)
    state = live.merge(state, live.train_round(state, 0, ids, True), [4, 1],
                       attempts=[4, 1])
    snap = live.objective_state()
    streams = live.client_stream_states()
    resumed = _bf16_backend()
    resumed.init_state(init)
    resumed.restore_objective_state(snap)
    resumed.restore_client_streams(streams)
    for part in ("_obj_m", "_obj_v", "_obj_h"):
        for a, b in zip(jax.tree.leaves(getattr(live, part)),
                        jax.tree.leaves(getattr(resumed, part))):
            assert a.dtype == b.dtype == torch.bfloat16
            assert np.array_equal(bits(a), bits(b))
    want = live.merge(state, live.train_round(state, 1, ids, True), [2, 6],
                      attempts=[2, 6, 0])
    got = resumed.merge(state, resumed.train_round(state, 1, ids, True),
                        [2, 6], attempts=[2, 6, 0])
    assert bitwise_equal(got, want)
    for part in ("_obj_m", "_obj_v", "_obj_h"):
        assert bitwise_equal(getattr(resumed, part), getattr(live, part))
        assert all(t.dtype == torch.bfloat16
                   for t in jax.tree.leaves(getattr(resumed, part)))
