"""Device CSMA contention of the port against the JAX package, on the CPU.

What must agree, and how tightly:
  * the event op, exactly — the port's plain ``contention_event_ref``
    against the JAX oracle and the Pallas passes in interpret mode, all
    six outputs and their dtypes (the state is integer and the redraw
    has one f32 rounding);
  * the event loop, exactly, when it is handed the reference's threefry
    draws — winners, finish slots, collisions, elapsed slots and
    deliveries of ``device_contend_batch`` on the five scenarios of
    ``tests/test_contention_device.py`` that reach the loop's corners
    (collisions, identical backoffs, the retry ladder, pool mode with a
    participation mask, the horizon cap);
  * with the port's own counter-based draws, the contracts the JAX tests
    pin for the reference: collision-free rounds equal numpy exactly,
    determinism per seed and call order, and distributional agreement
    with numpy (winner-rank TV < 0.08, the same invariants);
  * the counter draw itself, bit for bit, against a Python-int oracle of
    the same function (the persistent kernel computes it too, so the CPU
    and the card draw the same numbers), and the loop's default route
    (``ops.contention_loop``) against the hooked Python loop fed the same
    draws: every field, per-row events and pool attempts.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import given, settings, st
from repro.kernels import ref as jref
from repro.kernels.contention import contention_event_pallas
from repro.kernels.contention import device_contend_batch as jax_contend
from repro_torch.core.csma import CSMAConfig, CSMASimulator
from repro_torch.kernels import contention as tcont
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

SLOT_S = 20e-6
OUTPUTS = ("step", "nexp", "winner", "counters", "doublings", "active")
FIELDS = ("winners", "finish_slots", "collisions", "elapsed_slots",
          "n_delivered")


def _sim(seed, backend, **cfg):
    return CSMASimulator(CSMAConfig(**cfg), seed=seed, backend=backend,
                         device="cpu")


def _event_inputs(B, N, seed):
    """Random pool with a forced expiry tie in row 0, dead lanes, and
    (for B > 1) a last row with no live lane."""
    rng = np.random.default_rng(seed)
    counters = rng.integers(0, 50, (B, N)).astype(np.int32)
    live = rng.random((B, N)) > 0.3
    counters[0, :min(4, N)] = 5
    live[0, :min(4, N)] = True
    if B > 1:
        live[-1] = False
    dbl = rng.integers(0, 5, (B, N)).astype(np.int32)
    win = rng.uniform(1.0, 1e4, (B, N)).astype(np.float32)
    rand = rng.random((B, N)).astype(np.float32)
    return counters, live, dbl, win, rand


def _assert_event_equal(want, got):
    for name, w, g in zip(OUTPUTS, want, got):
        w, g = np.asarray(w), g.numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(w, g, err_msg=name)


# ------------------------------------------------------------- event op
SHAPES = [(3, 7), (2, 300), (4, 2049), (8, 1024)]
#: one compiled program per shape instead of one per primitive
_jax_oracle = jax.jit(jref.contention_event_ref, static_argnums=5)
_jax_pallas = jax.jit(
    lambda *a: contention_event_pallas(*a[:5], a[5], interpret=True),
    static_argnums=5)


@pytest.mark.parametrize("max_doublings", [5, 7])
@pytest.mark.parametrize("shape", SHAPES)
def test_event_op_equals_the_jax_oracle(shape, max_doublings):
    args = _event_inputs(*shape, seed=shape[0] * shape[1])
    want = _jax_oracle(*(jnp.asarray(a) for a in args), max_doublings)
    got = tref.contention_event_ref(*(torch.from_numpy(a) for a in args),
                                    max_doublings)
    _assert_event_equal(want, got)


@pytest.mark.parametrize("max_doublings", [5, 7])
@pytest.mark.parametrize("shape", SHAPES)
def test_event_op_equals_the_pallas_interpret_run(shape, max_doublings):
    args = _event_inputs(*shape, seed=shape[0] * shape[1] + 1)
    want = _jax_pallas(*(jnp.asarray(a) for a in args), max_doublings)
    got = ops.contention_event(*(torch.from_numpy(a) for a in args),
                               max_doublings)
    _assert_event_equal(want, got)


def test_event_op_edge_rows():
    """No live lane anywhere (step BIG, winner N), a lone live lane per
    row (delivery), and the redraw clamp at both ends."""
    B, N = 3, 9
    cnt = np.full((B, N), 7, np.int32)
    dead = np.zeros((B, N), bool)
    zeros = np.zeros((B, N), np.int32)
    ones = np.ones((B, N), np.float32)
    for live, rand, win in (
            (dead, ones, ones),
            (np.eye(B, N, dtype=bool), ones, ones),
            (np.ones((B, N), bool), np.zeros((B, N), np.float32), ones),
            (np.ones((B, N), bool), ones, np.full((B, N), 1e30, np.float32))):
        args = (cnt, live, zeros, win, rand)
        _assert_event_equal(
            _jax_oracle(*(jnp.asarray(a) for a in args), 5),
            tref.contention_event_ref(*(torch.from_numpy(a) for a in args),
                                      5))


def test_cpu_event_takes_the_plain_version_and_counts_no_launch():
    ops.reset_launches()
    args = [torch.from_numpy(a) for a in _event_inputs(4, 33, seed=2)]
    got = ops.contention_event(*args, 5)
    _assert_event_equal(tref.contention_event_ref(*args, 5), got)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    with pytest.raises(ValueError, match="max_doublings"):
        ops.contention_event(*args, 31)


def test_bindings_refuse_cpu_tensors():
    cnt, live, dbl, win, rand = (torch.from_numpy(a)
                                 for a in _event_inputs(2, 5, seed=0))
    step = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="must lie on"):
        tcont.contention_min_cuda(cnt, live)
    with pytest.raises(ValueError, match="must lie on"):
        tcont.contention_expiry_cuda(cnt, live, step)
    with pytest.raises(ValueError, match="must lie on"):
        tcont.contention_transition_cuda(cnt, live, dbl, win, rand, step,
                                         step, 5)


# --------------------------------------- the loop, given threefry draws
def _threefry_draw(entropy, call_index):
    """The reference's redraw material: ``uniform(fold_in(fold_in(
    PRNGKey(entropy), call_index), ev), (B, M))``."""
    key = jax.random.fold_in(
        jax.random.PRNGKey(int(entropy) & (2 ** 63 - 1)), int(call_index))

    def draw(ev, B, M):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, ev), (B, M), jnp.float32)))
    return draw


def _scenario(name):
    """(backoff slots, window slots, k, participating, config) of the
    reference's device-contention tests, in slot units."""
    if name == "collision":
        rng = np.random.default_rng(5)
        return (np.tile(rng.uniform(5, 20, 6), (3, 1)),
                np.full((3, 6), 500.0), 3, None, {})
    if name == "identical_backoffs":
        return (np.full((4, 5), 50.0), np.full((4, 5), 500.0), 5, None, {})
    if name == "retry_ladder":
        return (np.full((2, 2000), 0.001 / SLOT_S),
                np.full((2, 2000), 50.0 / SLOT_S), 3, None, {})
    if name == "pool_mask":
        rng = np.random.default_rng(3)
        backoffs = rng.uniform(0, 1, (8, 3000)) * 0.02 / SLOT_S
        part = rng.random((8, 3000)) > 0.4
        return backoffs, np.full(3000, 0.02 / SLOT_S), 5, part, {}
    cap = {"horizon_40": 40, "horizon_60": 60}[name]
    return (np.array([[3.0, 10.0]]), np.full(2, 1.0 / SLOT_S), 2, None,
            dict(max_sim_slots=cap))


@pytest.mark.parametrize("name", ["collision", "identical_backoffs",
                                  "retry_ladder", "pool_mask",
                                  "horizon_40", "horizon_60"])
def test_loop_given_threefry_draws_equals_the_jax_loop(name):
    backoffs, windows, k, part, cfg = _scenario(name)
    kw = dict(entropy=77 + len(name), call_index=3, tx_slots=50,
              max_backoff_doublings=5, max_sim_slots=2_000_000)
    kw.update(cfg)
    want = jax_contend(backoffs, windows, k, part, **kw)
    tcont.reset_loop_stats()
    got = tcont.device_contend_batch(
        backoffs, windows, k, part, device="cpu",
        draw=_threefry_draw(kw["entropy"], kw["call_index"]), **kw)
    for f in FIELDS:
        g = getattr(got, f)
        assert g.dtype == np.int64, f
        np.testing.assert_array_equal(getattr(want, f), g, err_msg=f)
    assert tcont.LOOP["calls"] == 1 and tcont.LOOP["events"] >= 1
    if name == "retry_ladder":
        assert tcont.LOOP["attempts"] > 1           # the ladder was climbed
        assert (got.collisions >= 1).all() and (got.n_delivered == k).all()
    if name in ("collision", "identical_backoffs"):
        assert (got.n_delivered == k).all()
    if name == "identical_backoffs":
        assert (got.collisions >= 1).all()


# ------------------------------------- port-side contracts, own draws
def test_counter_draw_is_a_function_of_entropy_call_and_event():
    a = tcont.counter_draw(9, 2, "cpu")
    b = tcont.counter_draw(9, 2, "cpu")
    assert torch.equal(a(5, 3, 7), b(5, 3, 7))
    assert not torch.equal(a(5, 3, 7), a(6, 3, 7))
    assert not torch.equal(a(5, 3, 7), tcont.counter_draw(9, 3, "cpu")(5, 3, 7))
    assert not torch.equal(a(5, 3, 7), tcont.counter_draw(8, 2, "cpu")(5, 3, 7))
    x = a(0, 64, 128)
    assert x.dtype == torch.float32 and (x >= 0).all() and (x < 1).all()


_M64 = (1 << 64) - 1


def _oracle_splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _oracle_uniform(entropy, call_index, ev, row, col):
    """The redraw of (row, pool column) in event ``ev``, in Python ints:
    top 24 bits of splitmix64(splitmix64(key ^ ev) ^ (row << 32 | col))
    over 2^24, key = splitmix64(splitmix64(entropy) ^ call_index)."""
    key = _oracle_splitmix64(_oracle_splitmix64(entropy & _M64)
                             ^ (call_index & _M64))
    kev = _oracle_splitmix64(key ^ (ev & _M64))
    x = _oracle_splitmix64(kev ^ ((row << 32) | col))
    return (x >> 40) / float(1 << 24), key >> 63, kev >> 63, x >> 63


@pytest.mark.parametrize("entropy,call_index,ev,row,col", [
    (0, 0, 0, 0, 0),
    (2 ** 63 - 1, 0, 0, 0, 1),
    (1234, 5, 17, 3, 127),
    (2 ** 62 + 7, 2 ** 40 + 3, 2 ** 31 - 1, 7, 65535),
    (987654321, 2 ** 64 - 1, 1000, 1, 2),
    (77, 3, 380, 0, 511),
])
def test_counter_draw_equals_the_python_int_oracle(entropy, call_index, ev,
                                                   row, col):
    got = tcont.counter_draw(entropy, call_index, "cpu")(ev, row + 1,
                                                         col + 1)
    want = _oracle_uniform(entropy, call_index, ev, row, col)[0]
    assert got.dtype == torch.float32
    assert float(got[row, col]) == want           # exact in f32


def test_counter_draw_whole_plane_equals_the_oracle_top_bits_included():
    entropy, call_index, ev, B, M = 2 ** 63 - 5, 11, 42, 4, 300
    got = tcont.counter_draw(entropy, call_index, "cpu")(ev, B, M).numpy()
    top = {"key": set(), "kev": set(), "x": set()}
    for b in range(B):
        for c in range(M):
            u, *bits = _oracle_uniform(entropy, call_index, ev, b, c)
            assert got[b, c] == u, (b, c)
            for name, bit in zip(top, bits):
                top[name].add(bit)
    assert top["x"] == {0, 1}          # products wrapped past the sign bit
    assert (got >= 0).all() and (got < 1).all()


def test_default_loop_equals_the_hooked_plain_loop():
    """On the CPU ``ops.contention_loop``'s route is the Python loop itself,
    so this holds the routing only: the default draws are the counter
    draws under the call's key, and LOOP's bookkeeping (per-row events of
    every attempt, attempts, events the most any row ran) matches the
    hooked loop's. A retry ladder with a k = 0 row covers both. The
    persistent kernel is held against the plain loop on the card."""
    backoffs, windows = np.full((3, 2000), 50.0), np.full(2000, 2.5e6)
    k = np.array([3, 0, 3])
    kw = dict(entropy=321, call_index=9, tx_slots=50,
              max_backoff_doublings=5, max_sim_slots=2_000_000)
    stats = []
    results = []
    for hooks in ({}, dict(draw=tcont.counter_draw(321, 9, "cpu"),
                           event_op=tref.contention_event_ref)):
        tcont.reset_loop_stats()
        results.append(tcont.device_contend_batch(
            backoffs, windows, k, None, device="cpu", **hooks, **kw))
        stats.append(dict(tcont.LOOP))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(results[0], f),
                                      getattr(results[1], f), err_msg=f)
    a, b = stats
    assert a["row_events"] == b["row_events"]
    assert a["attempts"] == b["attempts"] == len(a["row_events"]) > 1
    assert a["events"] == b["events"] == sum(
        max(r) for r in a["row_events"])
    got = results[0]
    assert got.n_delivered.tolist() == [3, 0, 3]
    assert all(r[1] == 0 for r in a["row_events"])
    assert got.elapsed_slots[1] == got.collisions[1] == 0
    assert (got.winners[1] == -1).all()
    for r in (0, 2):
        w = got.winners[r][got.winners[r] >= 0]
        assert len(set(w.tolist())) == 3


def test_cpu_contention_loop_counts_no_launch_and_binding_refuses_cpu():
    rng = np.random.default_rng(5)
    backoffs, windows, k, part = (rng.uniform(0, 1000, (8, 2000)),
                                  np.full(2000, 1000.0), 8, None)
    ops.reset_launches()
    tcont.device_contend_batch(backoffs, windows, k, part, device="cpu",
                               entropy=1, call_index=0, tx_slots=50,
                               max_backoff_doublings=5,
                               max_sim_slots=2_000_000)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    z = torch.zeros((2, 4), dtype=torch.int32)
    r = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="must lie on"):
        tcont.contention_loop_cuda(z, z.float(), z, r, r, k_max=1,
                                   tx_slots=50, max_doublings=5,
                                   max_sim_slots=100, key=0)
    with pytest.raises(ValueError, match="max_doublings"):
        ops.contention_loop(z, z.float(), z, r, r, k_max=1, tx_slots=50,
                            max_doublings=31, max_sim_slots=100, key=0)


def test_collision_free_rounds_match_numpy_exactly():
    rng = np.random.default_rng(0)
    B, n, k = 4, 8, 3
    backoffs = rng.uniform(1e-5, 5e-3, (B, n))
    windows = rng.uniform(1e-4, 5e-3, (B, n))
    part = rng.random((B, n)) > 0.3
    dev = _sim(1, "device").contend_batch(
        backoffs, windows, k_target=k, participating=part)
    host = _sim(1, "numpy").contend_batch(
        backoffs, windows, k_target=k, participating=part)
    assert host.collisions.sum() == 0     # the premise of exactness
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(dev, f), getattr(host, f))


def test_scalar_contend_routes_through_batch():
    s = _sim(2, "device")
    assert s.contend([0.01, 0.002, 0.03], [1.0] * 3, k_target=1).winners \
        == [1]
    res = s.contend([0.001, 0.002, 0.003], [1.0] * 3, k_target=2,
                    participating=[False, True, True])
    assert set(res.winners) == {1, 2}


def test_deterministic_per_seed_and_call_order():
    B, n = 6, 5
    backoffs = np.full((B, n), 0.001)
    windows = np.full((B, n), 0.01)
    a1 = _sim(9, "device").contend_batch(backoffs, windows, k_target=n)
    a2 = _sim(9, "device").contend_batch(backoffs, windows, k_target=n)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a1, f), getattr(a2, f))
    s = _sim(9, "device")
    first = s.contend_batch(backoffs, windows, k_target=n)
    second = s.contend_batch(backoffs, windows, k_target=n)
    assert (first.winners != second.winners).any()  # stream advanced
    assert s.state_dict()["device_calls"] == 2


def test_retry_ladder_is_deterministic_with_own_draws():
    backoffs = np.full((2, 2000), 0.001)
    windows = np.full((2, 2000), 50.0)
    tcont.reset_loop_stats()
    a = _sim(4, "device").contend_batch(backoffs, windows, k_target=3)
    assert tcont.LOOP["attempts"] > 1
    b = _sim(4, "device").contend_batch(backoffs, windows, k_target=3)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.n_delivered == 3).all() and (a.collisions >= 1).all()
    for b_ in range(2):
        assert len(set(a.winners[b_].tolist())) == 3


def test_pool_mode_invariants_large_n():
    rng = np.random.default_rng(3)
    B, n, k = 8, 3000, 5
    backoffs = rng.uniform(0, 1, (B, n)) * 0.02
    part = rng.random((B, n)) > 0.4
    res = _sim(3, "device").contend_batch(
        backoffs, np.full(n, 0.02), k_target=k, participating=part)
    for b in range(B):
        w = res.winners[b][res.winners[b] >= 0]
        assert len(w) == len(set(w.tolist())) == k
        assert part[b, w].all()
        assert (np.diff(res.finish_slots[b][:k]) > 0).all()


def test_rejects_numpy_stream_replay_and_unknown_backend():
    s = _sim(0, "device")
    with pytest.raises(ValueError, match="threefry"):
        s.contend_batch(np.ones((2, 3)), np.ones(3), 1, seeds=[1, 2])
    with pytest.raises(ValueError, match="threefry"):
        s.contend_batch(np.ones((2, 3)), np.ones(3), 1,
                        rngs=[np.random.default_rng(0)] * 2)
    with pytest.raises(ValueError, match="unknown contention backend"):
        CSMASimulator(seed=0, backend="cuda")


def test_tiny_cap_freezes_at_horizon_both_backends():
    backoffs = [SLOT_S * 3, SLOT_S * 10]
    for backend in ("numpy", "device"):
        res = _sim(0, backend, tx_slots=50, max_sim_slots=40).contend(
            backoffs, [1.0, 1.0], k_target=2)
        assert (res.winners, res.elapsed_slots) == ([], 40), backend
        res = _sim(0, backend, tx_slots=50, max_sim_slots=60).contend(
            backoffs, [1.0, 1.0], k_target=2)
        assert (res.winners, res.finish_slots, res.elapsed_slots) \
            == ([0], [53], 60), backend


def _histogram(winners, n):
    h = np.bincount(np.asarray(winners, np.int64), minlength=n)
    return h / max(h.sum(), 1)


def test_winner_rank_distribution_matches_numpy():
    n, rounds, B = 4, 600, 50
    prios = np.array([4.0, 2.0, 1.0, 0.5])
    windows = (64.0 / prios) * SLOT_S       # ~7 % of rounds collide
    hists, coll = {}, {}
    for backend in ("numpy", "device"):
        sim = _sim(11, backend)
        draw = np.random.default_rng(42)    # shared backoff material
        wins, c = [], 0
        for _ in range(rounds // B):
            res = sim.contend_batch(draw.uniform(0, 1, (B, n)) * windows,
                                    windows, k_target=1)
            wins.extend(int(w) for w in res.winners[:, 0] if w >= 0)
            c += int(res.collisions.sum())
        hists[backend], coll[backend] = _histogram(wins, n), c
    tv = 0.5 * np.abs(hists["numpy"] - hists["device"]).sum()
    assert tv < 0.08, (tv, hists)
    assert (np.argsort(hists["numpy"]) == np.argsort(hists["device"])).all()
    assert coll["device"] > 0
    hi = max(coll.values())
    assert abs(coll["numpy"] - coll["device"]) / hi < 0.35, coll


def test_small_n_exhaustive_seed_agreement():
    n, seeds = 3, 120
    backoffs, windows = np.full(n, 0.001), np.full(n, 0.01)
    first = {"numpy": [], "device": []}
    colls = {"numpy": [], "device": []}
    for backend in first:
        for s in range(seeds):
            res = _sim(s, backend).contend(backoffs, windows, k_target=n)
            assert sorted(res.winners) == list(range(n)), (backend, s)
            first[backend].append(res.winners[0])
            colls[backend].append(res.collisions)
    for backend in first:
        assert _histogram(first[backend], n).min() > 0.15, backend
    tv = 0.5 * np.abs(_histogram(first["numpy"], n)
                      - _histogram(first["device"], n)).sum()
    assert tv < 0.15, tv
    m_np, m_dev = np.mean(colls["numpy"]), np.mean(colls["device"])
    assert abs(m_np - m_dev) / max(m_np, m_dev) < 0.35, (m_np, m_dev)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(2, 30), k=st.integers(1, 5),
       seed=st.integers(0, 2 ** 30))
def test_numpy_and_device_agree_on_invariants(n, k, seed):
    rng = np.random.default_rng(seed)
    backoffs = rng.uniform(1e-5, 5e-3, n)
    windows = rng.uniform(1e-4, 5e-3, n)
    part = rng.random(n) > 0.3
    if not part.any():
        part[0] = True
    res = {}
    for backend in ("numpy", "device"):
        r = _sim(seed, backend).contend(backoffs, windows, k_target=k,
                                        participating=part)
        assert len(r.winners) == len(set(r.winners))
        assert all(part[w] for w in r.winners)
        assert all(b > a for a, b in zip(r.finish_slots, r.finish_slots[1:]))
        assert (r.finish_slots[-1] <= r.elapsed_slots
                if r.winners else r.elapsed_slots >= 0)
        res[backend] = r
    assert len(res["numpy"].winners) == len(res["device"].winners) \
        == min(k, int(part.sum()))


# ------------------------------------------------------ the whole slice
def test_select_batch_routes_device_lanes_through_one_loop():
    from repro_torch.engine import SelectionContext, create_strategy
    E, n = 4, 12
    strats = [create_strategy("priority-distributed", seed=30 + e,
                              contention_backend="device")
              for e in range(E)]
    for s in strats:
        s._sim.device = "cpu"
    prng = np.random.default_rng(8)
    ctxs = []
    for e in range(E):
        part = np.ones(n, bool)
        part[prng.integers(0, n)] = False
        ctxs.append(SelectionContext(
            priorities=1.0 + prng.random(n), participating=part,
            k_target=2, rng=np.random.default_rng(100 + e), cw_base=1024.0))
    tcont.reset_loop_stats()
    out = type(strats[0]).select_batch(strats, ctxs)
    assert tcont.LOOP["calls"] == 1
    for e, sel in enumerate(out):
        assert len(sel.winners) == 2
        assert all(ctxs[e].participating[u] for u in sel.winners)
        assert sel.elapsed_slots > 0


def _linear_engine(**spec_kw):
    from repro_torch.engine import ExperimentSpec, build_host_engine
    rng = np.random.default_rng(7)
    user_data = []
    for u in range(8):
        probs = np.ones(4) / 4
        probs[u % 4] += 1.0
        user_data.append({
            "x": rng.normal(size=(64, 16)).astype(np.float32),
            "y": rng.choice(4, 64, p=probs / probs.sum())})

    def loss_fn(params, batch):
        logp = torch.log_softmax(batch["x"] @ params["w"] + params["b"], -1)
        return -logp.gather(-1, batch["y"].long()[:, None]).mean()

    params = {"w": torch.zeros(16, 4), "b": torch.zeros(4)}
    spec = ExperimentSpec(rounds=4, strategy="priority-distributed",
                          seed=3, contention_backend="device", **spec_kw)
    return build_host_engine(spec, params, loss_fn, user_data, device="cpu")


def test_engine_runs_device_contention_on_the_backend_device():
    engine = _linear_engine()
    assert engine.strategy._sim.device == torch.device("cpu")
    tcont.reset_loop_stats()
    hist = engine.run()
    assert tcont.LOOP["calls"] == 4               # one loop per round
    assert hist.uploads_total > 0 and hist.contention_slots > 0
    assert all(len(w) <= engine.spec.k_per_round for w in hist.winners)
    again = _linear_engine().run()
    assert again.winners == hist.winners
    assert again.contention_slots == hist.contention_slots


def test_launch_train_runs_device_contention_on_the_cpu(capsys):
    from repro_torch.launch import train
    tcont.reset_loop_stats()
    train.main(["--device", "cpu", "--contention-backend", "device",
                "--rounds", "2", "--n-train", "400", "--n-test", "100",
                "--users", "4", "--batch-size", "16"])
    summary = json.loads(capsys.readouterr().out)
    assert summary["device"] == "cpu" and summary["uploads_total"] >= 1
    assert tcont.LOOP["calls"] == 2
