"""The fault layer of the port against the JAX package, on the CPU.

  (a) the robust combine op: the port's wrapper (its plain version on a
      CPU tensor) against ``repro.kernels.ref`` and the Pallas kernel in
      interpret mode — f32 ``rtol=1e-5, atol=1e-6``, bf16 ``atol=0.02``
      (one ulp of the output type), the bars of ``tests/test_kernels.py``
      — and its exactness contracts bitwise;
  (b) ``robust_merge`` against the reference's (quarantine, clip,
      corruption, stale group, all-quarantined); ``fault_alphas`` and the
      ``FaultInjector`` copy exactly;
  (c) the engine end to end on the pin scenario of
      ``tools/check_winner_pins.py`` (8 users, 16 -> 4 linear model, 4
      rounds, seeds 0 and 1) with the active fault spec of
      ``benchmarks/faults_bench.py`` against the JAX engine's ``run()``:
      every count of the history exactly, globals ``rtol=1e-5``;
  (d) the bit-transparency contracts within the port.
"""
import numpy as np
import pytest
import torch

from repro.channel import ChannelSpec as JChannelSpec
from repro.faults import FaultInjector as JFaultInjector
from repro.faults import FaultSpec as JFaultSpec
from repro.faults import fault_alphas as j_fault_alphas
from repro.faults import robust_merge as j_robust_merge
from repro.kernels import ops as jops, ref as jref
from repro_torch.channel import ChannelSpec
from repro_torch.faults import FaultInjector, FaultSpec, fault_alphas
from repro_torch.faults import robust_merge
from repro_torch.kernels import ops as tops

from torch_port_util import (LOSSY, SEEDS, arr_j, arr_t, assert_runs_agree,
                             bits, bitwise_equal, f32, run_pair, run_port,
                             to_jax, to_torch)

SHAPES = [(127,), (2, 129, 5), (784, 200)]
DTYPES = ["float32", "bfloat16"]


def _atol(dtype):
    return 1e-6 if dtype == "float32" else 0.02


def _case(seed, k, shape):
    """(stack, weights with a zero, scales with 1.0 / 0.5 / a NaN on the
    zero-weight row, old global)."""
    rng = np.random.default_rng(seed)
    st = rng.standard_normal((k,) + shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    w = rng.uniform(0.1, 1.0, k)
    w = (w / w.sum()).astype(np.float32)
    s = rng.uniform(0.1, 1.0, k).astype(np.float32)
    s[0] = 1.0
    if k > 1:
        s[1] = 0.5
    if k > 2:
        w[2], s[2] = 0.0, np.nan
    return st, w, s, g


# ------------------------------------------------- (a) the combine op
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 2, 5])
def test_robust_matches_jax_ref(shape, dtype, k):
    st, w, s, g = _case(k, k, shape)
    out = tops.robust_combine(arr_t(st, dtype), w, s, arr_t(g, dtype))
    want = jref.robust_combine_ref(arr_j(st, dtype), w, s, arr_j(g, dtype))
    assert out.shape == shape and str(out.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(f32(out), f32(want), rtol=1e-5,
                               atol=_atol(dtype))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_robust_matches_pallas_interpret(shape, dtype):
    st, w, s, g = _case(4, 5, shape)
    out = tops.robust_combine(arr_t(st, dtype), w, s, arr_t(g, dtype))
    want = jops.robust_combine(arr_j(st, dtype), w, s, arr_j(g, dtype),
                               interpret=True)
    np.testing.assert_allclose(f32(out), f32(want), rtol=1e-5,
                               atol=_atol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_robust_zero_weight_masks_nonfinite_row(dtype, bad):
    """Row 2 has weight 0 and a NaN scale: poisoning the row too changes
    no bit."""
    st, w, s, g = _case(5, 5, (2, 129, 5))
    clean = tops.robust_combine(arr_t(st, dtype), w, s, arr_t(g, dtype))
    poisoned = st.copy()
    poisoned[2] = bad
    out = tops.robust_combine(arr_t(poisoned, dtype), w, s, arr_t(g, dtype))
    assert np.isfinite(f32(out)).all()
    assert np.array_equal(bits(out), bits(clean))


@pytest.mark.parametrize("dtype", DTYPES)
def test_robust_unit_scales_is_gather_combine_bitwise(dtype):
    st, w, _, g = _case(6, 5, (2, 129, 5))
    ones = np.ones(5, np.float32)
    out = tops.robust_combine(arr_t(st, dtype), w, ones, arr_t(g, dtype))
    plain = tops.gather_combine(arr_t(st, dtype), np.arange(5, dtype=np.int32),
                                w, arr_t(g, dtype))
    assert np.array_equal(bits(out), bits(plain))


#: the shapes where the kernel's 16-byte vector path splits from its
#: scalar path (n % 4 != 0, n < 4; n % 8 != 0 for bf16) and the row counts
#: around its unroll of 8 (K = 1, 9 and 65)
SPLIT_SHAPES = [(3,), (10,), (2, 7), (4, 130)]


def _split_case(k, shape, seed):
    """``_case`` and its stack with a NaN row at zero weight inside the
    second unrolled group of eight rows (row 13; row 5 when k < 9)."""
    st, w, s, g = _case(seed, k, shape)
    poisoned = st.copy()
    if k > 1:
        z = min(k - 1, 5 if k < 9 else 13)
        w[z], s[z] = 0.0, 2.0
        poisoned[z] = np.nan
    return st, poisoned, w, s, g


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 9, 65])
def test_robust_vector_split_shapes_match_jax_ref(shape, dtype, k):
    st, poisoned, w, s, g = _split_case(k, shape, seed=k + len(shape))
    out = tops.robust_combine(arr_t(poisoned, dtype), w, s, arr_t(g, dtype))
    clean = tops.robust_combine(arr_t(st, dtype), w, s, arr_t(g, dtype))
    want = jref.robust_combine_ref(arr_j(st, dtype), w, s, arr_j(g, dtype))
    assert np.array_equal(bits(out), bits(clean))
    np.testing.assert_allclose(f32(out), f32(want), rtol=1e-5,
                               atol=_atol(dtype))


@pytest.mark.parametrize("shape", [(3,), (4, 130)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [9, 65])
def test_robust_vector_split_shapes_match_pallas_interpret(shape, dtype, k):
    _, poisoned, w, s, g = _split_case(k, shape, seed=2 * k + len(shape))
    out = tops.robust_combine(arr_t(poisoned, dtype), w, s, arr_t(g, dtype))
    want = jops.robust_combine(arr_j(poisoned, dtype), w, s,
                               arr_j(g, dtype), interpret=True)
    assert np.isfinite(f32(out)).all()
    np.testing.assert_allclose(f32(out), f32(want), rtol=1e-5,
                               atol=_atol(dtype))


def test_robust_nan_row_with_weight_propagates():
    st, w, s, g = _case(7, 3, (64,))
    st[0, 5] = np.nan                      # w[0] > 0, s[0] == 1
    out = f32(tops.robust_combine(arr_t(st), w, s, arr_t(g)))
    assert np.isnan(out[5]) and np.isfinite(np.delete(out, 5)).all()


# --------------------------------------------- (b) the merge and the host
def _merge_case(seed, k=4, m=2):
    rng = np.random.default_rng(seed)
    glob = {"w": rng.standard_normal((6, 3)).astype(np.float32),
            "b": np.float32(rng.standard_normal())}
    fresh = {"w": rng.standard_normal((k, 6, 3)).astype(np.float32),
             "b": rng.standard_normal(k).astype(np.float32)}
    stale = {"w": rng.standard_normal((m, 6, 3)).astype(np.float32),
             "b": rng.standard_normal(m).astype(np.float32)}
    w, sw = j_fault_alphas(k, [0, 2, 3], [10, 30, 20], [15, 25][:m], 0.5)
    return glob, fresh, stale, w, sw


MERGE_CASES = {
    "clean": dict(),
    "clip": dict(clip_norm=1.0),
    "scale_corrupt": dict(corrupt={2: 1e3}, clip_norm=2.0),
    "nan_corrupt": dict(corrupt={0: float("nan")}),
    "inf_no_quarantine": dict(corrupt={0: float("inf")}, quarantine=False),
    "stale": dict(stale=True),
    "stale_only": dict(stale=True, fresh=False),
    "all_quarantined": dict(corrupt={0: float("nan"), 2: float("nan"),
                                     3: float("inf")}),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_robust_merge_matches_jax(case):
    kw = dict(MERGE_CASES[case])
    glob, fresh, stale, w, sw = _merge_case(3)
    corrupt = np.ones(4, np.float32)
    for u, fac in kw.pop("corrupt", {}).items():
        corrupt[u] = fac
    use_stale = kw.pop("stale", False)
    use_fresh = kw.pop("fresh", True)
    if not use_stale:
        w, sw = j_fault_alphas(4, [0, 2, 3], [10, 30, 20], [], 0.5)
    args_j = (to_jax(fresh) if use_fresh else None, w, corrupt,
              to_jax(glob), to_jax(stale) if use_stale else None,
              sw if use_stale else None)
    args_t = (to_torch(fresh) if use_fresh else None, w, corrupt,
              to_torch(glob), to_torch(stale) if use_stale else None,
              sw if use_stale else None)
    want, nq_j = j_robust_merge(*args_j, use_kernel=False, **kw)
    got, nq_t = robust_merge(*args_t, **kw)
    assert int(nq_t) == int(nq_j)
    for name in ("b", "w"):
        np.testing.assert_allclose(f32(got[name]), f32(want[name]),
                                   rtol=1e-5, atol=1e-6)
    if case == "all_quarantined":
        assert int(nq_t) == 3
        np.testing.assert_array_equal(f32(got["w"]), glob["w"])
    if case == "inf_no_quarantine":
        assert not np.isfinite(f32(got["w"])).all()


def test_robust_merge_clean_is_gather_combine_bitwise():
    glob, fresh, _, w, _ = _merge_case(4)
    w, _ = fault_alphas(4, [0, 2, 3], [10, 30, 20], [], 0.5)
    got, nq = robust_merge(to_torch(fresh), w, np.ones(4, np.float32),
                           to_torch(glob))
    assert int(nq) == 0
    t_glob, t_fresh = to_torch(glob), to_torch(fresh)
    for name in ("b", "w"):
        plain = tops.gather_combine(t_fresh[name],
                                    np.arange(4, dtype=np.int32), w,
                                    t_glob[name])
        assert np.array_equal(bits(got[name]), bits(plain))
        assert got[name].data_ptr() != t_glob[name].data_ptr()


@pytest.mark.parametrize("stale_sizes,lam", [([], 0.5), ([12, 40], 0.5),
                                             ([12], 0.0)])
def test_fault_alphas_equal_the_reference(stale_sizes, lam):
    for merged, sizes in (([4, 1], [30, 10]), ([], [])):
        a = fault_alphas(6, merged, sizes, stale_sizes, lam)
        b = j_fault_alphas(6, merged, sizes, stale_sizes, lam)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("mode", ["nan", "scale"])
def test_fault_injector_equals_the_reference_exactly(mode):
    spec_kw = dict(crash_prob=0.2, straggle_prob=0.3, corrupt_prob=0.3,
                   corrupt_mode=mode, outage_prob=0.2, max_retries=2)
    ji = JFaultInjector(JFaultSpec(**spec_kw), 5, cw_base=64.0, tx_slots=3)
    ti = FaultInjector(FaultSpec(**spec_kw), 5, cw_base=64.0, tx_slots=3)
    rng = np.random.default_rng(0)
    for t in range(12):
        ji.begin_round()
        ti.begin_round()
        assert ti.in_outage == ji.in_outage
        winners = [int(u) for u in rng.choice(10, 4, replace=False)]
        delivered = [u for u in winners if rng.random() > 0.3]
        per = rng.uniform(0.0, 0.6, 10)
        a = ti.process_uploads(winners, delivered, per)
        b = ji.process_uploads(winners, delivered, per)
        assert a.__dict__.keys() == b.__dict__.keys()
        for key in a.__dict__:
            va, vb = getattr(a, key), getattr(b, key)
            if key == "corrupt":
                assert va.keys() == vb.keys()
                assert all(np.array_equal(va[u], vb[u], equal_nan=True)
                           for u in va)
            else:
                assert va == vb, key
    ti.push_stale(3, {"w": torch.ones(2)}, 16)
    st = ti.state_dict()
    assert isinstance(st["stale"][0][1]["w"], np.ndarray)
    ti.load_state_dict(st)
    assert ti.pop_stale()[0][0] == 3


# ------------------------------------------------- (c) engine end to end
#: ``benchmarks/faults_bench.py``'s active spec
ACTIVE = dict(crash_prob=0.1, straggle_prob=0.2, corrupt_prob=0.1,
              outage_prob=0.1, max_retries=2, clip_norm=2.0)


def _faults(**kw):
    return (JFaultSpec(**kw), FaultSpec(**kw))


@pytest.mark.parametrize("mode", ["nan", "scale"])
@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_faulty_run_matches_jax_engine(mode, lossy, seed):
    kw = dict(seed=seed, faults=_faults(corrupt_mode=mode, **ACTIVE))
    if lossy:
        kw["channel"] = (JChannelSpec(**LOSSY), ChannelSpec(**LOSSY))
    want, got, je, te = run_pair(kw)
    assert_runs_agree(want, got, je, te)
    assert got.stale_merges + got.dropped_clients + got.retries > 0


def test_stale_only_rounds_match_jax_engine():
    """straggle_prob = 1: every arrival merges one round late, so every
    merge after round 0 has no fresh group, only a stale one."""
    want, got, je, te = run_pair(dict(seed=0, faults=_faults(
        straggle_prob=1.0, staleness_discount=0.5)))
    assert_runs_agree(want, got, je, te)
    assert got.stale_merges == sum(len(d) for d in got.delivered[:-1])


# ----------------------------------------- (d) contracts within the port
@pytest.mark.parametrize("channel", [None, ChannelSpec(**LOSSY)])
def test_inert_faultspec_is_bit_transparent(channel):
    h0, e0 = run_port(channel=channel)
    h1, e1 = run_port(channel=channel, faults=FaultSpec())
    assert h1.winners == h0.winners and h1.delivered == h0.delivered
    assert h1.round_seconds == h0.round_seconds
    assert h1.upload_failures == h0.upload_failures
    assert bitwise_equal(e0.global_params, e1.global_params)
    assert (h1.retries, h1.dropped_clients, h1.quarantined_updates,
            h1.stale_merges) == (0, 0, 0, 0)


@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_quarantine_blocks_poison(mode):
    h, eng = run_port(faults=FaultSpec(corrupt_prob=1.0, corrupt_mode=mode))
    assert h.quarantined_updates == h.uploads_total > 0
    # the global never moves from the zero init
    assert all(torch.equal(v, torch.zeros_like(v))
               for v in eng.global_params.values())


def test_no_quarantine_lets_poison_through():
    _, eng = run_port(faults=FaultSpec(corrupt_prob=1.0, corrupt_mode="nan",
                                        quarantine=False))
    assert not all(torch.isfinite(v).all()
                   for v in eng.global_params.values())
