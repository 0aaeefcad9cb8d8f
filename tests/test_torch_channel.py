"""The channel layer of the port against the JAX package, on the CPU.

  (a) the AirComp merge op: the port's wrapper (its plain version on a
      CPU tensor) against ``repro.kernels.ref`` through the reference
      wrapper's weight / scale algebra, and against the Pallas kernel in
      interpret mode — f32 ``rtol=1e-5, atol=1e-6``, bf16 ``atol=0.02``
      (one ulp of the output type), the bars of ``tests/test_kernels.py``;
  (b) ``ChannelModel`` (a numpy copy): SNR, PER, gate, AirComp
      coefficients and airtime equal the reference's exactly, over
      fading rounds;
  (c) the engine end to end on the pin scenario of
      ``tools/check_winner_pins.py`` (8 users, 16 -> 4 linear model, 4
      rounds, seeds 0 and 1) against the JAX engine's ``run()``: every
      count of the history exactly, globals ``rtol=1e-5``. AirComp noise
      is a counter-based Box-Muller draw in the port and threefry in the
      reference; with the reference's noise planes handed in through the
      backend's draw hook the two runs must agree;
  (d) the bit-transparency contracts within the port, and the noise
      draw itself: its uniforms bit for bit against a Python-int oracle,
      its planes distinct across keys, rounds and leaves, and its
      moments and normality over 1e6 draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channel import ChannelModel as JChannelModel
from repro.channel import ChannelSpec as JChannelSpec
from repro.kernels import ops as jops
from repro_torch.channel import ChannelModel, ChannelSpec
from repro_torch.kernels import ops as tops, ref as tref

from torch_port_util import (LOSSY, SEEDS, arr_j, arr_t, assert_runs_agree,
                             bits, bitwise_equal, f32, run_pair, run_port,
                             threefry_noise)

SHAPES = [(127,), (2, 129, 5), (784, 200)]
DTYPES = ["float32", "bfloat16"]
KS = [1, 2, 5]


def _atol(dtype):
    return 1e-6 if dtype == "float32" else 0.02


def _case(seed, k, shape):
    """(stack, alphas with a zero, coeffs below 1, noise plane)."""
    rng = np.random.default_rng(seed)
    st = rng.standard_normal((k,) + shape).astype(np.float32)
    a = rng.uniform(0.1, 1.0, k)
    a = (a / a.sum()).astype(np.float32)
    if k > 2:
        a[1] = 0.0
    c = rng.uniform(0.3, 1.0, k).astype(np.float32)
    c[0] = 1.0
    noise = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return st, a, c, noise


# ----------------------------------------------------- (a) the merge op
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("power_control", [True, False])
def test_aircomp_matches_jax_ref(shape, dtype, k, power_control):
    st, a, c, noise = _case(k, k, shape)
    coeffs = c if power_control else None
    out = tops.aircomp_combine(arr_t(st, dtype), a, coeffs, arr_t(noise))
    want = jops.aircomp_combine(arr_j(st, dtype), a, coeffs,
                                jnp.asarray(noise), use_kernel=False)
    assert out.shape == shape and str(out.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(f32(out), f32(want), rtol=1e-5,
                               atol=_atol(dtype))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_aircomp_matches_pallas_interpret(shape, dtype):
    st, a, c, noise = _case(3, 2, shape)
    out = tops.aircomp_combine(arr_t(st, dtype), a, c, arr_t(noise))
    want = jops.aircomp_combine(arr_j(st, dtype), a, c, jnp.asarray(noise),
                                interpret=True)
    np.testing.assert_allclose(f32(out), f32(want), rtol=1e-5,
                               atol=_atol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_aircomp_zero_weight_masks_nonfinite_row(dtype, bad):
    st, a, c, noise = _case(5, 5, (2, 129, 5))
    clean = tops.aircomp_combine(arr_t(st, dtype), a, c, arr_t(noise))
    poisoned = st.copy()
    poisoned[1] = bad                      # a[1] == 0
    out = tops.aircomp_combine(arr_t(poisoned, dtype), a, c, arr_t(noise))
    assert np.array_equal(bits(out), bits(clean))


@pytest.mark.parametrize("dtype", DTYPES)
def test_aircomp_unit_coeffs_no_noise_is_gather_combine_bitwise(dtype):
    """The reference's recovery contract: coefficients 1 and no noise
    give scale = sum(a) / sum(a) = 1.0 exactly and the plain merge's
    bits — through the idx gather out of a (S, ...) stack too."""
    rng = np.random.default_rng(6)
    S, shape = 6, (2, 129, 5)
    st = arr_t(rng.standard_normal((S,) + shape).astype(np.float32), dtype)
    idx = np.array([4, 1, 3, 0], np.int32)
    w = np.array([0.5, 0.3, 0.2, 0.0], np.float32)
    glob = arr_t(rng.standard_normal(shape).astype(np.float32), dtype)
    plain = tops.gather_combine(st, idx, w, glob)
    for coeffs in (None, np.ones(4, np.float32)):
        for noise in (None, 0.0):
            air = tops.aircomp_combine(st, w, coeffs, noise, idx=idx)
            assert np.array_equal(bits(air), bits(plain))
    _, scale = tops.aircomp_weights(w, np.ones(4, np.float32), "cpu")
    assert float(scale) == 1.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("power_control", [True, False])
def test_aircomp_weighted_entry_matches_jax_ref(dtype, power_control):
    """The entry the fused merge calls once per leaf, with ``(w, scale)``
    formed once a merge: the same bits as the alpha-form wrapper, and
    the JAX reference's values."""
    st, a, c, noise = _case(11, 5, (2, 129, 5))
    coeffs = c if power_control else None
    w, scale = tops.aircomp_weights(a, coeffs, "cpu")
    idx = np.array([4, 2, 0, 1, 3], np.int32)
    got = tops.aircomp_combine_weighted(arr_t(st, dtype), w, scale,
                                        arr_t(noise), idx=idx)
    alpha_form = tops.aircomp_combine(arr_t(st, dtype), a, coeffs,
                                      arr_t(noise), idx=idx)
    assert np.array_equal(bits(got), bits(alpha_form))
    want = jops.aircomp_combine(arr_j(st[idx], dtype), a, coeffs,
                                jnp.asarray(noise), use_kernel=False)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5,
                               atol=_atol(dtype))


def test_aircomp_idx_reads_the_rows_of_a_longer_stack():
    st, a, c, noise = _case(8, 3, (127,))
    big = np.concatenate([np.full((2, 127), np.nan, np.float32), st])
    compact = tops.aircomp_combine(arr_t(st), a, c, arr_t(noise))
    via_idx = tops.aircomp_combine(arr_t(big), a, c, arr_t(noise),
                                   idx=np.array([2, 3, 4], np.int32))
    assert np.array_equal(bits(compact), bits(via_idx))
    with pytest.raises(IndexError):
        tops.aircomp_combine(arr_t(st), a, c, idx=np.array([0, 1, 3]))


def test_aircomp_scale_restores_mass():
    """Attenuated coefficients are rescaled by sum(a) / sum(a * c): the
    merge of identical rows is the row itself."""
    row = np.random.default_rng(9).standard_normal(50).astype(np.float32)
    st = np.stack([row, row, row])
    a = np.array([0.2, 0.3, 0.5], np.float32)
    c = np.array([1.0, 0.4, 0.7], np.float32)
    out = tops.aircomp_combine(arr_t(st), a, c)
    np.testing.assert_allclose(f32(out), row, rtol=1e-5, atol=1e-6)
    w, scale = tops.aircomp_weights(a, np.zeros(3, np.float32), "cpu")
    assert float(scale) == 1.0 and not w.any()     # sum(w) == 0 guard


# -------------------------------------------------- (b) the channel model
@pytest.mark.parametrize("fading", ["none", "rayleigh"])
@pytest.mark.parametrize("kw", [dict(), dict(per_snr_threshold_db=20.0,
                                             aircomp_gain_floor=0.3,
                                             aircomp_sigma=0.05),
                                dict(per_model="off", shadowing_sigma_db=0.0)])
def test_channel_model_equals_the_reference_exactly(fading, kw):
    U, seed = 10, 3
    jm = JChannelModel(JChannelSpec(fading=fading, **kw), U, seed)
    tm = ChannelModel(ChannelSpec(fading=fading, **kw), U, seed)
    assert tm.noise_entropy == jm.noise_entropy
    np.testing.assert_array_equal(tm.path_loss_db, jm.path_loss_db)
    attempts = [7, 2, 9, 0, 4]
    for _ in range(5):
        jm.begin_round()
        tm.begin_round()
        for name in ("snr_db", "per", "upload_seconds"):
            np.testing.assert_array_equal(getattr(tm, name),
                                          getattr(jm, name))
        assert tm.gate(attempts) == jm.gate(attempts)
        (tc, ts), (jc, js) = tm.aircomp_coeffs(), jm.aircomp_coeffs()
        np.testing.assert_array_equal(tc, jc)
        assert ts == js and tc.dtype == np.float32
        assert tm.round_airtime_s(attempts) == jm.round_airtime_s(attempts)
        assert tm.round_energy_j(attempts) == jm.round_energy_j(attempts)


# ------------------------------------------------- (c) engine end to end
def _channel(**kw):
    return (JChannelSpec(**kw), ChannelSpec(**kw))


@pytest.mark.parametrize("strategy", ["priority-distributed",
                                      "channel-distributed"])
@pytest.mark.parametrize("seed", SEEDS)
def test_gated_run_matches_jax_engine(strategy, seed):
    want, got, je, te = run_pair(dict(strategy=strategy, seed=seed,
                                      channel=_channel(**LOSSY)))
    assert_runs_agree(want, got, je, te)
    assert got.upload_failures > 0
    assert got.delivered != got.winners
    assert all(e > 0 for e in got.round_energy_j)


@pytest.mark.parametrize("seed", SEEDS)
def test_aircomp_noiseless_run_matches_jax_engine(seed):
    want, got, je, te = run_pair(dict(
        seed=seed, merge_backend="aircomp",
        channel=_channel(fading="rayleigh", aircomp_gain_floor=0.3)))
    assert_runs_agree(want, got, je, te)


@pytest.mark.parametrize("seed", SEEDS)
def test_aircomp_noisy_run_matches_jax_given_its_noise(seed):
    want, got, je, te = run_pair(dict(
        seed=seed, merge_backend="aircomp",
        channel=_channel(fading="rayleigh", aircomp_sigma=0.05,
                         aircomp_gain_floor=0.3)), noise_draw=threefry_noise)
    assert_runs_agree(want, got, je, te)


# ----------------------------------------- (d) contracts within the port
def test_channel_off_is_bit_identical_to_no_channel():
    h0, e0 = run_port()
    h1, e1 = run_port(channel=ChannelSpec(per_model="off"))
    assert h1.winners == h0.winners and h1.delivered == h0.delivered
    assert h1.upload_failures == 0
    assert bitwise_equal(e0.global_params, e1.global_params)
    # the channel still meters airtime even when it drops nothing
    assert all(s > r for s, r in zip(h1.round_seconds, h0.round_seconds))


def test_aircomp_without_noise_is_bit_identical_to_fedavg():
    h0, e0 = run_port()
    h1, e1 = run_port(merge_backend="aircomp")
    assert h1.winners == h0.winners
    assert bitwise_equal(e0.global_params, e1.global_params)


def test_noisy_aircomp_is_reproducible_and_noisy():
    spec = dict(merge_backend="aircomp",
                channel=ChannelSpec(per_model="off", aircomp_sigma=0.05))
    _, ea = run_port(**spec)
    _, eb = run_port(**spec)
    assert bitwise_equal(ea.global_params, eb.global_params)
    _, e0 = run_port()
    assert not bitwise_equal(ea.global_params, e0.global_params)


def test_noise_planes_differ_by_leaf_and_round():
    from repro_torch.engine.backends import aircomp_noise
    a = aircomp_noise((5, 0), 0, (64,), "cpu")
    assert torch.equal(a, aircomp_noise((5, 0), 0, (64,), "cpu"))
    for key, leaf in (((5, 1), 0), ((5, 0), 1), ((6, 0), 0)):
        assert not torch.equal(a, aircomp_noise(key, leaf, (64,), "cpu"))
    assert abs(float(aircomp_noise((1, 2), 3, (20000,), "cpu").std())
               - 1.0) < 0.05


def test_plain_version_is_what_the_cpu_wrapper_runs():
    st, a, c, noise = _case(11, 4, (33,))
    w, scale = tops.aircomp_weights(a, c, "cpu")
    want = tref.aircomp_combine_ref(arr_t(st), w, arr_t(noise), scale[0])
    got = tops.aircomp_combine(arr_t(st), a, c, arr_t(noise))
    assert torch.equal(got, want)


_M64 = (1 << 64) - 1


def _oracle_splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _oracle_noise_uniforms(entropy, t, leaf, e):
    """The two uniforms behind noise element ``e`` in Python ints: the
    top 53 bits of splitmix64(splitmix64(key ^ leaf) ^ (b << 32 | e)),
    plus one, over 2^53 (b = 0, 1), key = splitmix64(splitmix64(entropy)
    ^ t)."""
    key = _oracle_splitmix64(_oracle_splitmix64(entropy & _M64) ^ (t & _M64))
    kev = _oracle_splitmix64(key ^ (leaf & _M64))
    return [((_oracle_splitmix64(kev ^ ((b << 32) | e)) >> 11) + 1)
            / float(1 << 53) for b in (0, 1)]


@pytest.mark.parametrize("entropy,t,leaf,e", [
    (0, 0, 0, 0), (2 ** 63 - 1, 0, 1, 5), (1234, 17, 3, 127),
    (2 ** 62 + 7, 2 ** 40 + 3, 0, 65535), (987654321, 99, 5, 156799)])
def test_noise_uniforms_equal_the_python_int_oracle(entropy, t, leaf, e):
    import math
    from repro_torch.engine.backends import aircomp_noise
    from repro_torch.kernels.contention import counter_key, counter_uniform53
    u = counter_uniform53(counter_key(entropy, t), leaf, 2, e + 1, "cpu")
    want = _oracle_noise_uniforms(entropy, t, leaf, e)
    assert u.dtype == torch.float64
    assert [float(u[0, e]), float(u[1, e])] == want      # exact in f64
    assert all(0.0 < x <= 1.0 for x in want)
    z = float(aircomp_noise((entropy, t), leaf, (e + 1,), "cpu")[e])
    zw = math.sqrt(-2.0 * math.log(want[0])) * math.cos(2 * math.pi * want[1])
    assert abs(z - zw) <= 1e-6 * abs(zw) + 1e-7      # one f32 rounding


def test_noise_plane_is_a_function_of_key_leaf_and_element_alone():
    from repro_torch.engine.backends import aircomp_noise
    a = aircomp_noise((11, 4), 2, (6, 50), "cpu")
    assert a.dtype == torch.float32 and a.shape == (6, 50)
    assert np.array_equal(bits(a), bits(aircomp_noise((11, 4), 2, (6, 50),
                                                      "cpu")))
    # the same key and leaf at another shape: the same elements, in order
    flat = aircomp_noise((11, 4), 2, (400,), "cpu")
    assert np.array_equal(bits(a).ravel(), bits(flat)[:300])


def test_noise_keys_rounds_and_leaves_never_share_draws():
    from repro_torch.kernels.contention import counter_key, counter_uniform53
    seen = []
    for entropy in (0, 5, 2 ** 63 + 1):
        for t in (0, 1, 7):
            for leaf in (0, 1, 3):
                seen.append(counter_uniform53(counter_key(entropy, t), leaf,
                                              2, 256, "cpu").reshape(-1))
    u = torch.cat(seen)
    assert torch.unique(u).numel() == u.numel() == 27 * 2 * 256


def test_noise_moments_and_normality_over_a_million_draws():
    from scipy import stats
    from repro_torch.engine.backends import aircomp_noise
    z = aircomp_noise((20230917, 3), 1, (1_000_000,), "cpu").double().numpy()
    assert np.isfinite(z).all()
    assert abs(z.mean()) < 5e-3                      # 5 standard errors
    assert abs(z.var() - 1.0) < 7e-3                 # 5 standard errors
    assert abs(stats.skew(z)) < 0.0125 and abs(stats.kurtosis(z)) < 0.025
    assert stats.kstest(z, "norm").pvalue > 1e-3
    # both tails at 3 sigma: 0.27 % of the draws, within 5 standard errors
    assert abs(np.mean(np.abs(z) > 3.0) - 0.0026998) < 2.6e-4
