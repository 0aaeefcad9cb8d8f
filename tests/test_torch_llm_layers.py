"""The port's LLM layers (``repro_torch.models.{layers,rope,attention}``)
against the JAX package's, on the CPU: the same numpy inputs, made from
a seed, go through both. Bars: f32 ``rtol=1e-5, atol=1e-6`` (the two
frameworks sum in different orders; nothing here is bf16).

``flash_attention`` is held over the parameter grid of
``tests/test_attention.py`` (S / T / chunk, window None / 0 / 4, softcap
0 / 20), with invalid key positions and a window given as a 0-dim
tensor 0 (full attention); ``_cache_write`` in both modes: the ring slot
``pos % C`` at one token, the slab (its start clamped into the cache as
``dynamic_update_slice`` clamps it) at more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import attention as jatt, layers as jl, rope as jrope
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.models import attention as tatt, layers as tl, \
    rope as trope

TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(**kw):
    """One config in each package from the same fields."""
    return JConfig(**kw), TConfig(**kw)


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


# ---------------------------------------------------------------- norms
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    x, scale, bias = _rand(0, (2, 5, 16)), _rand(1, (16,), 0.1), \
        _rand(2, (16,), 0.1)
    p = {"scale": scale} if kind == "rmsnorm" else {"scale": scale,
                                                    "bias": bias}
    want = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    got = tl.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), kind)
    _close(got, want)


def test_rmsnorm_gated():
    x, z, scale = _rand(3, (2, 4, 8)), _rand(4, (2, 4, 8)), \
        _rand(5, (8,), 0.1)
    want = jl.rmsnorm_gated(jnp.asarray(scale), jnp.asarray(x),
                            jnp.asarray(z))
    got = tl.rmsnorm_gated(torch.from_numpy(scale), torch.from_numpy(x),
                           torch.from_numpy(z))
    _close(got, want)


# ---------------------------------------------------------------- MLP
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_apply_mlp(activation):
    D, F = 16, 32
    p = {"w_up": _rand(6, (D, F), 0.2), "w_down": _rand(7, (F, D), 0.2)}
    if activation != "gelu":
        p["w_gate"] = _rand(8, (D, F), 0.2)
    x = _rand(9, (2, 3, D))
    want = jl.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), activation)
    got = tl.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), activation)
    _close(got, want)


# ---------------------------------------------------------------- rope
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    x = _rand(10, (2, 6, 3, 16))
    pos = np.arange(4, 10, dtype=np.int32)[None, :]
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want)


# ---------------------------------------------------------------- embed
@pytest.mark.parametrize("tie,softcap,vocab", [(False, 0.0, 40),
                                               (True, 30.0, 37)])
def test_embed_and_unembed(tie, softcap, vocab):
    jc, tc = _pair(d_model=16, vocab_size=vocab, vocab_pad_multiple=16,
                   tie_embeddings=tie, final_logit_softcap=softcap,
                   dtype="float32", param_dtype="float32")
    emb = _rand(11, (jc.padded_vocab, 16), 0.3)
    head = {"w_out": _rand(12, (16, jc.padded_vocab), 0.3)}
    toks = np.random.default_rng(13).integers(0, vocab, (2, 5)) \
        .astype(np.int32)
    xj = jl.embed_tokens({"embedding": jnp.asarray(emb)}, jnp.asarray(toks),
                         jc)
    xt = tl.embed_tokens({"embedding": torch.from_numpy(emb)},
                         torch.from_numpy(toks), tc)
    _close(xt, xj)
    hj = {} if tie else {k: jnp.asarray(v) for k, v in head.items()}
    ht = {} if tie else {k: torch.from_numpy(v) for k, v in head.items()}
    want = jl.unembed({"embedding": jnp.asarray(emb)}, hj, xj, jc)
    got = tl.unembed({"embedding": torch.from_numpy(emb)}, ht, xt, tc)
    _close(got, want)
    if jc.padded_vocab != vocab:
        assert (got[..., vocab:] == -1e30).all()


# ---------------------------------------------------------------- losses
def test_cross_entropy_loss():
    logits = _rand(14, (2, 6, 24), 2.0)
    labels = np.random.default_rng(15).integers(-1, 20, (2, 6))
    want = jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), 20)
    got = tl.cross_entropy_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels), 20)
    _close(got, want)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunked_cross_entropy(softcap):
    jc, tc = _pair(d_model=16, vocab_size=60, vocab_pad_multiple=16,
                   loss_vocab_chunks=4, final_logit_softcap=softcap)
    x = _rand(16, (2, 5, 16))
    table = _rand(17, (jc.padded_vocab, 16), 0.5)
    labels = np.random.default_rng(18).integers(-1, 60, (2, 5))
    want = jl.chunked_cross_entropy(jnp.asarray(x), jnp.asarray(table),
                                    jnp.asarray(labels), jc)
    got = tl.chunked_cross_entropy(torch.from_numpy(x),
                                   torch.from_numpy(table),
                                   torch.from_numpy(labels), tc)
    _close(got, want)


def test_sinusoidal_positions():
    _close(tl.sinusoidal_positions(7, 12, offset=3),
           jl.sinusoidal_positions(7, 12, offset=3))
    pos = np.array([0, 5, 9], np.int32)
    _close(tl.sinusoidal_positions_dynamic(torch.from_numpy(pos), 12),
           jl.sinusoidal_positions_dynamic(jnp.asarray(pos), 12))


# ---------------------------------------------------------------- flash
def _flash_pair(q, k, v, q_pos, k_pos, **kw):
    want = jatt.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(q_pos), k_positions=jnp.asarray(k_pos), **kw)
    tkw = dict(kw)
    if isinstance(kw.get("window"), jax.Array):
        tkw["window"] = torch.tensor(int(kw["window"]))
    got = tatt.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(q_pos),
        k_positions=torch.from_numpy(k_pos), **tkw)
    return got, want


@pytest.mark.parametrize("S,T,chunk", [(8, 8, 4), (16, 16, 16), (1, 37, 8),
                                       (5, 64, 16)])
@pytest.mark.parametrize("window", [None, 0, 4])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_flash_attention_matches_jax(S, T, chunk, window, softcap):
    B, Kv, G, Dh = 2, 2, 3, 16
    q = _rand(20, (B, S, Kv, G, Dh))
    k, v = _rand(21, (B, T, Kv, Dh)), _rand(22, (B, T, Kv, Dh))
    q_pos = np.arange(T - S, T, dtype=np.int32)
    k_pos = np.arange(T, dtype=np.int32)
    got, want = _flash_pair(q, k, v, q_pos, k_pos, causal=True,
                            window=window, softcap=softcap, chunk=chunk)
    _close(got, want)


def test_flash_attention_invalid_kpos_excluded():
    B, S, Kv, G, Dh, T = 1, 2, 1, 1, 8, 6
    q = _rand(23, (B, S, Kv, G, Dh))
    k, v = _rand(24, (B, T, Kv, Dh)), _rand(25, (B, T, Kv, Dh))
    k_pos = np.array([0, 1, -1, -1, -1, -1], np.int32)
    q_pos = np.array([0, 1], np.int32)
    got, want = _flash_pair(q, k, v, q_pos, k_pos, chunk=3)
    _close(got, want)
    # the empty slots change nothing: the same keys without them
    short, _ = _flash_pair(q, k[:, :2], v[:, :2], q_pos, k_pos[:2], chunk=2)
    _close(got, short.numpy())


def test_flash_attention_tensor_window_zero_is_full_attention():
    B, S, Kv, G, Dh, T = 1, 6, 1, 2, 8, 6
    q = _rand(26, (B, S, Kv, G, Dh))
    k, v = _rand(27, (B, T, Kv, Dh)), _rand(28, (B, T, Kv, Dh))
    pos = np.arange(T, dtype=np.int32)
    got, want = _flash_pair(q, k, v, pos, pos, window=jnp.int32(0), chunk=4)
    _close(got, want)
    full, _ = _flash_pair(q, k, v, pos, pos, window=None, chunk=4)
    _close(got, full.numpy())


# ---------------------------------------------------------------- caches
def _cache_pair(C, seed):
    k = _rand(seed, (2, C, 2, 4))
    v = _rand(seed + 1, (2, C, 2, 4))
    pos = np.full((C,), -1, np.int32)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)}
    tc = {"k": torch.from_numpy(k), "v": torch.from_numpy(v),
          "pos": torch.from_numpy(pos)}
    return jc, tc


@pytest.mark.parametrize("S,start", [(1, 0), (1, 5), (1, 13), (3, 0), (3, 2),
                                     (3, 6)])
def test_cache_write_matches_jax(S, start):
    """S = 1: the ring slot ``start % 8``; S = 3: the slab at ``start``
    (6 runs past the 8-entry cache, so the start is clamped to 5)."""
    jc, tc = _cache_pair(8, seed=30 + S)
    k_new, v_new = _rand(40, (2, S, 2, 4)), _rand(41, (2, S, 2, 4))
    pos = np.arange(start, start + S, dtype=np.int32)
    want = jatt._cache_write(jc, jnp.asarray(k_new), jnp.asarray(v_new),
                             jnp.asarray(pos))
    before = {n: t.clone() for n, t in tc.items()}
    got = tatt._cache_write(tc, torch.from_numpy(k_new),
                            torch.from_numpy(v_new), torch.from_numpy(pos))
    for name in ("k", "v", "pos"):
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))
        assert torch.equal(tc[name], before[name])   # the input is kept


def test_make_kv_cache_matches_jax():
    jc, tc = _pair(num_kv_heads=2, head_dim=8, num_heads=4, d_model=32)
    want = jatt.make_kv_cache(jc, 2, 5, jnp.float32)
    got = tatt.make_kv_cache(tc, 2, 5, torch.float32, "cpu")
    for name in ("k", "v", "pos"):
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))


def test_gqa_decode_against_jax():
    """``apply_gqa`` with a cache (one decode token) and without (a
    prefill) against JAX, from equal weights."""
    jc, tc = _pair(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                   attn_logit_softcap=20.0)
    w = {"wq": _rand(50, (32, 4, 8), 0.2), "wk": _rand(51, (32, 2, 8), 0.2),
         "wv": _rand(52, (32, 2, 8), 0.2), "wo": _rand(53, (4, 8, 32), 0.2)}
    x = _rand(54, (2, 5, 32))
    pos = np.arange(5, dtype=np.int32)
    jw = {n: jnp.asarray(a) for n, a in w.items()}
    tw = {n: torch.from_numpy(a) for n, a in w.items()}
    yj, _ = jatt.apply_gqa(jw, jnp.asarray(x), cfg=jc,
                           positions=jnp.asarray(pos), window=2)
    yt, _ = tatt.apply_gqa(tw, torch.from_numpy(x), cfg=tc,
                           positions=torch.from_numpy(pos), window=2)
    _close(yt, yj)
    cj = jatt.make_kv_cache(jc, 2, 8, jnp.float32)
    ct = tatt.make_kv_cache(dataclasses.replace(tc), 2, 8, torch.float32,
                            "cpu")
    for i in range(5):
        p = np.array([i], np.int32)
        yj, cj = jatt.apply_gqa(jw, jnp.asarray(x[:, i:i + 1]), cfg=jc,
                                positions=jnp.asarray(p), cache=cj)
        yt, ct = tatt.apply_gqa(tw, torch.from_numpy(x[:, i:i + 1]), cfg=tc,
                                positions=torch.from_numpy(p), cache=ct)
        _close(yt, yj)
    assert np.array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


def test_mla_raises_until_its_slice():
    """MLA's slice has landed: its params and latent cache take the
    reference's layout (``tests/test_torch_llm_moe.py`` holds its values
    against JAX); the flash-chunk recompute lever, which raised until
    it was ported, gives the values it gives off."""
    jc, tc = _pair(attention_type="mla")
    want = jax.eval_shape(lambda k: jatt.init_attention(k, jc, jnp.float32),
                          jax.random.PRNGKey(0))
    got = tatt.init_attention(torch.Generator().manual_seed(0), tc,
                              torch.float32)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    cache = tatt.make_kv_cache(tc, 1, 4, torch.float32, "cpu")
    jcache = jatt.make_kv_cache(jc, 1, 4, jnp.float32)
    assert sorted(cache) == sorted(jcache) == ["k", "pos"]
    assert tuple(cache["k"].shape) == tuple(jcache["k"].shape)
    # ``chunk_remat`` is honoured (it raised while unported): the same
    # values as without it
    args = (torch.zeros(1, 1, 1, 1, 4), torch.ones(1, 2, 1, 4),
            torch.arange(8.0).reshape(1, 2, 1, 4))
    kw = dict(q_positions=torch.ones(1, dtype=torch.int32),
              k_positions=torch.arange(2, dtype=torch.int32), chunk=1)
    assert torch.equal(tatt.flash_attention(*args, chunk_remat=True, **kw),
                       tatt.flash_attention(*args, **kw))


def test_truncated_normal_init_in_distribution():
    """Draws from a generator: the same seed gives the same bits, the
    values lie in [-2, 2] standard deviations of scale / sqrt(fan_in),
    and their spread is that of the truncated normal (0.88 sigma)."""
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = tl.truncated_normal_init(gen(), (64, 4, 128), 1.0, torch.float32,
                                 lead=(3,))
    b = tl.truncated_normal_init(gen(), (64, 4, 128), 1.0, torch.float32,
                                 lead=(3,))
    assert a.shape == (3, 64, 4, 128) and torch.equal(a, b)
    std = 1.0 / np.sqrt(64)
    assert float(a.abs().max()) <= 2.0 * std + 1e-7
    assert abs(float(a.std()) / std - 0.8796) < 0.01
    meta = tl.truncated_normal_init(torch.device("meta"), (4, 5), 1.0,
                                    torch.bfloat16)
    assert meta.is_meta and meta.dtype == torch.bfloat16
