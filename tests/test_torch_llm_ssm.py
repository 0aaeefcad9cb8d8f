"""The port's SSM and hybrid families (``repro_torch.models.ssm``, the
``"mamba"`` and ``"hybrid"`` blocks, ``mamba2-370m`` and ``hymba-1.5b``)
against the JAX package's, on the CPU.

The same numpy inputs, and the JAX package's own parameter draws carried
across with ``convert.params_from_numpy``, go to both sides. Bar, f32:
``TOL`` (rtol 1e-5, atol 2e-5) for every value compared with JAX (the
two archs' loss and gradients are held with the other archs' in
``tests/test_torch_llm_model.py``). Within the port: decode against
``forward`` at the reference's bar (``tests/test_decode_parity.py``:
1e-3 absolute), hymba's ring cache wrapping in its long-context
variant, mamba2's bf16 drift from its f32 logits against the
reference's, and the token-sum contract bit for bit: a user's gradient
through ``layers.rmsnorm_gated`` and ``layers.broadcast`` (the Mamba-2
parameters) is the same bits alone as in a stack of 3 or 10. At 4 CPU
threads: each op ``layers.per_user`` routes keeps a user's bits alone
and in a stack of 3 or 10, and a CPU twin of ``chip_smoke.py``'s
``row_count_bits`` finds no aten op of a mamba2 / hymba local step whose
bits follow the stack's size.
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.configs.registry import get_config as jget
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import model as jm
from repro.models import ssm as jssm
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as L
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-5, atol=2e-5)
ARCHS = ["mamba2-370m", "hymba-1.5b"]
B = 2


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def bits(t):
    return t.detach().contiguous().view(torch.int32).numpy()


def ssd_inputs(seed, b, s, h, p, n):
    X = rand(seed, b, s, h, p)
    dtA = -np.abs(rand(seed + 1, b, s, h))
    return X, dtA, rand(seed + 2, b, s, n), rand(seed + 3, b, s, n)


def both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def naive_recurrence(X, dtA, Bm, Cm):
    """h_t = exp(dtA_t) h_{t-1} + x_t B_t^T, y_t = h_t C_t, in f64."""
    b, s, h, p = X.shape
    st = np.zeros((b, h, p, Bm.shape[-1]))
    ys = np.zeros((b, s, h, p))
    for t in range(s):
        st = st * np.exp(dtA[:, t])[:, :, None, None] + np.einsum(
            "bhp,bn->bhpn", X[:, t], Bm[:, t])
        ys[:, t] = np.einsum("bhpn,bn->bhp", st, Cm[:, t])
    return ys, st


# ------------------------------------------------------------ the SSD scan
@pytest.mark.parametrize("chunk", [2, 4, 8, 16])
def test_ssd_chunked_matches_jax(chunk):
    """The cases of ``tests/test_ssm.py``: the chunked scan against JAX's
    and against the step-by-step recurrence (its 1e-4 bar)."""
    arrays = ssd_inputs(10 + chunk, 2, 16, 3, 4, 5)
    (jX, jA, jB, jC), (tX, tA, tB, tC) = both(*arrays)
    wy, wst = jssm.ssd_chunked(jX, jA, jB, jC, chunk)
    y, st = tssm.ssd_chunked(tX, tA, tB, tC, chunk)
    close(y, wy)
    close(st, wst)
    ry, rst = naive_recurrence(*arrays)
    close(y, ry, rtol=1e-4, atol=1e-4)
    close(st, rst, rtol=1e-4, atol=1e-4)


def test_ssd_initial_state_continuation_matches_jax():
    """A sequence split in two with the state carried = one pass, and
    JAX's continuation."""
    X, dtA, Bm, Cm = ssd_inputs(4, 1, 16, 2, 3, 4)
    (jX, jA, jB, jC), (tX, tA, tB, tC) = both(X, dtA, Bm, Cm)
    y_full, st_full = tssm.ssd_chunked(tX, tA, tB, tC, 4)
    y1, st1 = tssm.ssd_chunked(tX[:, :8], tA[:, :8], tB[:, :8], tC[:, :8], 4)
    y2, st2 = tssm.ssd_chunked(tX[:, 8:], tA[:, 8:], tB[:, 8:], tC[:, 8:], 4,
                               initial_state=st1)
    close(torch.cat([y1, y2], 1), y_full.numpy(), rtol=1e-4, atol=1e-4)
    close(st2, st_full.numpy(), rtol=1e-4, atol=1e-4)
    _, jst1 = jssm.ssd_chunked(jX[:, :8], jA[:, :8], jB[:, :8], jC[:, :8], 4)
    jy2, jst2 = jssm.ssd_chunked(jX[:, 8:], jA[:, 8:], jB[:, 8:], jC[:, 8:],
                                 4, initial_state=jst1)
    close(y2, jy2)
    close(st2, jst2)


@pytest.mark.parametrize("L_", [1, 5, 16, 33])
def test_cumsum_and_segsum_match_jax(L_):
    """The fixed-order prefix sum (doubling steps) and the segment sums
    built on it, against ``jnp.cumsum`` and the reference's ``_segsum``;
    a row's bits are the same alone as in the stack."""
    a = -np.abs(rand(7, 3, 4, L_))
    got = tssm._cumsum(torch.from_numpy(a))
    close(got, jnp.cumsum(jnp.asarray(a), axis=-1), rtol=1e-6, atol=1e-6)
    seg = tssm._segsum(got).numpy()
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    low = np.tril(np.ones((L_, L_), bool))
    np.testing.assert_allclose(seg[..., low], want[..., low], rtol=1e-5,
                               atol=1e-5)
    assert (seg[..., ~low] == want[..., ~low]).all()
    assert np.array_equal(bits(tssm._cumsum(torch.from_numpy(a[1:2]))),
                          bits(got[1:2]))


# ------------------------------------------------------------ the layer
def mamba_case():
    """The reduced mamba2-370m's Mamba-2 layer params in both packages."""
    jc, tc = jget("mamba2-370m").reduced(), tget("mamba2-370m").reduced()
    jp = jssm.init_mamba2(jax.random.PRNGKey(0), jc, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
def test_causal_conv_matches_jax(with_state):
    jc, _, jp, tp = mamba_case()
    C = jc.ssm_d_inner + 2 * jc.ssm_state
    xbc = rand(1, B, 9, C)
    state = rand(2, B, jc.ssm_conv_width - 1, C) if with_state else None
    jargs = [jnp.asarray(xbc), jp["conv_w"], jp["conv_b"] + 0.1]
    targs = [torch.from_numpy(xbc), tp["conv_w"], tp["conv_b"] + 0.1]
    if with_state:
        jargs.append(jnp.asarray(state))
        targs.append(torch.from_numpy(state))
    wy, wst = jssm._causal_conv(*jargs)
    y, st = tssm._causal_conv(*targs)
    close(y, wy)
    assert np.array_equal(st.numpy(), np.asarray(wst))


@pytest.mark.parametrize("S", [12, 40, 64], ids=["one-chunk", "padded",
                                                 "two-chunks"])
def test_apply_mamba2_chunked_matches_jax(S):
    """The chunked path (chunk 32 at the reduced size: one short chunk, a
    chunk and a padded tail, two chunks), without a cache and as a
    prefill writing the conv and SSM states."""
    jc, tc, jp, tp = mamba_case()
    x = 0.5 * rand(3, B, S, jc.d_model)
    want, _ = jssm.apply_mamba2(jp, jnp.asarray(x), jc)
    got, none = tssm.apply_mamba2(tp, torch.from_numpy(x), tc)
    close(got, want)
    assert none is None
    jcache = jssm.make_ssm_cache(jc, B, jnp.float32)
    tcache = tssm.make_ssm_cache(tc, B, torch.float32)
    want, jnew = jssm.apply_mamba2(jp, jnp.asarray(x), jc, cache=jcache)
    got, tnew = tssm.apply_mamba2(tp, torch.from_numpy(x), tc, cache=tcache)
    close(got, want)
    close(tnew["conv"], jnew["conv"])
    close(tnew["state"], jnew["state"])
    assert not tcache["state"].any()            # the caller's cache is kept


def test_apply_mamba2_single_step_matches_jax():
    """The S = 1 recurrence from a prefilled cache, three steps, against
    JAX's and against the chunked path over the whole sequence."""
    jc, tc, jp, tp = mamba_case()
    x = 0.5 * rand(4, B, 23, jc.d_model)
    full, _ = tssm.apply_mamba2(tp, torch.from_numpy(x), tc)
    jcache = jssm.make_ssm_cache(jc, B, jnp.float32)
    tcache = tssm.make_ssm_cache(tc, B, torch.float32)
    _, jcache = jssm.apply_mamba2(jp, jnp.asarray(x[:, :20]), jc,
                                  cache=jcache)
    _, tcache = tssm.apply_mamba2(tp, torch.from_numpy(x[:, :20]), tc,
                                  cache=tcache)
    for t in range(20, 23):
        want, jcache = jssm.apply_mamba2(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                         cache=jcache)
        got, tcache = tssm.apply_mamba2(tp, torch.from_numpy(x[:, t:t + 1]),
                                        tc, cache=tcache)
        close(got, want)
        close(tcache["state"], jcache["state"])
        close(tcache["conv"], jcache["conv"])
        close(got[:, 0], full[:, t].numpy(), rtol=1e-4, atol=1e-4)


def test_apply_mamba2_bf16_matches_jax():
    """bf16 params and activations (the f32 dt and B / C where JAX
    promotes them, the f32 SSM state, a bf16 output): a 39-token prefill
    into the caches and a decode step. Each side's bf16 output against
    the port's f32 run on the same bf16-rounded params and inputs: the
    port within 2^-7 of the output's scale (two bf16 ulps at its top),
    the bar JAX's own bf16 meets, and on average no further off than
    JAX (XLA keeps some bf16 intermediates in f32; torch rounds each op)."""
    jc, tc, jp, _ = mamba_case()
    jc = dataclasses.replace(jc, dtype="bfloat16", param_dtype="bfloat16")
    tc = dataclasses.replace(tc, dtype="bfloat16", param_dtype="bfloat16")
    jp16 = {k: v if k in ("A_log", "dt_bias", "D_skip")
            else v.astype(jnp.bfloat16) for k, v in jp.items()}
    tp16 = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype=torch.bfloat16)
    assert tp16["A_log"].dtype == torch.float32
    tp32 = tree_map(lambda t: t.float(), tp16)
    t32 = dataclasses.replace(tc, dtype="float32", param_dtype="float32")
    x = 0.5 * rand(5, B, 40, jc.d_model)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jcache = jssm.make_ssm_cache(jc, B, jnp.bfloat16)
    tcache = tssm.make_ssm_cache(tc, B, torch.bfloat16)
    fcache = tssm.make_ssm_cache(t32, B, torch.float32)
    assert tcache["conv"].dtype == torch.bfloat16
    assert tcache["state"].dtype == torch.float32
    for sl in (slice(0, 39), slice(39, 40)):
        want, jcache = jssm.apply_mamba2(jp16, jx[:, sl], jc, cache=jcache)
        got, tcache = tssm.apply_mamba2(tp16, tx[:, sl], tc, cache=tcache)
        ref, fcache = tssm.apply_mamba2(tp32, tx[:, sl].float(), t32,
                                        cache=fcache)
        assert got.dtype == torch.bfloat16
        assert tcache["state"].dtype == torch.float32
        ref = ref.numpy()
        scale = np.abs(ref).max()
        e_port = np.abs(got.float().numpy() - ref)
        e_jax = np.abs(np.asarray(want, np.float32) - ref)
        assert e_jax.max() <= 2 ** -7 * scale
        assert e_port.max() <= 2 ** -7 * scale
        assert e_port.mean() <= 1.25 * e_jax.mean()


# ------------------------------------------------------------ the blocks
def block_case(block_type, arch):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    jp = jblocks.init_block(jax.random.PRNGKey(3), jc, block_type,
                            jnp.float32)
    # the zero-initialised scales made non-zero, so that they count
    jp = jax.tree.map(lambda a: a + 0.05 * jnp.sin(
        jnp.arange(a.size, dtype=jnp.float32).reshape(a.shape)), jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("block_type,arch,window", [
    ("mamba", "mamba2-370m", 0), ("hybrid", "hymba-1.5b", 0),
    ("hybrid", "hymba-1.5b", 8)], ids=["mamba", "hybrid-global",
                                       "hybrid-window8"])
def test_blocks_match_jax(block_type, arch, window):
    """``apply_block``: the whole sequence, a prefill writing the caches
    and two decode steps, against JAX's."""
    jc, tc, jp, tp = block_case(block_type, arch)
    S = 20
    x = 0.5 * rand(6, B, S + 2, jc.d_model)
    pos = np.arange(S + 2, dtype=np.int32)

    def jrun(xs, p0, cache):
        return jblocks.apply_block(
            jp, jnp.asarray(xs), cfg=jc, block_type=block_type,
            positions=jnp.asarray(pos[p0:p0 + xs.shape[1]]),
            window=jnp.int32(window), cache=cache)

    def trun(xs, p0, cache):
        return tblocks.apply_block(
            tp, torch.from_numpy(xs), cfg=tc, block_type=block_type,
            positions=torch.from_numpy(pos[p0:p0 + xs.shape[1]]),
            window=window, cache=cache)

    want, _, _ = jrun(x[:, :S], 0, None)
    got, none, aux = trun(x[:, :S], 0, None)
    close(got, want)
    assert none is None and float(aux) == 0.0
    jc_ = jblocks.make_block_cache(jc, block_type, B, 32, jnp.float32)
    tc_ = tblocks.make_block_cache(tc, block_type, B, 32, torch.float32)
    assert sorted(tc_) == sorted(jc_)
    want, jc_, _ = jrun(x[:, :S], 0, jc_)
    got, tc_, _ = trun(x[:, :S], 0, tc_)
    close(got, want)
    for t in (S, S + 1):
        want, jc_, _ = jrun(x[:, t:t + 1], t, jc_)
        got, tc_, _ = trun(x[:, t:t + 1], t, tc_)
        close(got, want)
    for (k, a), b in zip(sorted((k, v) for k, v in _flat(tc_)),
                         (v for _, v in sorted(_flat(jc_)))):
        close(a, b) if a.is_floating_point() else \
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# ------------------------------------------------------------ the models
class Case:
    """One arch's reduced config in both packages, the JAX params and
    their port copy, and a batch of tokens."""

    def __init__(self, arch):
        self.jc, self.tc = jget(arch).reduced(), tget(arch).reduced()
        self.jp = jm.init_params(jax.random.PRNGKey(0), self.jc)
        self.tp = params_from_numpy(jax.tree.map(np.asarray, self.jp),
                                    device="cpu")
        self.tokens = np.random.default_rng(1).integers(
            0, self.jc.vocab_size, (B, 101)).astype(np.int32)


@pytest.fixture(scope="module")
def cases():
    return {}


def case(cases, arch):
    if arch not in cases:
        cases[arch] = Case(arch)
    return cases[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_and_jax(arch, cases):
    """Decode from empty caches, token by token, against JAX's decode
    (TOL) and the port's ``forward`` (1e-3)."""
    c = case(cases, arch)
    toks = c.tokens[:, :12]
    full, _, _ = tm.forward(c.tp, torch.from_numpy(toks), c.tc)
    want, _, _ = jm.forward(c.jp, jnp.asarray(toks), c.jc)
    close(full, want)
    ct = tm.make_caches(c.tc, B, 32, device="cpu")
    cj = jm.make_caches(c.jc, B, 32)
    errs = []
    for i in range(toks.shape[1]):
        lt, ct = tm.decode_step(c.tp, ct, torch.from_numpy(toks[:, i]), i,
                                c.tc)
        lj, cj = jm.decode_step(c.jp, cj, jnp.asarray(toks[:, i]),
                                jnp.int32(i), c.jc)
        close(lt, lj)
        errs.append(float((lt - full[:, i]).abs().max()))
    assert max(errs) < 1e-3, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch, cases):
    """A 70-token prefill (two chunks of 32 and a padded tail of 6) into
    the caches, then 30 decode steps, against ``forward`` over the 100
    tokens (1e-3) and JAX's prefill and decode (TOL). hymba's local
    layer's 64-token window slides past the first positions."""
    c = case(cases, arch)
    toks = c.tokens[:, :100]
    full, _, _ = tm.forward(c.tp, torch.from_numpy(toks), c.tc)
    ct = tm.make_caches(c.tc, B, 128, device="cpu")
    cj = jm.make_caches(c.jc, B, 128)
    pre, ct, _ = tm.forward(c.tp, torch.from_numpy(toks[:, :70]), c.tc,
                            caches=ct)
    jpre, cj, _ = jm.forward(c.jp, jnp.asarray(toks[:, :70]), c.jc,
                             caches=cj)
    close(pre, jpre)
    assert float((pre - full[:, :70]).abs().max()) < 1e-3
    for i in range(70, 100):
        lt, ct = tm.decode_step(c.tp, ct, torch.from_numpy(toks[:, i]), i,
                                c.tc)
        lj, cj = jm.decode_step(c.jp, cj, jnp.asarray(toks[:, i]),
                                jnp.int32(i), c.jc)
        close(lt, lj)
        assert float((lt - full[:, i]).abs().max()) < 1e-3


def test_hybrid_ring_cache_wraps_in_long_context(cases):
    """hymba's long-context variant windows every layer (its global
    layers at ``long_context_window``, 64 reduced), so a 64-entry ring
    cache serves it: a 32-token prefill, then 68 decode steps, whose
    ring slots wrap from position 64 on, against JAX's same ring decode
    (TOL) and the port's long-context ``forward`` (1e-3)."""
    c = case(cases, "hymba-1.5b")
    assert c.tc.layer_windows(0, long_context=True) == [64, 64]
    toks = c.tokens[:, :100]
    full, _, _ = tm.forward(c.tp, torch.from_numpy(toks), c.tc,
                            long_context=True)
    ct = tm.make_caches(c.tc, B, 64, long_context=True, device="cpu")
    cj = jm.make_caches(c.jc, B, 64, long_context=True)
    pre, ct, _ = tm.forward(c.tp, torch.from_numpy(toks[:, :32]), c.tc,
                            caches=ct, long_context=True)
    jpre, cj, _ = jm.forward(c.jp, jnp.asarray(toks[:, :32]), c.jc,
                             caches=cj, long_context=True)
    close(pre, jpre)
    assert float((pre - full[:, :32]).abs().max()) < 1e-3
    jstep = jax.jit(lambda p, cache, tok, i: jm.decode_step(
        p, cache, tok, i, c.jc, long_context=True))
    for i in range(32, 100):
        lt, ct = tm.decode_step(c.tp, ct, torch.from_numpy(toks[:, i]), i,
                                c.tc, long_context=True)
        lj, cj = jstep(c.jp, cj, jnp.asarray(toks[:, i]), jnp.int32(i))
        close(lt, lj)
        assert float((lt - full[:, i]).abs().max()) < 1e-3, i
    # the ring holds the last 64 positions, the oldest overwritten
    pos = ct["blocks0"]["attn"]["pos"][0]
    assert sorted(pos.tolist()) == list(range(36, 100))


def _bf16(tree):
    """A JAX f32 param tree rounded to bf16, the Mamba-2 layer's f32
    leaves kept (as ``convert.F32_LEAVES``)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v if getattr(path[-1], "key", None) in (
            "A_log", "dt_bias", "D_skip") else v.astype(jnp.bfloat16), tree)


def _range_gap(got, want):
    """The largest gap over each row's logit range."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    span = want.max(-1) - want.min(-1)
    return float((np.abs(got - want).max(-1) / span).max())


@pytest.mark.parametrize("layers", [2, 8, 16])
def test_mamba2_bf16_drift_follows_the_reference(layers):
    """The reduced mamba2-370m at ``layers`` layers, from one f32 draw:
    each package's bf16 forward (the params rounded to bf16, A_log,
    dt_bias and D_skip kept f32) against its own f32 forward, the gap
    over each row's logit range. The port's drift is the reference's
    within a factor of 2 either way, and is real (past 1e-3 of the
    range). The drift grows with depth in both (about 0.003 / 0.015 /
    0.03 at 2 / 8 / 16 layers), the witness that the full-depth bf16
    drift ``chip_smoke.py`` measures at 48 layers is the model's in bf16
    and not the port's."""
    jc = dataclasses.replace(jget("mamba2-370m").reduced(),
                             num_layers=layers)
    tc = dataclasses.replace(tget("mamba2-370m").reduced(),
                             num_layers=layers)
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    toks = np.random.default_rng(1).integers(
        0, jc.vocab_size, (B, 48)).astype(np.int32)
    V = jc.vocab_size
    np32 = jax.tree.map(np.asarray, jp)
    drift = {}
    for side in ("jax", "port"):
        out = {}
        for dt in ("float32", "bfloat16"):
            if side == "jax":
                cfg = dataclasses.replace(jc, dtype=dt, param_dtype=dt)
                p = jp if dt == "float32" else _bf16(jp)
                logits = jm.forward(p, jnp.asarray(toks), cfg)[0]
            else:
                cfg = dataclasses.replace(tc, dtype=dt, param_dtype=dt)
                p = params_from_numpy(np32, device="cpu",
                                      dtype=getattr(torch, dt))
                with torch.no_grad():
                    logits = tm.forward(p, torch.from_numpy(toks), cfg)[0]
                logits = logits.float()
            out[dt] = np.asarray(logits, np.float32)[..., :V]
        drift[side] = _range_gap(out["bfloat16"], out["float32"])
    assert drift["jax"] > 1e-3, drift
    assert 0.5 <= drift["port"] / drift["jax"] <= 2.0, drift


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_match_jax_in_layout_and_dtype(arch):
    """The layer-stacked caches at the published dims in bf16 (meta
    device): an SSM cache has no length axis, its state is f32."""
    jc, tc = jget(arch), tget(arch)
    want = dict(_flat(jax.eval_shape(lambda: jm.make_caches(jc, 3, 40))))
    got = dict(_flat(tm.make_caches(tc, 3, 40, device="meta")))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).split(".")[1] == str(want[k].dtype), k
    assert got["/blocks0/ssm/state"].dtype == torch.float32


# ------------------------------------------------------------ row bits
def tiny_cfg():
    """A Mamba-2 layer small enough that no tensor of a 10-user step
    passes the CPU's 32768-element thread split (see
    ``test_rmsnorm_gated_scale_gradient_row_bits``)."""
    return dataclasses.replace(tget("mamba2-370m").reduced(), d_model=64,
                               ssm_head_dim=16, ssm_state=8, ssm_chunk=8)


@pytest.mark.parametrize("U", [1, 3, 10])
def test_rmsnorm_gated_scale_gradient_row_bits(U):
    """``vmap(grad)`` through ``rmsnorm_gated``: each user's scale and
    input gradients and its loss are the same bits alone, in a stack of U
    and of 10; the values against ``jax.grad``. A user holds 1024 values
    and 10 hold fewer than 32768: torch's CPU elementwise kernels then
    treat every user's elements alike (a tensor's tail past the last
    whole SIMD vector, or a thread's chunk of a larger tensor, takes a
    scalar ``exp`` in ``silu`` that can differ in the last bit)."""
    D = 32
    x, z = rand(1, 10, 2, 16, D), rand(2, 10, 2, 16, D)
    w = rand(3, 2, 16, D)
    sc = 0.1 * rand(4, 10, D)

    def loss(scale, xu, zu):
        return L.token_sum(L.rmsnorm_gated(scale, xu, zu)
                           * torch.from_numpy(w))

    fn = torch.func.grad_and_value(loss, argnums=(0, 1))
    tx, tz, ts = map(torch.from_numpy, (x, z, sc))
    (gs, gx), lv = torch.func.vmap(fn)(ts[:U], tx[:U], tz[:U])
    (gs10, _), lv10 = torch.func.vmap(fn)(ts, tx, tz)
    for u in range(U):
        (gsu, gxu), lu = fn(ts[u], tx[u], tz[u])
        assert np.array_equal(bits(lv[u]), bits(lu))
        assert np.array_equal(bits(gs[u]), bits(gsu))
        assert np.array_equal(bits(gx[u]), bits(gxu))
        assert np.array_equal(bits(gs[u]), bits(gs10[u]))
    jfn = jax.grad(lambda s, a, b: jnp.sum(jlayers.rmsnorm_gated(s, a, b)
                                           * w), argnums=(0, 1))
    jgs, jgx = jfn(jnp.asarray(sc[0]), jnp.asarray(x[0]), jnp.asarray(z[0]))
    close(gs10[0], jgs)
    close(torch.func.vmap(fn)(ts, tx, tz)[0][1][0], jgx)


@pytest.mark.parametrize("U", [1, 3, 10])
def test_broadcast_gradient_row_bits(U):
    """``layers.broadcast``: the forward is the broadcast; a user's
    parameter gradient is the bits of ``token_sum`` over its leading dims,
    alone, in a stack of U and of 10, in f32 and cast back for bf16."""
    p = torch.from_numpy(rand(5, 10, 3, 7))
    g = torch.from_numpy(rand(6, 10, 4, 9, 3, 7))

    def loss(pu, gu):
        return L.token_sum(L.broadcast(pu, (4, 9)) * gu)

    fn = torch.func.grad(loss)
    got = torch.func.vmap(fn)(p[:U], g[:U])
    wide = torch.func.vmap(fn)(p, g)
    for u in range(U):
        alone = fn(p[u], g[u])
        assert np.array_equal(bits(got[u]), bits(alone))
        assert np.array_equal(bits(alone), bits(wide[u]))
        assert np.array_equal(bits(alone), bits(L.token_sum(g[u], keep=2)))
    np.testing.assert_allclose(wide.numpy(), g.double().sum((1, 2)).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(L.broadcast(p[0], (4, 9)), p[0].expand(4, 9, 3, 7))
    # bf16: the incoming gradient is bf16 (the cast's backward), summed in
    # f32 and cast back
    half = torch.func.grad(lambda pu: L.token_sum(
        L.broadcast(pu, (4, 9)).float() * g[0]))(p[0].to(torch.bfloat16))
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, L.token_sum(g[0].to(torch.bfloat16).float(),
                                         keep=2).to(torch.bfloat16))


def test_mamba2_layer_gradients_row_bits():
    """``vmap(grad)`` of a Mamba-2 layer's loss (every parameter, the
    chunked scan over two chunks and a padded tail): each user's
    gradients are the same bits at 3 rows as the first 3 of 10."""
    cfg = tiny_cfg()
    jp = jssm.init_mamba2(jax.random.PRNGKey(2), cfg, jnp.float32)
    p1 = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    stack = tree_map(lambda a: a.unsqueeze(0).expand(
        (10,) + tuple(a.shape)).clone(), p1)
    x = torch.from_numpy(0.5 * rand(7, 10, 1, 20, cfg.d_model))
    w = torch.from_numpy(rand(8, 1, 20, cfg.d_model))

    def loss(p, xu):
        y, _ = tssm.apply_mamba2(p, xu, cfg)
        return L.token_sum(y * w)

    fn = torch.func.vmap(torch.func.grad_and_value(loss))
    g3, l3 = fn(tree_map(lambda a: a[:3], stack), x[:3])
    g10, l10 = fn(stack, x)
    assert np.array_equal(bits(l3), bits(l10[:3]))
    for a, b in zip(tree_leaves(g3), tree_leaves(g10)):
        assert np.array_equal(bits(a), bits(b[:3]))
    # the values: user 0 against jax.grad of the reference layer
    jg = jax.grad(lambda p, xu: jnp.sum(jssm.apply_mamba2(p, xu, cfg)[0]
                                        * w.numpy()))(
        jp, jnp.asarray(x[0].numpy()))
    for t, j in zip(tree_leaves(g10), jax.tree.leaves(jg)):
        close(t[0], j)


# ------------------------------------------- row bits at four threads
#: the ops ``layers.per_user`` runs a user a call on the CPU, each at the
#: shape a local step of the reduced archs gives it (4 users: 2 x 16
#: tokens each), and the probe that first showed the fault: ``silu`` over
#: (U, 20128) rows of 4 x a standard normal (numpy seed 0)
PER_USER_OPS = {
    "silu_probe": (lambda x: L.silu(x), [(20128,)], 4.0),
    "silu_conv": (lambda x: L.silu(x), [(2, 16, 544)], 1.0),
    "silu_gate": (lambda x: L.silu(x), [(2, 16, 512)], 1.0),
    "gelu": (lambda x: L._gelu(x), [(2, 16, 512)], 1.0),
    "in_proj": (lambda x, w: L.matmul(x, w),
                [(2, 16, 256), (256, 1072)], 1.0),
}


@pytest.fixture
def four_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("U", [3, 10])
@pytest.mark.parametrize("op", sorted(PER_USER_OPS))
def test_per_user_ops_keep_a_users_bits_at_four_threads(op, U,
                                                        four_threads):
    """At 4 CPU threads, each op of ``PER_USER_OPS`` under ``vmap`` and
    its gradient under ``vmap(grad)``: a user's rows alone are the same
    bits as in a stack of U and of 10 (torch's own kernels split a stack
    past 32768 elements over threads, and a thread's chunk tail takes a
    scalar ``exp`` that can differ in the last bit; MKL's batched GEMM
    orders a 1072-long contraction by the batch count). The values are
    the plain op's."""
    fn, shapes, scale = PER_USER_OPS[op]
    rng = np.random.default_rng(0)
    args = [torch.from_numpy((scale * rng.standard_normal(
        (10,) + s)).astype(np.float32)) for s in shapes]
    w = torch.from_numpy(rng.standard_normal(
        tuple(fn(*(a[0] for a in args)).shape)).astype(np.float32))

    def loss(*a):
        return L.token_sum(fn(*a) * w)

    grad = torch.func.grad(loss, argnums=tuple(range(len(args))))
    outs = {n: torch.func.vmap(fn)(*(a[:n] for a in args)) for n in (U, 10)}
    grads = {n: torch.func.vmap(grad)(*(a[:n] for a in args))
             for n in (U, 10)}
    for u in range(U):
        alone = fn(*(a[u] for a in args))
        assert np.array_equal(bits(outs[U][u]), bits(alone))
        assert np.array_equal(bits(outs[10][u]), bits(alone))
        g = grad(*(a[u] for a in args))
        for i in range(len(args)):
            assert np.array_equal(bits(grads[U][i][u]), bits(g[i]))
            assert np.array_equal(bits(grads[10][i][u]), bits(g[i]))
    plain = {"in_proj": lambda x, w_: x @ w_,
             "gelu": lambda x: torch.nn.functional.gelu(
                 x, approximate="tanh")}.get(op, torch.nn.functional.silu)
    np.testing.assert_allclose(outs[10].numpy(), torch.func.vmap(plain)(
        *args).numpy(), rtol=1e-6, atol=1e-6)


class OpBits(TorchDispatchMode):
    """The CPU twin of ``chip_smoke.py``'s ``row_count_bits`` recorder:
    every aten op's outputs (a digest of their bits, and their shapes),
    recorded or held against a record, each output first cut to the
    recorded extent along the one dimension where the shapes differ
    (lane 0's rows come first). A ``layers.per_user`` call is one op: its
    per-row calls are not recorded (their number follows the stack), its
    stacked output is."""
    SKIP = ("empty", "empty_like", "new_empty", "empty_strided",
            "new_empty_strided")

    def __init__(self, want=None):
        super().__init__()
        self.want, self.got, self.paused = want, [], False

    def record(self, name, outs):
        if self.want is not None:
            outs = [cut_to(t, s) for t, s in
                    zip(outs, self.want[len(self.got)][2])]
        self.got.append((name, [_digest(t) for t in outs],
                         [tuple(t.shape) for t in outs]))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if self.paused or name in self.SKIP or any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in func._schema.returns):
            return out
        self.record(name, [t for t in tree_flatten(out)[0]
                           if isinstance(t, torch.Tensor)])
        return out


def _digest(t):
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()) \
        .hexdigest()


def cut_to(t, shape):
    dims = [d for d in range(t.dim()) if t.shape[d] != shape[d]]
    if not dims:
        return t
    assert len(dims) == 1 and t.shape[dims[0]] % shape[dims[0]] == 0, \
        (tuple(t.shape), shape)
    return t.narrow(dims[0], 0, shape[dims[0]])


@pytest.mark.parametrize("users", [4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_local_step_row_bits_twin_at_four_threads(arch, users, four_threads,
                                                  monkeypatch):
    """The CPU twin of ``chip_smoke.py``'s ``row_count_bits``: one
    ``vmap(grad)`` local step of the reduced arch's ``--arch`` cohort (16
    tokens, batch 2) at U users and at 2 x U (the U rows repeated: a
    2-lane sweep's first step), at 4 threads, aten op by aten op: no
    op's output bits over lane 0's rows may differ, and the gradients
    and losses are the same bits."""
    local_step_row_bits_twin(arch, users, monkeypatch)


def local_step_row_bits_twin(arch, users, monkeypatch, cfg_fields=None):
    """The body of ``test_local_step_row_bits_twin_at_four_threads``, for
    the cell's reduced config with ``cfg_fields`` replaced (the memory
    levers)."""
    from repro_torch.launch import train as ttrain
    argv = ["--arch", arch, "--users", str(users), "--k", "2", "--llm-seq",
            "16", "--llm-seqs-per-user", "4", "--batch-size", "2",
            "--rounds", "1", "--device", "cpu"]
    eng = ttrain.build_llm_engine(ttrain.make_parser().parse_args(argv),
                                  cfg_fields=cfg_fields)
    be = eng.backend
    be._ensure_xstack()
    batch = tree_map(lambda a: a[:, 0], be._fused_batches())
    stack = be._bcast(eng.state)
    wide = [tree_map(lambda x: x.repeat((2,) + (1,) * (x.dim() - 1)), t)
            for t in (stack, batch)]
    grad_fn = torch.func.vmap(torch.func.grad_and_value(be._loss_fn))
    modes = []
    rows = L._rows

    def recorded_rows(info, in_dims, fn, args):
        mode = modes[-1]
        mode.paused = True
        try:
            out = rows(info, in_dims, fn, args)
            mode.record("per_user", [out] if isinstance(out, torch.Tensor)
                        else list(out))
        finally:
            mode.paused = False
        return out
    monkeypatch.setattr(L, "_rows", recorded_rows)
    modes.append(OpBits())
    with modes[-1]:
        g, loss = grad_fn(stack, batch)
    narrow = modes[-1].got
    modes.append(OpBits(narrow))
    with modes[-1]:
        gw, lw = grad_fn(*wide)
    got = modes[-1].got
    assert [n for n, _, _ in got] == [n for n, _, _ in narrow]
    assert sum(n == "per_user" for n, _, _ in narrow) > 0
    differing = [(k, n, s[0]) for k, ((n, a, s), (_, b, _)) in
                 enumerate(zip(narrow, got)) if a != b]
    assert differing == [], differing[:6]
    assert torch.equal(loss, lw[:users])
    for a, b in zip(tree_leaves(g), tree_leaves(gw)):
        assert torch.equal(a, b[:users])


def test_families_run_and_only_audio_raises():
    """The ssm, hybrid and audio families are ported: init at the
    published dims on the meta device has the reference's parameter
    count (whisper-small's 12 encoder and 12 decoder layers: 238.19 M),
    and no family raises. (The name is the one this test had while the
    audio family still raised.)"""
    for arch in ARCHS + ["whisper-small"]:
        cfg = tget(arch)
        params = tm.init_params(torch.device("meta"), cfg)
        assert tm.param_count(params) == jm.param_count(
            jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                  jget(arch))))
        assert [g[:3] for g in tm.layer_groups(cfg)] == \
            [g[:3] for g in jm.layer_groups(jget(arch))]
        if arch in ARCHS:
            assert params["blocks0"]["mamba"]["A_log"].dtype == \
                torch.float32
    assert tm.param_count(tm.init_params(
        torch.device("meta"), tget("whisper-small"))) == 238_187_520
