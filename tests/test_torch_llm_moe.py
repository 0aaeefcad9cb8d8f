"""The MoE family (``models/moe.py``, MLA in ``models/attention.py``, the
moe block, ``first_dense_layers`` and DeepSeek-V3's MTP in
``models/model.py``) against the JAX package, on the CPU, for
deepseek-v3-671b (MLA + MoE + MTP) and kimi-k2-1t-a32b (GQA + MoE) at
their reduced sizes, from the JAX package's own ``init_params`` carried
across with ``convert.params_from_numpy``.

Bars as in ``tests/test_torch_llm_model.py``: logits, losses and decode
logits ``rtol=1e-5, atol=2e-5``; gradients ``atol=1e-5`` relative to
each leaf's largest magnitude; decode against forward within the port
1e-3 absolute. The capacity-drop cases (capacity factor below E, so
assignments fall beyond an expert's capacity) must give the reference's
output too: which assignments are dropped follows the STABLE sort.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import model as jm
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.tree import tree_leaves, tree_map

MOE = ["deepseek-v3-671b", "kimi-k2-1t-a32b"]
TOL = dict(rtol=1e-5, atol=2e-5)
B, S = 2, 12
#: capacity factors below E = 4: 1.0 drops the assignments past an
#: expert's even share, 0.5 half of them
DROP_CF = [1.0, 0.5]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


class Case:
    def __init__(self, arch):
        self.jc, self.tc = jget(arch).reduced(), tget(arch).reduced()
        self.jp = jm.init_params(jax.random.PRNGKey(0), self.jc)
        self.np = jax.tree.map(np.asarray, self.jp)
        self.tp = params_from_numpy(self.np, device="cpu")
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.jc.vocab_size, (B, S + 1)) \
            .astype(np.int32)

    def cfgs(self, **over):
        return (dataclasses.replace(self.jc, **over),
                dataclasses.replace(self.tc, **over))


@pytest.fixture(scope="module")
def cases():
    return {}


def case(cases, arch):
    if arch not in cases:
        cases[arch] = Case(arch)
    return cases[arch]


def _grads_close(tg, jg):
    jleaves = jax.tree.leaves(jg)
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for t, j in zip(tleaves, jleaves):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("arch", MOE)
def test_moe_param_layout_and_leaf_order(arch):
    """The reduced and the full trees: the reference's paths in its leaf
    order (56 / 25 leaves reduced), shapes and dtypes; the router f32
    whatever the param dtype; the MLA cache holds k alone."""
    for full in (True, False):
        jc, tc = jget(arch), tget(arch)
        if not full:
            jc, tc = jc.reduced(), tc.reduced()
        want = list(_paths(jsteps.params_struct(jc)))
        got = list(_paths(tsteps.params_struct(tc)))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, t), (_, j) in zip(got, want):
            assert tuple(t.shape) == tuple(j.shape), path
            assert str(t.dtype).split(".")[1] == str(j.dtype), path
            if path[-1] == "router":
                assert t.dtype == torch.float32
    n = len(tree_leaves(tsteps.params_struct(tget(arch).reduced())))
    assert n == {"deepseek-v3-671b": 56, "kimi-k2-1t-a32b": 25}[arch]
    caches = tm.make_caches(tget(arch).reduced(), 2, 8, device="meta")
    for group in caches.values():
        if tget(arch).attention_type == "mla":
            assert sorted(group["attn"]) == ["k", "pos"]
            assert tuple(group["attn"]["k"].shape[-2:]) == (1, 64 + 16)


def test_router_stays_f32_through_conversion_and_init(cases):
    c = case(cases, "kimi-k2-1t-a32b")
    bf = params_from_numpy(c.np, device="cpu", dtype=torch.bfloat16)
    for path, t in _paths(bf):
        want = torch.float32 if path[-1] == "router" else torch.bfloat16
        assert t.dtype == want, path
    cfg = dataclasses.replace(c.tc, param_dtype="bfloat16")
    p = tm.init_params(0, cfg, device="cpu")
    assert p["blocks1"]["moe"]["router"].dtype == torch.float32
    assert p["blocks1"]["moe"]["w_gate"].dtype == torch.bfloat16
    back = params_to_numpy(c.tp)
    for a, b in zip(jax.tree.leaves(c.np), jax.tree.leaves(back)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("cf", [4.0] + DROP_CF)
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_jax(arch, cf, cases):
    """The MoE FFN alone, its output and aux loss, with nothing dropped
    (cf = E) and with assignments dropped."""
    c = case(cases, arch)
    pj = jax.tree.map(lambda a: a[0], c.jp["blocks1"]["moe"])
    pt = tree_map(lambda a: a[0], c.tp["blocks1"]["moe"])
    x = (np.random.default_rng(2).standard_normal((B, S, c.jc.d_model))
         .astype(np.float32))
    yj, aj = jmoe.apply_moe(pj, jnp.asarray(x), c.jc, capacity_factor=cf)
    yt, at = tmoe.apply_moe(pt, torch.from_numpy(x), c.tc,
                            capacity_factor=cf)
    # the experts' fan-in is E (the reference's init): outputs of ~300
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0,
                               atol=1e-6 * np.abs(yj).max())
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)


@pytest.mark.parametrize("cf", [4.0] + DROP_CF)
def test_apply_moe_gradient_matches_jax(cf, cases):
    """d/d(params, x) of sum(y * w) + aux through dispatch, the experts,
    combine (its gates) and the router, dropped assignments included."""
    c = case(cases, "deepseek-v3-671b")
    pj = jax.tree.map(lambda a: a[0], c.jp["blocks1"]["moe"])
    pt = tree_map(lambda a: a[0], c.tp["blocks1"]["moe"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, c.jc.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, c.jc.d_model)).astype(np.float32)

    def jf(p, x):
        y, aux = jmoe.apply_moe(p, x, c.jc, capacity_factor=cf)
        return jnp.sum(y * w) + aux

    def tf(p, x):
        y, aux = tmoe.apply_moe(p, x, c.tc, capacity_factor=cf)
        return torch.sum(y * torch.from_numpy(w)) + aux

    jg = jax.grad(jf, argnums=(0, 1))(pj, jnp.asarray(x))
    tg = torch.func.grad(tf, argnums=(0, 1))(pt, torch.from_numpy(x))
    _grads_close(tg[0], jg[0])
    np.testing.assert_allclose(tg[1].numpy(), np.asarray(jg[1]), rtol=0,
                               atol=1e-5 * float(np.abs(jg[1]).max()))


@pytest.mark.parametrize("q_lora", [True, False])
def test_apply_mla_matches_jax_with_and_without_cache(q_lora, cases):
    """MLA alone: the absorbed attention over new tokens, then one token
    through the latent cache (k only, (B, L, 1, R + Dr)); the full-rank
    query projection too (``q_lora_rank = 0``)."""
    c = case(cases, "deepseek-v3-671b")
    jc, tc = c.cfgs() if q_lora else c.cfgs(q_lora_rank=0)
    key = jax.random.PRNGKey(4)
    pj = jattn.init_mla(key, jc, jnp.float32)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    x = (np.random.default_rng(4).standard_normal((B, 6, jc.d_model)) * 0.5
         ).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)
    yj, _ = jattn.apply_mla(pj, jnp.asarray(x), cfg=jc,
                            positions=jnp.asarray(pos))
    yt, _ = tattn.apply_mla(pt, torch.from_numpy(x), cfg=tc,
                            positions=torch.from_numpy(pos))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    cj = jattn.make_kv_cache(jc, B, 8, jnp.float32)
    ct = tattn.make_kv_cache(tc, B, 8, torch.float32)
    assert set(ct) == set(cj) == {"k", "pos"}
    for i in range(3):
        yj, cj = jattn.apply_mla(pj, jnp.asarray(x[:, i:i + 1]), cfg=jc,
                                 positions=jnp.asarray(pos[i:i + 1]),
                                 cache=cj)
        yt, ct = tattn.apply_mla(pt, torch.from_numpy(x[:, i:i + 1]), cfg=tc,
                                 positions=torch.from_numpy(pos[i:i + 1]),
                                 cache=ct)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(ct["k"].numpy(), np.asarray(cj["k"]), **TOL)
    assert np.array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


@pytest.mark.parametrize("cf", DROP_CF)
@pytest.mark.parametrize("arch", MOE)
def test_capacity_drop_matches_jax(arch, cf, cases):
    """The whole model with assignments dropped: logits, aux and the
    loss equal the reference's (the stable sort picks the same drops)."""
    c = case(cases, arch)
    jc, tc = c.cfgs(moe_capacity_factor=cf)
    toks = c.tokens[:, :-1]
    want, _, jaux = jm.forward(c.jp, jnp.asarray(toks), jc)
    got, _, taux = tm.forward(c.tp, torch.from_numpy(toks), tc)
    full, _, _ = tm.forward(c.tp, torch.from_numpy(toks), c.tc)
    assert not torch.allclose(got, full, rtol=1e-3, atol=1e-3)  # dropped
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jl = jm.compute_loss(c.jp, {"tokens": jnp.asarray(c.tokens)}, jc)
    tl = tm.compute_loss(c.tp, {"tokens": torch.from_numpy(c.tokens)}, tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_mtp_loss_term_matches_jax(cases):
    """DeepSeek-V3's multi-token-prediction term alone, and its weight
    in ``compute_loss`` (loss without MTP + 0.3 x the term)."""
    c = case(cases, "deepseek-v3-671b")
    toks = c.tokens
    inputs, labels = toks[:, :-1], toks[:, 1:]
    want = jm._mtp_loss(c.jp, jnp.asarray(inputs), jnp.asarray(labels),
                        c.jc, 1024)
    got = tm._mtp_loss(c.tp, torch.from_numpy(inputs),
                       torch.from_numpy(labels), c.tc, 1024)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    jc, tc = c.cfgs(use_mtp=False)
    plain = tm.compute_loss(c.tp, {"tokens": torch.from_numpy(toks)}, tc)
    total = tm.compute_loss(c.tp, {"tokens": torch.from_numpy(toks)}, c.tc)
    np.testing.assert_allclose(float(total),
                               float(plain) + tm.MTP_WEIGHT * float(got),
                               rtol=1e-6)
    assert "mtp" not in tm.init_params(torch.device("meta"), tc)


@pytest.mark.parametrize("cf", [4.0, 1.0])
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_gradient_match_jax_with_aux_and_mtp(arch, cf, cases):
    c = case(cases, arch)
    jc, tc = c.cfgs(moe_capacity_factor=cf)
    jb = {"tokens": jnp.asarray(c.tokens)}
    tb = {"tokens": torch.from_numpy(c.tokens)}
    jl, jg = jax.value_and_grad(jm.compute_loss)(c.jp, jb, jc)
    tg, tl = torch.func.grad_and_value(tm.compute_loss)(c.tp, tb, tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    _grads_close(tg, jg)


@pytest.mark.parametrize("arch", MOE)
def test_decode_at_the_widened_capacity_matches_forward(arch, cases):
    """A cache widens the capacity factor to max(cf, 4) (prefill
    included), as the reference's block does: at cf = 1 a decode step of
    2 tokens keeps every assignment, so decode = forward at cf = 4."""
    c = case(cases, arch)
    jc, tc = c.cfgs(moe_capacity_factor=1.0)
    toks = c.tokens[:, :8]
    full, _, _ = tm.forward(c.tp, torch.from_numpy(toks), c.tc)
    ct = tm.make_caches(tc, B, 16, device="cpu")
    cj = jm.make_caches(jc, B, 16)
    for i in range(toks.shape[1]):
        lt, ct = tm.decode_step(c.tp, ct, torch.from_numpy(toks[:, i]), i,
                                tc)
        lj, cj = jm.decode_step(c.jp, cj, jnp.asarray(toks[:, i]),
                                jnp.int32(i), jc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        assert float((lt - full[:, i]).abs().max()) < 1e-3


def test_cohort_loss_runs_under_vmap_grad(cases):
    """The --arch local step of deepseek (MLA, MoE, MTP): ``vmap(grad)``
    over a (U, ...) cohort equals each user's own gradient (the
    dispatch / combine Functions, the integer counts and the token sums
    run under ``vmap``; the unbatched GEMMs round their own way, hence
    the tolerance)."""
    c = case(cases, "deepseek-v3-671b")
    U = 3
    stack = tree_map(lambda p: p.unsqueeze(0).expand((U,) + p.shape)
                     .clone(), c.tp)
    toks = np.random.default_rng(5).integers(
        0, c.jc.vocab_size, (U, B, S + 1)).astype(np.int32)
    fn = torch.func.grad_and_value(
        lambda p, b: tm.compute_loss(p, b, c.tc))
    g, loss = torch.func.vmap(fn)(stack, {"tokens": torch.from_numpy(toks)})
    for u in range(U):
        gu, lu = fn(c.tp, {"tokens": torch.from_numpy(toks[u])})
        np.testing.assert_allclose(float(loss[u]), float(lu), rtol=1e-6)
        for a, b in zip(tree_leaves(g), tree_leaves(gu)):
            np.testing.assert_allclose(a[u].numpy(), b.numpy(), rtol=0,
                                       atol=1e-6 * float(b.abs().max()))
