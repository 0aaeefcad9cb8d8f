"""The port's LLM model (``repro_torch.models.model``, ``launch/steps.py``)
against the JAX package's, on the CPU, for the dense, vlm, moe, ssm,
hybrid and audio archs at their reduced sizes (2 layers, d_model 256,
f32; the MoE archs' 4 experts at capacity factor 4: nothing dropped; the
SSM and hybrid archs over 40 tokens, a 32-token chunk and a padded tail;
whisper over 64 stub frames). The SSM and hybrid archs' decode and
layers are held in ``tests/test_torch_llm_ssm.py``, whisper's in
``tests/test_torch_llm_audio.py``.

Params are the JAX package's own ``init_params`` draws, moved to numpy
and carried across with ``convert.params_from_numpy`` (the port keeps
the reference's layer-stacked layout and leaf order). Bars, f32:
logits, losses and decode logits ``rtol=1e-5, atol=2e-5`` (logits of
order 10 summed over 256-wide rows in another order); gradients
``atol=1e-5`` relative to each leaf's largest magnitude (XLA and torch
order the backward's reductions differently). Within the port, decode
against forward is held at the reference's own bar
(``tests/test_decode_parity.py``: 1e-3 absolute).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import INPUT_SHAPES as JS
from repro.configs.registry import get_config as jget
from repro.launch import steps as jsteps
from repro.models import model as jm
from repro_torch.configs.base import INPUT_SHAPES as TS
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tm
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ["yi-9b", "gemma2-27b", "phi3-mini-3.8b", "phi4-mini-3.8b",
         "phi-3-vision-4.2b", "deepseek-v3-671b", "kimi-k2-1t-a32b",
         "mamba2-370m", "hymba-1.5b", "whisper-small"]
TOL = dict(rtol=1e-5, atol=2e-5)
B, S = 2, 12
#: the SSM and hybrid archs' sequence: past one 32-token SSD chunk
SSM_S = 40
#: gradient leaves held at ``TOL`` and not at 1e-5 of their largest
#: magnitude: the Mamba-2 decay's gradient is a sum that cancels, where
#: XLA's and torch's orders of the backward's reductions part by more
#: than that (up to 3.2e-5 of it)
GRAD_TOL_LEAVES = ("A_log",)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


class Case:
    """One arch's reduced config in both packages, the JAX params and
    their port copy, and a batch of tokens (and vlm patches, or audio
    frames)."""

    def __init__(self, arch):
        self.jc, self.tc = jget(arch).reduced(), tget(arch).reduced()
        self.jp = jm.init_params(jax.random.PRNGKey(0), self.jc)
        self.np = jax.tree.map(np.asarray, self.jp)
        self.tp = params_from_numpy(self.np, device="cpu")
        rng = np.random.default_rng(1)
        n = SSM_S if self.jc.family in ("ssm", "hybrid") else S
        self.tokens = rng.integers(0, self.jc.vocab_size, (B, n + 1)) \
            .astype(np.int32)
        self.patches = None
        if self.jc.family == "vlm":
            self.patches = (0.02 * rng.standard_normal(
                (B, self.jc.num_prefix_tokens, self.jc.d_model))) \
                .astype(np.float32)
        self.frames = None
        if self.jc.family == "audio":
            self.frames = (0.02 * rng.standard_normal(
                (B, self.jc.encoder_seq, self.jc.d_model))) \
                .astype(np.float32)

    def batches(self):
        jb = {"tokens": jnp.asarray(self.tokens)}
        tb = {"tokens": torch.from_numpy(self.tokens)}
        if self.patches is not None:
            jb["patches"] = jnp.asarray(self.patches)
            tb["patches"] = torch.from_numpy(self.patches)
        if self.frames is not None:
            jb["frames"] = jnp.asarray(self.frames)
            tb["frames"] = torch.from_numpy(self.frames)
        return jb, tb

    def enc_frames(self):
        if self.frames is None:
            return None, None
        return jnp.asarray(self.frames), torch.from_numpy(self.frames)

    def prefix(self):
        if self.patches is None:
            return None, None
        return jnp.asarray(self.patches), torch.from_numpy(self.patches)


@pytest.fixture(scope="module")
def cases():
    return {}


def case(cases, arch):
    if arch not in cases:
        cases[arch] = Case(arch)
    return cases[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_layout_matches_jax_at_full_and_reduced_dims(arch):
    """The port's param tree (meta device: no allocation) has the
    reference's paths, shapes and dtypes, leaf for leaf, at the
    published dims and reduced; so do the decode caches."""
    for full in (True, False):
        jc, tc = jget(arch), tget(arch)
        if not full:
            jc, tc = jc.reduced(), tc.reduced()
        want = list(_paths(jsteps.params_struct(jc)))
        got = list(_paths(tsteps.params_struct(tc)))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, t), (_, j) in zip(got, want):
            assert t.is_meta and tuple(t.shape) == tuple(j.shape)
            assert str(t.dtype).split(".")[1] == str(j.dtype)
        for bounded in (False, True):
            cw = list(_paths(jsteps.caches_struct(jc, JS["decode_32k"],
                                                  bounded=bounded)))
            ct = list(_paths(tsteps.caches_struct(tc, TS["decode_32k"],
                                                  bounded=bounded)))
            assert [(p, tuple(t.shape)) for p, t in ct] == \
                [(p, tuple(j.shape)) for p, j in cw]
    assert tm.param_count(tm.init_params(torch.device("meta"), tget(arch))) \
        == jm.param_count(jsteps.params_struct(jget(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, cases):
    c = case(cases, arch)
    pj, pt = c.prefix()
    fj, ft = c.enc_frames()
    toks = c.tokens[:, :-1]
    want, _, jaux = jm.forward(c.jp, jnp.asarray(toks), c.jc,
                               prefix_embeds=pj, enc_frames=fj)
    got, _, aux = tm.forward(c.tp, torch.from_numpy(toks), c.tc,
                             prefix_embeds=pt, enc_frames=ft)
    assert got.shape == want.shape
    # the router's load-balance loss (0 without a MoE block)
    assert (float(aux) == 0.0) == (c.jc.family != "moe")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_jax(arch, cases):
    c = case(cases, arch)
    jb, tb = c.batches()
    jl, jg = jax.value_and_grad(jm.compute_loss)(c.jp, jb, c.jc)
    tg, tl = torch.func.grad_and_value(tm.compute_loss)(c.tp, tb, c.tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    jleaves = list(_paths(jax.tree.map(np.asarray, jg)))
    tleaves = list(_paths(tg))
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        tol = TOL if path[-1] in GRAD_TOL_LEAVES else dict(
            rtol=0, atol=1e-5 * np.abs(j).max())
        np.testing.assert_allclose(t.numpy(), j, **tol)


def test_chunked_loss_equals_the_plain_loss():
    """``loss_vocab_chunks > 1`` gives the plain loss (and JAX's)."""
    c = Case("yi-9b")
    jc = dataclasses.replace(c.jc, loss_vocab_chunks=4)
    tc = dataclasses.replace(c.tc, loss_vocab_chunks=4)
    jb, tb = c.batches()
    want = float(jm.compute_loss(c.jp, jb, jc))
    got = float(tm.compute_loss(c.tp, tb, tc))
    plain = float(tm.compute_loss(c.tp, tb, c.tc))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, plain, rtol=1e-6)


def test_cohort_loss_runs_under_vmap_grad(cases):
    """The --arch local step: ``vmap(grad_and_value(compute_loss))`` over
    a (U, ...) cohort equals each user's own gradient."""
    c = case(cases, "gemma2-27b")
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


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-27b", "deepseek-v3-671b",
                                  "kimi-k2-1t-a32b"])
def test_decode_matches_forward_and_jax(arch, cases):
    """Incremental decode with the KV cache reproduces the full forward
    (``tests/test_decode_parity.py``'s check), and JAX's decode."""
    c = case(cases, arch)
    toks = c.tokens[:, :10]
    full, _, _ = tm.forward(c.tp, torch.from_numpy(toks), c.tc)
    ct = tm.make_caches(c.tc, B, 32, device="cpu")
    cj = jm.make_caches(c.jc, B, 32)
    errs = []
    for i in range(toks.shape[1]):
        lt, ct = tm.decode_step(c.tp, ct, torch.from_numpy(toks[:, i]), i,
                                c.tc)
        lj, cj = jm.decode_step(c.jp, cj, jnp.asarray(toks[:, i]),
                                jnp.int32(i), c.jc)
        errs.append(float((lt - full[:, i]).abs().max()))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert max(errs) < 1e-3, errs


@pytest.mark.parametrize("arch", ["yi-9b", "gemma2-27b", "deepseek-v3-671b",
                                  "kimi-k2-1t-a32b"])
def test_prefill_then_decode_matches_forward(arch, cases):
    c = case(cases, arch)
    toks = torch.from_numpy(c.tokens[:, :12])
    full, _, _ = tm.forward(c.tp, toks, c.tc)
    split = 8
    caches = tm.make_caches(c.tc, B, 32, device="cpu")
    group = sorted(caches)[-1]
    kept = {k: v.clone() for k, v in caches[group]["attn"].items()}
    pre, caches, _ = tm.forward(c.tp, toks[:, :split], c.tc, caches=caches)
    np.testing.assert_allclose(pre.numpy(), full[:, :split].numpy(),
                               rtol=2e-3, atol=2e-3)
    for i in range(split, 12):
        logits, caches = tm.decode_step(c.tp, caches, toks[:, i], i, c.tc)
        np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(),
                                   rtol=2e-3, atol=2e-3)
    # the prefill left the caller's (empty) caches as they were
    fresh = tm.make_caches(c.tc, B, 32, device="cpu")[group]["attn"]
    for k, v in kept.items():
        assert torch.equal(v, fresh[k])


def test_ring_cache_sliding_window_decode(cases):
    """A window-sized ring cache gives the same logits as a full cache
    for a sliding-window model (the bounded-state long_500k mechanism)."""
    c = case(cases, "yi-9b")
    cfg = dataclasses.replace(c.tc, sliding_window=8,
                              local_global_pattern=())
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 20)).astype(np.int32))
    big = tm.make_caches(cfg, 1, 20, device="cpu")
    ring = tm.make_caches(cfg, 1, 8, device="cpu")
    for i in range(20):
        lb, big = tm.decode_step(c.tp, big, toks[:, i], i, cfg)
        lr, ring = tm.decode_step(c.tp, ring, toks[:, i], i, cfg)
        np.testing.assert_allclose(lr.numpy(), lb.numpy(), rtol=2e-3,
                                   atol=2e-3)


def test_steps_match_jax(cases):
    """``make_train_step`` (one SGD step through the fused step's plain
    version), ``make_prefill_step`` and ``make_serve_step`` against
    JAX's, and the shape helpers."""
    c = case(cases, "yi-9b")
    jb, tb = c.batches()
    jl, jnew = jsteps.make_train_step(c.jc, lr=0.1)(c.jp, jb)
    tl, tnew = tsteps.make_train_step(c.tc, lr=0.1)(c.tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for t, j in zip(tree_leaves(tnew), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    for t, o in zip(tree_leaves(c.tp), jax.tree.leaves(c.np)):
        assert np.array_equal(t.numpy(), o)          # the input is kept
    toks = c.tokens[:, :8]
    cj = jm.make_caches(c.jc, B, 16)
    ct = tm.make_caches(c.tc, B, 16, device="cpu")
    lj, cj = jsteps.make_prefill_step(c.jc)(c.jp, cj,
                                            {"tokens": jnp.asarray(toks)})
    lt, ct = tsteps.make_prefill_step(c.tc)(c.tp, ct,
                                            {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    nxt = c.tokens[:, 8]
    lj, _ = jsteps.make_serve_step(c.jc)(c.jp, cj, jnp.asarray(nxt),
                                         jnp.int32(8))
    lt, _ = tsteps.make_serve_step(c.tc)(c.tp, ct, torch.from_numpy(nxt), 8)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for arch in ("yi-9b", "phi-3-vision-4.2b"):
        for name in JS:
            jc, tc = jget(arch), tget(arch)
            assert tsteps.text_len(tc, TS[name]) == \
                jsteps.text_len(jc, JS[name])
            want = jsteps.input_specs(jc, JS[name])
            got = tsteps.input_specs(tc, TS[name])
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert got[k].is_meta


def test_init_params_from_a_seed_is_device_independent_in_distribution():
    """The port's own init: one seed gives the same params on every call
    (a CPU generator), the reference's zero norms, and truncated draws
    scaled by the fan-in."""
    cfg = tget("yi-9b").reduced()
    a = tm.init_params(0, cfg, device="cpu")
    b = tm.init_params(0, cfg, device="cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert not a["final_norm"]["scale"].any()
    wq = a["blocks0"]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-7
    emb = a["embed"]["embedding"]
    assert float(emb.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-7


def test_unported_families_raise():
    """Every family of the reference is ported; a family neither package
    knows raises the reference's ``ValueError`` in both. (The name is
    the one this test had while a family was still unported.)"""
    cfg = dataclasses.replace(tget("yi-9b").reduced(), family="speech")
    with pytest.raises(ValueError, match="speech"):
        jm.layer_groups(dataclasses.replace(jget("yi-9b").reduced(),
                                            family="speech"))
    with pytest.raises(ValueError, match="speech"):
        tm.init_params(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="speech"):
        tm.make_caches(cfg, 1, 4, device="cpu")


@pytest.mark.parametrize("lever,value", [("flash_chunk_remat", True),
                                         ("shard_activations", ("data",))])
def test_unported_levers_raise(lever, value, cases):
    """``shard_activations`` (a mesh's sharding constraint) raises in
    every entry point. ``flash_chunk_remat`` is ported (it raised while
    it was not; the name is kept): it builds and runs, with ``forward``'s
    values unchanged (its bits through a gradient step are held in
    ``tests/test_torch_llm_remat.py``)."""
    c = case(cases, "yi-9b")
    cfg = dataclasses.replace(c.tc, **{lever: value})
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    if lever == "flash_chunk_remat":
        assert torch.equal(tm.forward(c.tp, tokens, cfg, chunk=2)[0],
                           tm.forward(c.tp, tokens, c.tc, chunk=2)[0])
        tm.init_params(0, cfg, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=lever):
        tm.forward(c.tp, tokens, cfg)
    with pytest.raises(NotImplementedError, match=lever):
        tm.init_params(0, cfg, device="cpu")


def test_unported_blocks_and_frontends_raise():
    """Every block type and frontend is ported: the audio blocks build
    the reference's leaves and shapes (the encoder block's are the dense
    block's; the cross block adds ``ln_x`` and ``xattn``), their caches
    (a cross cache of ``enc_len`` entries), and the frame and patch
    embeddings draw 0.02 x a standard normal of their spec's shape; an
    unknown block type raises. (The name is the one this test had while
    the audio blocks still raised.)"""
    from repro.models import blocks as jblocks
    from repro_torch.models import blocks, frontends
    cfg, jc = tget("whisper-small").reduced(), jget("whisper-small").reduced()
    for btype in ("encoder", "cross"):
        got = dict(_paths(blocks.init_block(torch.device("meta"), cfg, btype,
                                            torch.float32, lead=(2,))))
        want = dict(_paths(jax.eval_shape(lambda: jax.vmap(
            lambda k: jblocks.init_block(k, jc, btype, jnp.float32))(
                jax.random.split(jax.random.PRNGKey(0), 2)))))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), k
        cache = blocks.make_block_cache(cfg, btype, 3, 8, torch.float32,
                                        device="meta", enc_len=5)
        jcache = jblocks.make_block_cache(jc, btype, 3, 8, jnp.float32,
                                          enc_len=5)
        assert {k: tuple(v.shape) for k, v in _paths(cache)} == \
            {k: tuple(v.shape) for k, v in _paths(jcache)}
    with pytest.raises(ValueError, match="unknown block"):
        blocks.init_block(torch.Generator(), cfg, "conformer", torch.float32)
    shape, dtype = frontends.audio_frame_spec(3, cfg)
    assert shape == (3, 64, 256) and dtype == torch.float32
    x = frontends.audio_frame_embeddings(torch.Generator().manual_seed(0),
                                         3, cfg)
    assert x.shape == shape and abs(float(x.std()) - 0.02) < 0.002
    vlm = tget("phi-3-vision-4.2b").reduced()
    shape, dtype = frontends.vision_patch_spec(3, vlm)
    assert shape == (3, 16, 256) and dtype == torch.float32
    x = frontends.vision_patch_embeddings(torch.Generator().manual_seed(0),
                                          3, vlm)
    assert x.shape == shape and abs(float(x.std()) - 0.02) < 0.002
