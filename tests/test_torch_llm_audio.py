"""The port's audio family (whisper-small, arXiv:2212.04356: the
``"encoder"`` and ``"cross"`` blocks, ``encode_audio``, the audio
frontends and serving) against the JAX package's, on the CPU.

The same numpy inputs, and the JAX package's own parameter draws carried
across with ``convert.params_from_numpy``, go to both sides. Bar, f32:
``TOL`` (rtol 1e-5, atol 2e-5); gradients 1e-5 of each leaf's largest
magnitude (XLA and torch order the backward's reductions differently).

The reference's ``decode_step`` adds sinusoidal positions whose sin and
cos halves are concatenated (``layers.sinusoidal_positions_dynamic``),
where ``forward`` and the encoder interleave them; its decode therefore
misses its own ``forward`` (ROADMAP, reference faults). The port keeps
both tables as they are: its prefill is held to ``forward``, and its
decode steps to the reference's ``decode_step``, step by step.

The LayerNorm scale and bias gradients' row bits (a user alone = in a
stack of 3 and of 10) are held in ``tests/test_torch_token_sum.py``
(``test_norm_scale_gradient_row_bits_do_not_follow_the_row_count``).

The reference's federated round has no audio frames (its
``build_llm_engine`` gives each user tokens only), so ``--arch
whisper-small`` fails there on its first loss; the port's launcher
refuses it up front.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.configs.base import INPUT_SHAPES as JS
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import model as jm
from repro_torch.configs.base import INPUT_SHAPES as TS
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as L
from repro_torch.models import model as tm
from repro_torch.tree import tree_leaves

ARCH = "whisper-small"
TOL = dict(rtol=1e-5, atol=2e-5)
B, S = 2, 12
#: an encoder length with a chunk tail: 50 frames in chunks of 16
TAIL = dict(encoder_seq=50, chunk=16)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


class Case:
    """The reduced whisper in both packages (``encoder_seq`` as given),
    the JAX params and their port copy, tokens and stub frames."""

    def __init__(self, **over):
        self.jc = dataclasses.replace(jget(ARCH).reduced(), **over)
        self.tc = dataclasses.replace(tget(ARCH).reduced(), **over)
        self.jp = jm.init_params(jax.random.PRNGKey(0), self.jc)
        # the zero-initialised norm scales and biases made non-zero, so
        # that they count
        self.jp = jax.tree.map(lambda a: a + 0.05 * jnp.sin(jnp.arange(
            a.size, dtype=jnp.float32).reshape(a.shape)), self.jp)
        self.tp = params_from_numpy(jax.tree.map(np.asarray, self.jp),
                                    device="cpu")
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.jc.vocab_size, (B, S + 1)) \
            .astype(np.int32)
        self.frames = 0.5 * rand(2, B, self.jc.encoder_seq, self.jc.d_model)

    def batches(self):
        return ({"tokens": jnp.asarray(self.tokens),
                 "frames": jnp.asarray(self.frames)},
                {"tokens": torch.from_numpy(self.tokens),
                 "frames": torch.from_numpy(self.frames)})


@pytest.fixture(scope="module")
def case():
    return Case()


@pytest.fixture(scope="module")
def tail():
    return Case(encoder_seq=TAIL["encoder_seq"])


# ------------------------------------------------------------ the blocks
def block_params(block_type):
    jc, tc = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = jblocks.init_block(jax.random.PRNGKey(3), jc, block_type,
                            jnp.float32)
    jp = jax.tree.map(lambda a: a + 0.05 * jnp.sin(
        jnp.arange(a.size, dtype=jnp.float32).reshape(a.shape)), jp)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu")


def test_encoder_block_matches_jax():
    """The encoder block: bidirectional attention (a query sees later
    positions), LayerNorm with bias, the GELU MLP; no cache."""
    jc, tc, jp, tp = block_params("encoder")
    x = 0.5 * rand(4, B, 20, jc.d_model)
    pos = np.arange(20, dtype=np.int32)
    want, _, _ = jblocks.apply_block(
        jp, jnp.asarray(x), cfg=jc, block_type="encoder",
        positions=jnp.asarray(pos), window=jnp.int32(0), chunk=8)
    got, none, aux = tblocks.apply_block(
        tp, torch.from_numpy(x), cfg=tc, block_type="encoder",
        positions=torch.from_numpy(pos), window=0, chunk=8)
    close(got, want)
    assert none is None and float(aux) == 0.0
    # bidirectional: the first position's output follows the last input
    x2 = x.copy()
    x2[:, -1] = 2.0 * rand(7, B, jc.d_model)
    moved, _, _ = tblocks.apply_block(
        tp, torch.from_numpy(x2), cfg=tc, block_type="encoder",
        positions=torch.from_numpy(pos), window=0, chunk=8)
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-4
    assert tblocks.make_block_cache(tc, "encoder", B, 8, torch.float32,
                                    device="cpu") == {}


def test_cross_block_matches_jax():
    """The cross block as the decoder runs it: the whole sequence with
    ``enc_out``, a prefill writing the self and cross caches, then two
    decode steps reading the cross keys from the cache alone."""
    jc, tc, jp, tp = block_params("cross")
    T = 24
    x = 0.5 * rand(5, B, 10, jc.d_model)
    enc = 0.5 * rand(6, B, T, jc.d_model)
    pos = np.arange(10, dtype=np.int32)

    def jrun(xs, p0, cache, e):
        return jblocks.apply_block(
            jp, jnp.asarray(xs), cfg=jc, block_type="cross",
            positions=jnp.asarray(pos[p0:p0 + xs.shape[1]]),
            window=jnp.int32(0), cache=cache,
            enc_out=None if e is None else jnp.asarray(e))

    def trun(xs, p0, cache, e):
        return tblocks.apply_block(
            tp, torch.from_numpy(xs), cfg=tc, block_type="cross",
            positions=torch.from_numpy(pos[p0:p0 + xs.shape[1]]),
            window=0, cache=cache,
            enc_out=None if e is None else torch.from_numpy(e))

    want, _, _ = jrun(x, 0, None, enc)
    got, _, _ = trun(x, 0, None, enc)
    close(got, want)
    jcache = jblocks.make_block_cache(jc, "cross", B, 16, jnp.float32,
                                      enc_len=T)
    tcache = tblocks.make_block_cache(tc, "cross", B, 16, torch.float32,
                                      device="cpu", enc_len=T)
    assert sorted(tcache) == sorted(jcache) == ["attn", "cross_k",
                                                "cross_v"]
    assert tuple(tcache["cross_k"].shape) == (B, T, tc.num_kv_heads,
                                              tc.resolved_head_dim)
    want, jcache, _ = jrun(x[:, :8], 0, jcache, enc)
    got, tcache, _ = trun(x[:, :8], 0, tcache, enc)
    close(got, want)
    close(tcache["cross_k"], jcache["cross_k"])
    kept = tcache["cross_v"].clone()
    for t in (8, 9):
        want, jcache, _ = jrun(x[:, t:t + 1], t, jcache, None)
        got, tcache, _ = trun(x[:, t:t + 1], t, tcache, None)
        close(got, want)
    # the prefill wrote the cross cache; decode reads it and never again
    assert torch.equal(tcache["cross_v"], kept)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("chunk", [TAIL["chunk"], 1024])
def test_encode_audio_with_a_chunk_tail_matches_jax(tail, chunk):
    """``encode_audio`` over 50 frames: in chunks of 16 the last kv chunk
    holds 2 frames and 14 masked pads; in one chunk none."""
    c = tail
    want = jm.encode_audio(c.jp, jnp.asarray(c.frames), c.jc, chunk=chunk)
    got = tm.encode_audio(c.tp, torch.from_numpy(c.frames), c.tc,
                          chunk=chunk)
    assert got.shape == (B, TAIL["encoder_seq"], c.jc.d_model)
    close(got, want)


def test_loss_and_gradients_with_a_chunk_tail_match_jax(tail):
    """``compute_loss`` with ``batch["frames"]`` over 50 frames in
    chunks of 16, and every gradient (the encoder's through the tail
    chunk's mask) against ``jax.grad``."""
    c = tail
    jb, tb = c.batches()
    ch = TAIL["chunk"]
    jl, jg = jax.value_and_grad(
        lambda p: jm.compute_loss(p, jb, c.jc, chunk=ch))(c.jp)
    tg, tl = torch.func.grad_and_value(
        lambda p: tm.compute_loss(p, tb, c.tc, chunk=ch))(c.tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    jleaves = jax.tree.leaves(jax.tree.map(np.asarray, jg))
    tleaves = tree_leaves(tg)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max())
    assert any(float(g.abs().max()) > 0 for g in tree_leaves(tg["encoder"]))


def test_prefill_equals_forward(case):
    """``launch.serve.generate``'s prefill over frames and a prompt: its
    logits equal ``forward``'s at the prompt's last position, and the
    cross caches hold the encoder's keys (one entry a frame)."""
    c = case
    toks, frames = torch.from_numpy(c.tokens[:, :8]), \
        torch.from_numpy(c.frames)
    res = tserve.generate(c.tp, c.tc, toks, 4, enc_frames=frames)
    full, _, _ = tm.forward(c.tp, toks, c.tc, enc_frames=frames)
    close(res["prefill_logits"], full[:, -1].numpy())
    caches = tm.make_caches(c.tc, B, 12, enc_len=frames.shape[1],
                            device="cpu")
    _, caches, _ = tm.forward(c.tp, toks, c.tc, caches=caches,
                              enc_frames=frames)
    enc = tm.encode_audio(c.tp, frames, c.tc)
    ck = torch.einsum("btd,dhk->bthk", enc,
                      c.tp["blocks0"]["xattn"]["wk"][1])
    close(caches["blocks0"]["cross_k"][1], ck.numpy())


def test_decode_matches_the_reference_decode_step(case):
    """A prefill of 6 tokens, then a decode step a token to the 12th:
    every step's logits against the reference's ``decode_step`` at TOL.
    Both miss their own ``forward`` by the same table fault (the
    concatenated positions): a gap far above 1e-3, equal in both."""
    c = case
    P = 6
    fj = jnp.asarray(c.frames)
    ft = torch.from_numpy(c.frames)
    cj = jm.make_caches(c.jc, B, S)
    ct = tm.make_caches(c.tc, B, S, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(ct)] == \
        [tuple(j.shape) for j in jax.tree.leaves(cj)]
    lj, cj, _ = jm.forward(c.jp, jnp.asarray(c.tokens[:, :P]), c.jc,
                           caches=cj, enc_frames=fj)
    lt, ct, _ = tm.forward(c.tp, torch.from_numpy(c.tokens[:, :P]), c.tc,
                           caches=ct, enc_frames=ft)
    close(lt, lj)
    jfull, _, _ = jm.forward(c.jp, jnp.asarray(c.tokens[:, :S]), c.jc,
                             enc_frames=fj)
    tfull, _, _ = tm.forward(c.tp, torch.from_numpy(c.tokens[:, :S]), c.tc,
                             enc_frames=ft)
    for i in range(P, S):
        lj, cj = jm.decode_step(c.jp, cj, jnp.asarray(c.tokens[:, i]),
                                jnp.int32(i), c.jc)
        lt, ct = tm.decode_step(c.tp, ct, torch.from_numpy(c.tokens[:, i]),
                                i, c.tc)
        close(lt, lj)
        jgap = float(jnp.abs(lj - jfull[:, i]).max())
        tgap = float((lt - tfull[:, i]).abs().max())
        assert jgap > 0.01 and abs(tgap - jgap) <= 1e-4 * jgap + 2e-5


def test_position_tables_match_the_reference():
    """The two tables as the reference has them: interleaved sin / cos
    for ``forward`` (with an offset), the concatenated halves for
    decode: the same angles in another order."""
    D = 16
    close(L.sinusoidal_positions(7, D, offset=3),
          jlayers.sinusoidal_positions(7, D, 3))
    pos = np.array([0, 5, 1499], dtype=np.int32)
    dyn = L.sinusoidal_positions_dynamic(torch.from_numpy(pos), D)
    close(dyn, jlayers.sinusoidal_positions_dynamic(jnp.asarray(pos), D))
    table = L.sinusoidal_positions(1500, D)[pos]
    np.testing.assert_allclose(dyn[:, :D // 2].numpy(),
                               table[:, 0::2].numpy(), atol=1e-4)
    np.testing.assert_allclose(dyn[:, D // 2:].numpy(),
                               table[:, 1::2].numpy(), atol=1e-4)
    assert not np.allclose(dyn.numpy(), table.numpy(), atol=1e-2)


def test_train_step_with_frames_matches_jax(case):
    """``make_train_step`` on a batch with ``frames`` (one SGD step
    through the fused step's plain version) and ``make_prefill_step``
    with frames, against JAX's; the input specs carry the frames."""
    c = case
    jb, tb = c.batches()
    jl, jnew = jsteps.make_train_step(c.jc, lr=0.1)(c.jp, jb)
    tl, tnew = tsteps.make_train_step(c.tc, lr=0.1)(c.tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for t, j in zip(tree_leaves(tnew), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    cj = jm.make_caches(c.jc, B, 16)
    ct = tm.make_caches(c.tc, B, 16, device="cpu")
    pj, _ = jsteps.make_prefill_step(c.jc)(
        c.jp, cj, {"tokens": jb["tokens"][:, :8], "frames": jb["frames"]})
    pt, _ = tsteps.make_prefill_step(c.tc)(
        c.tp, ct, {"tokens": tb["tokens"][:, :8], "frames": tb["frames"]})
    close(pt, pj)
    for name in JS:
        want = jsteps.input_specs(jget(ARCH), JS[name])
        got = tsteps.input_specs(tget(ARCH), TS[name])
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (name, k)


def test_arch_whisper_small_round_raises_in_both_packages():
    """The reference's ``build_llm_engine`` gives users tokens only, so
    whisper's first loss fails in its encoder (no frames); the port's
    launcher refuses the cell before building anything, naming ROADMAP."""
    argv = ["--arch", ARCH, "--users", "2", "--k", "1", "--llm-seq", "8",
            "--llm-seqs-per-user", "2", "--batch-size", "2", "--rounds", "1"]
    ns = vars(ttrain.make_parser().parse_args(argv + ["--device", "cpu"]))
    with pytest.raises(AttributeError, match="shape"):
        jtrain.build_llm_engine(argparse.Namespace(**ns)).run()
    with pytest.raises(ValueError, match="ROADMAP"):
        ttrain.build_llm_engine(argparse.Namespace(**ns))
    with pytest.raises(ValueError, match="frames"):
        ttrain.main(argv + ["--device", "cpu"])
