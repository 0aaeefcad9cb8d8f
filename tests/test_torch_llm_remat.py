"""The LLM stack's memory levers, ``cfg.remat`` (each layer recomputed in
the backward pass) and ``flash_chunk_remat`` (each kv chunk of the flash
loop recomputed), through the local step's ``vmap(grad_and_value)``.

One step of 2 users, 2 sequences of 16 tokens each, ``chunk`` 8 (two kv
chunks a sequence), for the reduced yi-9b, deepseek-v3 (MLA, MoE, MTP),
mamba2, hymba and whisper-small (with its stub frames), on the CPU:
- within the port, the losses and every gradient leaf are the same bits
  with each lever on as with both off (``layers.recompute`` reruns the
  same ops);
- against JAX (``jax.checkpoint`` on both levers), one dense and one SSM
  arch from the same numpy params and tokens, at the bars of
  ``tests/test_torch_llm_model.py``: losses ``rtol=1e-5``, gradients
  within 1e-5 of each leaf's largest magnitude;
- lane 1 of a 2-lane ``--arch yi-9b`` sweep with ``remat`` on is its
  sequential run bit for bit, and the local step's row bits at 4 threads
  hold with ``remat`` on (``per_user``'s explicit backward then runs
  inside the recompute's backward).
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import model as jm
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as L
from repro_torch.models import model as tm
from repro_torch.tree import tree_leaves, tree_map
from test_torch_llm_ssm import local_step_row_bits_twin
from torch_port_util import bitwise_equal, tree_f32

ARCHS = ["yi-9b", "deepseek-v3-671b", "mamba2-370m", "hymba-1.5b",
         "whisper-small"]
LEVERS = {"remat": dict(remat=True),
          "flash_chunk_remat": dict(flash_chunk_remat=True),
          "both": dict(remat=True, flash_chunk_remat=True)}
U, B, S, CHUNK = 2, 2, 16, 8


def _batch(cfg, seed=1):
    """Numpy tokens (and whisper's frames) of U users x B sequences."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (U, B, S + 1))
           .astype(np.int32)}
    if cfg.is_encdec:
        out["frames"] = (0.02 * rng.standard_normal(
            (U, B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return out


def _torch_step(cfg, stack, batch):
    def loss(p, b):
        return tm.compute_loss(p, b, cfg, chunk=CHUNK)
    return torch.func.vmap(torch.func.grad_and_value(loss))(stack, batch)


class Cell:
    """One arch's reduced config, a cohort stack of the port's seed-0
    params (U copies) and a batch; the step with both levers off."""

    def __init__(self, arch):
        self.cfg = dataclasses.replace(tget(arch).reduced(), remat=False,
                                       flash_chunk_remat=False)
        params = tm.init_params(0, self.cfg, device="cpu")
        self.stack = tree_map(
            lambda p: p.unsqueeze(0).expand((U,) + tuple(p.shape))
            .contiguous(), params)
        self.batch = {k: torch.from_numpy(v)
                      for k, v in _batch(self.cfg).items()}
        self.off = _torch_step(self.cfg, self.stack, self.batch)


@pytest.fixture(scope="module")
def cells():
    return {}


def _cell(cells, arch):
    if arch not in cells:
        cells[arch] = Cell(arch)
    return cells[arch]


@pytest.mark.parametrize("lever", sorted(LEVERS))
@pytest.mark.parametrize("arch", ARCHS)
def test_levers_keep_the_local_steps_bits(arch, lever, cells, monkeypatch):
    """The lever on gives the bits of both levers off; its recomputing
    backward ran (a layer a ``remat``, a kv chunk a
    ``flash_chunk_remat``), except ``flash_chunk_remat`` alone on mamba2,
    which has no attention."""
    c = _cell(cells, arch)
    cfg = dataclasses.replace(c.cfg, **LEVERS[lever])
    ran, backward = [], L._Recompute.backward

    def counted(ctx, *grads):
        ran.append(1)
        return backward(ctx, *grads)
    monkeypatch.setattr(L._Recompute, "backward", staticmethod(counted))
    g, loss = _torch_step(cfg, c.stack, c.batch)
    assert bool(ran) == ("remat" in LEVERS[lever]
                         or arch != "mamba2-370m")
    g0, loss0 = c.off
    assert torch.equal(loss, loss0)
    assert len(tree_leaves(g)) == len(tree_leaves(g0))
    for a, b in zip(tree_leaves(g), tree_leaves(g0)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m"])
def test_both_levers_match_jax(arch):
    """Both levers on in both packages (the reference's ``jax.checkpoint``
    of the layer scan's body and of the flash step), the reference's own
    params carried across, the same tokens."""
    levers = dict(remat=True, flash_chunk_remat=True)
    jc = dataclasses.replace(jget(arch).reduced(), **levers)
    tc = dataclasses.replace(tget(arch).reduced(), **levers)
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    npp = jax.tree.map(np.asarray, jp)
    batch = _batch(tc)
    jstack = jax.tree.map(lambda a: jnp.stack([a] * U), jp)

    def jloss(p, b):
        return jm.compute_loss(p, b, jc, chunk=CHUNK)
    jg, jl = jax.vmap(jax.value_and_grad(jloss), in_axes=(0, 0))(
        jstack, {k: jnp.asarray(v) for k, v in batch.items()})[::-1]
    tp = params_from_numpy(npp, device="cpu")
    tstack = tree_map(lambda p: p.unsqueeze(0).expand(
        (U,) + tuple(p.shape)).contiguous(), tp)
    tg, tl = _torch_step(tc, tstack, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    tleaves, jleaves = tree_leaves(tg), jax.tree.leaves(jg)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                                   atol=1e-5 * np.abs(j).max())


def test_remat_sweep_lane_equals_its_sequential_run():
    """``--sweep-seeds 2`` of the reduced yi-9b cell with ``remat`` on:
    lane 1 (8 rows through the local step) is the seed-1 run (4 rows) of
    the same data and init, bit for bit."""
    from repro_torch.engine import SweepSpec
    argv = ["--arch", "yi-9b", "--users", "4", "--k", "2", "--llm-seq",
            "16", "--llm-seqs-per-user", "4", "--batch-size", "2",
            "--rounds", "2", "--strategy", "priority-distributed",
            "--device", "cpu"]
    args = ttrain.make_parser().parse_args(argv)
    remat = dict(remat=True)
    eng = ttrain.build_llm_engine(args, cfg_fields=remat)
    res = eng.run_sweep(SweepSpec.grid(eng.spec, seed=range(0, 2)))
    one = ttrain.build_llm_engine(argparse.Namespace(**vars(args)),
                                  init=tree_f32(eng._init_params),
                                  cfg_fields=remat, seed=1)
    h = one.run()
    assert h.winners == res[1].winners
    assert h.train_loss == res[1].train_loss
    assert bitwise_equal(one.global_params, res.lane_params(1))


def test_remat_local_step_row_bits_twin_at_four_threads(monkeypatch):
    """``test_local_step_row_bits_twin_at_four_threads`` for mamba2 (its
    ``silu`` and ``in_proj`` through ``per_user``) with ``remat`` on: no
    op's bits over lane 0's rows follow the row count, the recomputed
    forward and its backward included."""
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        local_step_row_bits_twin("mamba2-370m", 4, monkeypatch,
                                 cfg_fields=dict(remat=True))
    finally:
        torch.set_num_threads(before)
