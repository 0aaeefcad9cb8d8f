"""Local SGD (Step 2) and the server merges (Eq. 1) in the port against
the JAX package, on the CPU, from the same numpy parameters, batches
and weights.

Training tolerances are ``rtol=1e-4, atol=1e-6`` after a few steps: f32
matmul / convolution sums run in different orders on the two sides and
the difference is fed back through the updates. The merges share
``tests/test_kernels.py``'s f32 bar (``rtol=1e-5, atol=1e-6``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jclient, server as jserver
from repro.core.rngs import client_rng as j_client_rng
from repro.engine.backends import compact_weights as j_compact_weights
from repro.models import paper_models as jm
from repro_torch.core import client as tclient, server as tserver
from repro_torch.core.rngs import client_rng as t_client_rng
from repro_torch.engine.backends import compact_weights as t_compact_weights
from repro_torch.launch.train import classification_loss
from repro_torch.models import paper_models as tm

from torch_port_util import (assert_trees_close, f32, jax_xent, to_jax,
                             to_torch)

TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)
MERGE_TOL = dict(rtol=1e-5, atol=1e-6)


def _mlp(rng, d_in=48, d_hid=20, n_cls=10):
    return {"fc1": {"w": rng.standard_normal((d_in, d_hid), np.float32) * .2,
                    "b": np.zeros(d_hid, np.float32)},
            "fc2": {"w": rng.standard_normal((d_hid, n_cls), np.float32) * .2,
                    "b": np.zeros(n_cls, np.float32)}}


def _stack(tree, U):
    return jax.tree.map(lambda a: np.broadcast_to(a, (U,) + a.shape).copy(),
                        tree)


# ------------------------------------------------------- sgd_epoch_scan
def test_sgd_epoch_scan_mlp_cohort_matches_vmapped_jax():
    rng = np.random.default_rng(0)
    U, nb, bs, d_in = 4, 5, 8, 48
    glob = _mlp(rng, d_in)
    x = rng.standard_normal((U, nb, bs, d_in), np.float32)
    y = rng.integers(0, 10, (U, nb, bs)).astype(np.int32)
    lr = 0.05

    jrun = jax.vmap(jclient.sgd_epoch_scan(jax_xent(jm.apply_mlp, 10), lr))
    want_p, want_l = jrun(to_jax(_stack(glob, U)), {"x": x, "y": y})

    trun = tclient.sgd_epoch_scan(classification_loss(tm.apply_mlp), lr)
    stack = to_torch(_stack(glob, U))
    got_p, got_l = trun(stack, {"x": torch.from_numpy(x),
                                "y": torch.from_numpy(y)})
    assert got_p is stack                            # trained in place
    assert got_l.shape == (U, nb)
    np.testing.assert_allclose(f32(got_l), f32(want_l), **TRAIN_TOL)
    assert_trees_close(got_p, want_p, **TRAIN_TOL)
    # the users really diverged from each other and from the global
    w = f32(got_p["fc1"]["w"])
    assert not np.allclose(w[0], w[1]) and not np.allclose(
        w[0], glob["fc1"]["w"])


def _narrow_cnn(rng, c1=8, c2=16, size=8, n_cls=10):
    d_flat = c2 * (size // 4) ** 2
    return {
        "conv1": {"w": rng.standard_normal((5, 5, 1, c1), np.float32) * .1,
                  "b": np.zeros(c1, np.float32)},
        "conv2": {"w": rng.standard_normal((5, 5, c1, c2), np.float32) * .05,
                  "b": np.zeros(c2, np.float32)},
        "fc": {"w": rng.standard_normal((d_flat, n_cls), np.float32) * .1,
               "b": np.zeros(n_cls, np.float32)}}


def test_sgd_epoch_scan_narrow_cnn_cohort_matches_vmapped_jax():
    """8 / 16 channels on 8x8 inputs: the conv weights stay HWIO through
    the in-place update although autograd hands their gradient back as
    a permuted view."""
    rng = np.random.default_rng(1)
    U, nb, bs = 3, 3, 4
    glob = _narrow_cnn(rng)
    x = rng.standard_normal((U, nb, bs, 8, 8, 1), np.float32)
    y = rng.integers(0, 10, (U, nb, bs)).astype(np.int32)
    lr = 0.05

    jrun = jax.vmap(jclient.sgd_epoch_scan(jax_xent(jm.apply_cnn, 10), lr))
    want_p, want_l = jrun(to_jax(_stack(glob, U)), {"x": x, "y": y})
    trun = tclient.sgd_epoch_scan(classification_loss(tm.apply_cnn), lr)
    got_p, got_l = trun(to_torch(_stack(glob, U)),
                        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(f32(got_l), f32(want_l), **TRAIN_TOL)
    assert_trees_close(got_p, want_p, **TRAIN_TOL)
    assert got_p["conv2"]["w"].shape == (U, 5, 5, 8, 16)
    assert got_p["conv2"]["w"].is_contiguous()


# ---------------------------------------------------------- batch_epoch
@pytest.mark.parametrize("n,bs", [(64, 32), (70, 32), (20, 32)])
def test_batch_epoch_equal_index_for_index(n, bs):
    rng = np.random.default_rng(2)
    data = {"x": rng.standard_normal((n, 6), np.float32),
            "y": rng.integers(0, 4, n).astype(np.int32)}
    if n < bs:
        # fewer examples than one batch cannot reshape: both refuse
        with pytest.raises(ValueError):
            jclient.batch_epoch(j_client_rng(3, 1), data, bs)
        with pytest.raises(ValueError):
            tclient.batch_epoch(t_client_rng(3, 1), data, bs)
        return
    jr, tr = j_client_rng(3, 1), t_client_rng(3, 1)
    for _ in range(3):                   # stream positions stay aligned
        want = jclient.batch_epoch(jr, data, bs)
        got = tclient.batch_epoch(tr, data, bs)
        for k in data:
            assert got[k].shape == (n // bs, bs) + data[k].shape[1:]
            assert np.array_equal(got[k], want[k])


def test_client_trains_like_the_references_client():
    rng = np.random.default_rng(4)
    glob = _mlp(rng)
    data = {"x": rng.standard_normal((40, 48), np.float32),
            "y": rng.integers(0, 10, 40).astype(np.int32)}
    jc = jclient.Client(2, data, jax_xent(jm.apply_mlp, 10), lr=0.05,
                        batch_size=8, local_epochs=2, seed=5)
    tc = tclient.Client(2, data, classification_loss(tm.apply_mlp), lr=0.05,
                        batch_size=8, local_epochs=2, seed=5)
    assert tc.num_examples == jc.num_examples == 40
    want_p, want_loss = jc.train(to_jax(glob))
    tglob = to_torch(glob)
    got_p, got_loss = tc.train(tglob)
    np.testing.assert_allclose(f32(got_loss), f32(want_loss), **TRAIN_TOL)
    assert_trees_close(got_p, want_p, **TRAIN_TOL)
    assert_trees_close(tglob, glob, rtol=0, atol=0)   # global untouched
    np.testing.assert_allclose(
        tc.priority(got_p, tglob),
        jc.priority(want_p, to_jax(glob)), rtol=1e-4)


# -------------------------------------------------------- merge weights
@pytest.mark.parametrize("winners,sizes", [([3, 0], [600, 600]),
                                           ([5, 1, 2], [10, 300, 77]),
                                           ([4], [123])])
def test_winner_alphas_bit_equal(winners, sizes):
    want = jserver.winner_alphas(7, winners, sizes)
    got = tserver.winner_alphas(7, winners, sizes)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("k_pad,pos,sizes", [(2, [3, 0], [600, 600]),
                                             (4, [5, 1, 2], [10, 300, 77]),
                                             (3, [], []),
                                             (1, [6], [9])])
def test_compact_weights_bit_equal(k_pad, pos, sizes):
    wi, ww = j_compact_weights(k_pad, pos, sizes)
    gi, gw = t_compact_weights(k_pad, pos, sizes)
    assert gi.dtype == np.int32 and gw.dtype == np.float32
    assert np.array_equal(gi, wi) and np.array_equal(gw, ww)


# --------------------------------------------------------------- fedavg
def _models(rng, k):
    return [_mlp(rng) for _ in range(k)]


@pytest.mark.parametrize("k", [1, 3])
def test_fedavg_matches_jax(k):
    rng = np.random.default_rng(6)
    models, sizes = _models(rng, k), [100, 250, 50][:k]
    want = jserver.fedavg([to_jax(m) for m in models], sizes,
                          use_kernel=False)
    got = tserver.fedavg([to_torch(m) for m in models], sizes)
    assert_trees_close(got, want, **MERGE_TOL)
    if k == 1:
        assert_trees_close(got, models[0], rtol=0, atol=0)


def test_fedavg_masked_matches_jax_and_the_gathered_fedavg():
    rng = np.random.default_rng(7)
    U, winners, sizes = 6, [4, 1], [300, 100]
    models = _models(rng, U)
    stacked = jax.tree.map(lambda *ls: np.stack(ls), *models)
    alphas = tserver.winner_alphas(U, winners, sizes)
    want = jserver.fedavg_masked(to_jax(stacked), jnp.asarray(alphas),
                                 use_kernel=False)
    got = tserver.fedavg_masked(to_torch(stacked), alphas)
    assert_trees_close(got, want, **MERGE_TOL)
    gathered = tserver.fedavg([to_torch(models[u]) for u in winners], sizes)
    assert_trees_close(got, gathered, **MERGE_TOL)


def test_fedavg_masked_ignores_a_diverged_loser():
    rng = np.random.default_rng(8)
    models = _models(rng, 4)
    models[2]["fc1"]["w"][:] = np.inf
    models[2]["fc2"]["b"][:] = np.nan
    stacked = jax.tree.map(lambda *ls: np.stack(ls), *models)
    alphas = tserver.winner_alphas(4, [0, 3], [50, 50])
    got = tserver.fedavg_masked(to_torch(stacked), alphas)
    for leaf in jax.tree.leaves(jax.tree.map(f32, got)):
        assert np.isfinite(leaf).all()


def test_fedavg_delta_matches_jax():
    rng = np.random.default_rng(9)
    glob = _mlp(rng)
    deltas = [jax.tree.map(lambda a: (0.01 * rng.standard_normal(a.shape))
                           .astype(np.float32), glob) for _ in range(3)]
    sizes = [5, 10, 20]
    want = jserver.fedavg_delta(to_jax(glob), [to_jax(d) for d in deltas],
                                sizes, use_kernel=False)
    got = tserver.fedavg_delta(to_torch(glob),
                               [to_torch(d) for d in deltas], sizes)
    assert_trees_close(got, want, **MERGE_TOL)


def test_fedavg_rejects_mismatched_inputs():
    rng = np.random.default_rng(10)
    with pytest.raises(ValueError):
        tserver.fedavg([], [])
    with pytest.raises(ValueError):
        tserver.fedavg([to_torch(_mlp(rng))], [1, 2])
