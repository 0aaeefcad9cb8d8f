"""Eq. 2 in the port against the JAX package, on the CPU.

Same numpy models through ``repro.core.priority`` and
``repro_torch.core.priority``; ``rtol=1e-5`` (the two sum the squares
in different orders).
"""
import numpy as np
import pytest
import torch

from repro.core import priority as jprio
from repro_torch.core import priority as tprio

from torch_port_util import f32, to_jax, to_torch


def _mlp(seed, d_in=48, d_hid=20, n_cls=10, scale=0.1):
    rng = np.random.default_rng(seed)
    return {
        "fc1": {"w": (scale * rng.standard_normal((d_in, d_hid)))
                .astype(np.float32),
                "b": (scale * rng.standard_normal(d_hid)).astype(np.float32)},
        "fc2": {"w": (scale * rng.standard_normal((d_hid, n_cls)))
                .astype(np.float32),
                "b": (scale * rng.standard_normal(n_cls)).astype(np.float32)},
    }


def _perturbed(glob, seed, eps=0.01):
    rng = np.random.default_rng(seed)
    return {k: {n: (a + eps * rng.standard_normal(a.shape))
                .astype(np.float32) for n, a in layer.items()}
            for k, layer in glob.items()}


def _stack(models):
    return {k: {n: np.stack([m[k][n] for m in models])
                for n in models[0][k]} for k in models[0]}


def test_model_priority_matches_jax():
    glob = _mlp(0)
    for seed in (1, 2, 3):
        local = _perturbed(glob, seed)
        want = jprio.model_priority(to_jax(local), to_jax(glob),
                                    use_kernel=False)
        got = tprio.model_priority(to_torch(local), to_torch(glob))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5)


def test_layer_distance_ratios_match_jax_leaf_for_leaf():
    """Same leaves in the same (sorted-key) order on both sides."""
    glob, local = _mlp(0), _perturbed(_mlp(0), 5, eps=0.05)
    want = jprio.layer_distance_ratios(to_jax(local), to_jax(glob),
                                       use_kernel=False)
    got = tprio.layer_distance_ratios(to_torch(local), to_torch(glob))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(f32(g), f32(w), rtol=1e-5)


@pytest.mark.parametrize("U", [1, 6])
def test_stacked_model_priorities_match_jax(U):
    glob = _mlp(0)
    locals_ = [_perturbed(glob, 10 + u, eps=0.01 * (u + 1))
               for u in range(U)]
    want = jprio.stacked_model_priorities(to_jax(_stack(locals_)),
                                          to_jax(glob))
    got = tprio.stacked_model_priorities(to_torch(_stack(locals_)),
                                         to_torch(glob))
    assert got.shape == (U,) and got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5)
    # the stacked twin equals the per-model definition, user by user
    for u in range(U):
        one = tprio.model_priority(to_torch(locals_[u]), to_torch(glob))
        np.testing.assert_allclose(f32(got[u]), f32(one), rtol=1e-6)


def test_zero_reference_leaf_clamps_at_one():
    """An all-zero bias leaf (round 0) has no reference norm: its ratio
    is capped at 1, so it contributes a factor of exactly 2."""
    glob = _mlp(0)
    glob["fc1"]["b"][:] = 0.0
    local = _perturbed(glob, 7)
    ratios = tprio.layer_distance_ratios(to_torch(local), to_torch(glob))
    assert float(ratios[0]) == 1.0               # fc1.b sorts first
    want = jprio.model_priority(to_jax(local), to_jax(glob),
                                use_kernel=False)
    got = tprio.model_priority(to_torch(local), to_torch(glob))
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5)
    assert float(got) >= 2.0
    st = tprio.stacked_model_priorities(to_torch(_stack([local, glob])),
                                        to_torch(glob))
    np.testing.assert_allclose(f32(st[0]), f32(got), rtol=1e-6)
    assert float(st[1]) == 1.0


def test_identical_models_give_exactly_one():
    glob = _mlp(3)
    assert float(tprio.model_priority(to_torch(glob),
                                      to_torch(glob))) == 1.0
    st = tprio.stacked_model_priorities(
        to_torch(_stack([glob, glob, glob])), to_torch(glob))
    assert np.array_equal(f32(st), np.ones(3, np.float32))


def test_freshly_trained_priorities_land_in_the_papers_band():
    """Small relative moves on every layer land in [1, 1.2]."""
    glob = _mlp(4, scale=0.3)
    local = _perturbed(glob, 8, eps=0.003)
    p = float(tprio.model_priority(to_torch(local), to_torch(glob)))
    assert 1.0 < p < 1.2


def test_contention_window_is_eq3():
    assert tprio.contention_window(1.25, 2048.0) == 2048.0 / 1.25
