"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

Inputs are made with numpy from a seed and handed to both packages:
``to_jax`` / ``to_torch`` turn one nested dict of arrays into each
side's parameter pytree (the port always on the CPU here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.convert import params_from_numpy

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_jax(tree, dtype="float32"):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(JAX_DTYPES[dtype]),
                        tree)


def to_torch(tree, dtype="float32"):
    return params_from_numpy(tree, device="cpu", dtype=TORCH_DTYPES[dtype])


def arr_j(a, dtype="float32"):
    """One numpy array as a JAX array of ``dtype`` (f32 -> bf16 rounds to
    nearest even, exactly as ``arr_t`` does)."""
    return jnp.asarray(a).astype(JAX_DTYPES[dtype])


def arr_t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, copy=True)).to(TORCH_DTYPES[dtype])


def f32(x):
    """Any framework's array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def tree_f32(tree):
    """Nested dict of either framework's arrays -> nested dict of f32
    numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_f32(v) for k, v in tree.items()}
    return f32(tree)


def assert_trees_close(a, b, **tol):
    a, b = tree_f32(a), tree_f32(b)
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, **tol)


def bits(t):
    """A tensor's bit pattern as integers, for bitwise comparisons."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.view(torch.int32).numpy()


def jax_xent(apply_fn, n_classes):
    """The reference's one-hot cross-entropy loss over ``apply_fn``."""
    def loss_fn(params, batch):
        logits = apply_fn(params, batch["x"])
        oh = jax.nn.one_hot(batch["y"], n_classes)
        return -jnp.mean(jnp.sum(oh * jax.nn.log_softmax(logits), -1))
    return loss_fn

