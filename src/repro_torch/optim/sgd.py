"""SGD — the paper's local optimizer (lr 1e-2, Sec. IV-A2).

``sgd_update`` applies the fused read-modify-write step to every leaf at
once through ``kernels.ops.fused_sgd_leaves``: one CUDA launch a step for
tensors on the GPU, the plain version leaf by leaf on the CPU.
``sgd_momentum_update`` is the law that ``server_opt``'s kind 1 (FedAvgM)
applies to the pseudo-gradient ``old - avg``: each operation one op in
the leaves' dtype, rounded on its own, so the kernel's kind 1 gives its
bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_leaves, tree_map


def sgd_update(params, grads, lr):
    """``p <- p - lr * g`` for every leaf, IN PLACE; returns ``params``
    (the reference returns a new pytree and donates the old buffers —
    the in-place update is that saving, said directly). Leaves may be
    whole stacked ``(U, ...)`` cohorts: one launch a step covers them
    all. A gradient that autograd hands back as a permuted view (a conv
    weight kept in HWIO) is made contiguous first — a no-op for every
    other leaf."""
    with torch.no_grad():
        pairs = tree_leaves(tree_map(lambda p, g: (p, g.contiguous()),
                                     params, grads))
        kops.fused_sgd_leaves([p for p, _ in pairs], [g for _, g in pairs],
                              lr)
    return params


def sgd_momentum_init(params):
    """Zero momentum buffers, one a leaf, in the leaves' shapes, dtypes
    and devices."""
    return tree_map(torch.zeros_like, params)


def sgd_momentum_update(params, grads, state, lr, momentum=0.9):
    """``m' = momentum * m + g``, ``p' = p - lr * m'``; returns ``(p',
    m')`` as new pytrees (the inputs are left as they were). The product
    and the sum are separate ops, never a fused multiply-add."""
    new_state = tree_map(lambda m, g: momentum * m + g, state, grads)
    new_params = tree_map(lambda p, m: p - lr * m, params, new_state)
    return new_params, new_state
