"""SGD — the paper's local optimizer (lr 1e-2, Sec. IV-A2).

``sgd_update`` applies the fused read-modify-write step to every leaf at
once through ``kernels.ops.fused_sgd_leaves``: one CUDA launch a step for
tensors on the GPU, the plain version leaf by leaf on the CPU. The
momentum variants of the reference are not ported yet.
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
