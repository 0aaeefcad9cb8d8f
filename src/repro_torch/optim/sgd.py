"""SGD — the paper's local optimizer (lr 1e-2, Sec. IV-A2).

``sgd_update`` applies the fused read-modify-write step leaf by leaf
through ``kernels.ops.fused_sgd``: the CUDA kernel for tensors on the
GPU, the plain version on the CPU. The momentum variants of the
reference are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_map


def sgd_update(params, grads, lr):
    """``p <- p - lr * g`` for every leaf, IN PLACE; returns ``params``
    (the reference returns a new pytree and donates the old buffers —
    the in-place update is that saving, said directly). Leaves may be
    whole stacked ``(U, ...)`` cohorts: one launch per leaf. A gradient
    that autograd hands back as a permuted view (a conv weight kept in
    HWIO) is made contiguous first — a no-op for every other leaf."""
    with torch.no_grad():
        return tree_map(
            lambda p, g: kops.fused_sgd(p, g.contiguous(), lr),
            params, grads)
