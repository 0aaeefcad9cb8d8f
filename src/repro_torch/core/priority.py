"""Priority metric — paper Eq. (2).

    priority_k = prod_{l=1}^{L} (1 + ||w_{k,l} - w_l||_2 / ||w_l||_2)

"Layer" here is one weight tensor (pytree leaf, visited in sorted-key
order), matching the paper's per-layer treatment and the distance
metric of Bernstein et al. [13]. The paper observes priority values
land in [1, 1.2] in practice.

The reduction streams every parameter once per model pair; its inner
``||w_k - w||^2, ||w||^2`` pass is the ``delta_norm`` CUDA kernel
(``repro_torch.kernels``), with the plain PyTorch version for tensors
on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_leaves


def _ratio(d2, g2):
    # Stability clamp: layers with (near-)zero reference norm — e.g.
    # zero-initialized biases in round 0 — would otherwise produce
    # unbounded ratios and blow the Eq. 2 product far outside the
    # paper's observed [1, 1.2] range, which in turn collapses every
    # CW to zero slots and livelocks the CSMA contention. A relative
    # distance > 1 ("moved further than the reference is long")
    # carries no extra ordering information, so we cap each layer's
    # ratio at 1.
    ratio = torch.sqrt(d2) / torch.clamp(torch.sqrt(g2), min=1e-12)
    return torch.clamp(ratio, max=1.0)


def layer_distance_ratios(local_params, global_params):
    """Per-leaf relative distances ||w_k,l - w_l|| / ||w_l||.

    Returns a list of scalar f32 tensors, one per leaf (layer); leaves
    are paired by tree structure.
    """
    local_leaves = tree_leaves(local_params)
    global_leaves = tree_leaves(global_params)
    if len(local_leaves) != len(global_leaves):
        raise ValueError("local and global pytrees differ in leaf count")
    return [_ratio(*kops.delta_norm(wl, wg))
            for wl, wg in zip(local_leaves, global_leaves)]


def _product(ratios, like):
    prio = torch.ones_like(like, dtype=torch.float32)
    for r in ratios:                      # f32 product in leaf order
        prio = prio * (1.0 + r)
    return prio


def model_priority(local_params, global_params):
    """Eq. (2): product over layers of (1 + relative distance). Scalar f32."""
    ratios = layer_distance_ratios(local_params, global_params)
    return _product(ratios, ratios[0])


def stacked_model_priorities(local_stacked, global_params):
    """Eq. (2) over a (S, ...)-stacked pytree of local models — the
    vectorized twin of ``model_priority``: ONE batched ``delta_norm``
    per leaf over the whole ``(S, n)`` stack against the ``(n,)``
    global (no loop over users). Returns (S,) f32."""
    local_leaves = tree_leaves(local_stacked)
    global_leaves = tree_leaves(global_params)
    if len(local_leaves) != len(global_leaves):
        raise ValueError("local and global pytrees differ in leaf count")
    with torch.no_grad():
        ratios = [_ratio(*kops.delta_norm_stacked(wl, wg))
                  for wl, wg in zip(local_leaves, global_leaves)]
        return _product(ratios, ratios[0])


def contention_window(priority, N: float):
    """Eq. (3): W = N / priority."""
    return N / priority
