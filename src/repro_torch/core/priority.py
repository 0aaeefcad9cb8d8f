"""Priority metric — paper Eq. (2).

    priority_k = prod_{l=1}^{L} (1 + ||w_{k,l} - w_l||_2 / ||w_l||_2)

"Layer" here is one weight tensor (pytree leaf, visited in sorted-key
order), matching the paper's per-layer treatment and the distance
metric of Bernstein et al. [13]. The paper observes priority values
land in [1, 1.2] in practice.

The reduction streams every parameter once per model pair; its inner
``||w_k - w||^2, ||w||^2`` pass is the ``delta_norm`` CUDA kernel
(``repro_torch.kernels``), ONE launch for every leaf of the model, with
the plain PyTorch version for tensors on the CPU.

``contention_window`` and ``backoff_time`` are Eq. (3): ``W = N /
priority`` and the backoff ``R * W`` with ``R ~ U(0, 1)`` drawn from an
explicit ``torch.Generator`` (the reference draws ``R`` with threefry, so
the two agree in distribution, not draw for draw).
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


def _leaf_pairs(local_params, global_params):
    local_leaves = tree_leaves(local_params)
    global_leaves = tree_leaves(global_params)
    if len(local_leaves) != len(global_leaves):
        raise ValueError("local and global pytrees differ in leaf count")
    return local_leaves, global_leaves


def layer_distance_ratios(local_params, global_params):
    """Per-leaf relative distances ||w_k,l - w_l|| / ||w_l||.

    Returns a list of scalar f32 tensors, one per leaf (layer); leaves
    are paired by tree structure. One ``delta_norm_leaves`` call.
    """
    local_leaves, global_leaves = _leaf_pairs(local_params, global_params)
    d2, g2 = kops.delta_norm_leaves([w.unsqueeze(0) for w in local_leaves],
                                    global_leaves)
    return list(_ratio(d2[:, 0], g2).unbind(0))


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
    vectorized twin of ``model_priority``: ONE ``delta_norm_leaves`` call
    over every leaf's whole ``(S, n)`` stack against its ``(n,)`` global
    (no loop over users or leaves), then the per-leaf ratios and their
    f32 product in leaf order. Returns (S,) f32."""
    local_leaves, global_leaves = _leaf_pairs(local_stacked, global_params)
    with torch.no_grad():
        d2, g2 = kops.delta_norm_leaves(local_leaves, global_leaves)
        return priority_product(d2, g2[:, None])


def priority_product(d2, g2):
    """Eq. (2) from ``delta_norm_leaves`` sums: ``d2`` (..., L, S) and
    ``g2`` (..., L, 1) -> (..., S) f32, each leaf's clamped ratio, then
    their product in leaf order (a sweep's lanes ride the leading
    axes)."""
    ratios = _ratio(d2, g2)
    return _product(ratios.unbind(-2), ratios.select(-2, 0))


def contention_window(priority, N: float):
    """Eq. (3): W = N / priority."""
    return N / priority


def backoff_time(priority, N: float, generator: torch.Generator):
    """Eq. (3): ``T_backoff = R * W``, ``R ~ U(0, 1)`` an f32 draw of
    ``generator`` (on its device), ``W = contention_window(priority,
    N)``; on ``priority``'s device."""
    R = torch.rand((), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return R.to(torch.as_tensor(priority).device) \
        * contention_window(priority, N)
