"""Plain PyTorch version of every CUDA kernel in this package.

The CPU tests run these, the wrappers in ``ops.py`` take them for a
tensor that lies on the CPU, and the GPU smoke script holds each kernel
against its plain version on the same inputs. Nothing on the main path
calls them when the tensors are on a CUDA device.
"""
from __future__ import annotations

import torch


def delta_norm_ref(w_local, w_global):
    """(||w_local - w_global||^2, ||w_global||^2), both f32 scalars."""
    wl = w_local.float()
    wg = w_global.float()
    d = wl - wg
    return torch.sum(d * d), torch.sum(wg * wg)


def delta_norm_stacked_ref(stack, w_global):
    """Batched twin: ``stack`` (U, ...) against one ``w_global`` (...)
    -> ``(d2 (U,), g2 ())`` f32. ``g2`` is computed once."""
    wg = w_global.float()
    d = stack.float() - wg.unsqueeze(0)
    d2 = torch.sum((d * d).reshape(stack.shape[0], -1), dim=1)
    return d2, torch.sum(wg * wg)


def _ordered_masked_sum(rows, weights):
    """sum_j w_j * rows[j] in f32, j = 0, 1, ... IN ORDER, each product
    and each addition rounded separately; a zero weight contributes
    EXACT zero even when its row is non-finite (0 * inf would be NaN
    under a plain product-sum)."""
    w = weights.float()
    acc = torch.zeros(rows.shape[1:], dtype=torch.float32,
                      device=rows.device)
    zero = torch.zeros((), dtype=torch.float32, device=rows.device)
    for j in range(rows.shape[0]):
        term = torch.where(w[j] != 0.0, rows[j].float() * w[j], zero)
        acc = acc + term
    return acc


def fedavg_combine_ref(stacked, alphas):
    """stacked: (K, ...), alphas: (K,) f32 -> weighted sum, stacked.dtype.

    Masked semantics: a zero alpha contributes EXACT zero even when that
    row holds inf/NaN — a diverged loser must not poison the global.
    """
    return _ordered_masked_sum(stacked, alphas).to(stacked.dtype)


def gather_combine_ref(stacked, idx, weights, glob):
    """Winner-sparse Eq. 1: ``any(w != 0) ? sum_j w_j * stacked[idx_j]
    : glob``.

    stacked: (S, ...); idx: (K,) integer row indices (delivery order,
    zero-padded); weights: (K,) f32 (exact-zero pads); glob: (...) the
    old global, returned unchanged when no weight is nonzero.

    The reduce runs over the gathered (K, ...) rows in delivery order,
    so the result depends only on K's nonzero rows — not on the source
    stack's length S, and not on the pad width (appending exact +0.0
    terms leaves an f32 sum's bits unchanged).
    """
    rows = torch.index_select(stacked, 0, idx.long())
    acc = _ordered_masked_sum(rows, weights)
    has = torch.any(weights != 0.0)
    return torch.where(has, acc, glob.float()).to(stacked.dtype)


def fused_sgd_ref(param, grad, lr):
    """param - lr * grad, computed in f32 (product and difference
    rounded separately), cast back."""
    lr32 = torch.tensor(lr, dtype=torch.float32, device=param.device)
    return (param.float() - lr32 * grad.float()).to(param.dtype)
