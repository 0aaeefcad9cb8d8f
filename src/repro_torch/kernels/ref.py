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


#: slot-count sentinel/clamp for the contention event op: above any
#: sane ``max_sim_slots`` horizon, and small enough that
#: ``t + step + tx_slots`` can never overflow int32 (2^29 + 2^29 + tx).
CONTENTION_BIG = 1 << 29


def contention_min_ref(counters, live):
    """Pass 1: ``step = min(live ? counters : BIG)`` per row, (B,) int32."""
    big = torch.tensor(CONTENTION_BIG, dtype=torch.int32,
                       device=counters.device)
    return torch.where(live, counters, big).amin(dim=1)


def contention_expiry_ref(counters, live, step):
    """Pass 2: ``(nexp, winner)`` per row — how many live counters equal
    ``step``, and the smallest such index (N when there is none)."""
    N = counters.shape[1]
    exp = live & (counters == step[:, None])
    nexp = exp.sum(dim=1, dtype=torch.int32)
    idx = torch.arange(N, dtype=torch.int32, device=counters.device)
    winner = torch.where(exp, idx, torch.tensor(
        N, dtype=torch.int32, device=counters.device)).amin(dim=1)
    return nexp, winner


def _pow2_f32(e):
    """``2.0 ** e`` as f32, exactly, for int32 ``e`` in [-126, 127]: the
    exponent field written directly (``exp2`` need not be exact)."""
    return ((e + 127) << 23).view(torch.float32)


def contention_transition_ref(counters, live, doublings, windows, rand,
                              step, nexp, max_doublings: int):
    """Pass 3, elementwise: live counters count ``step`` down; a lone
    expiry delivers and leaves, two or more redraw
    ``clip(round(rand * win * 2^nd), 1, BIG)`` with ``nd`` one doubling
    more (capped). ``rand * win`` is the one f32 rounding; the power of
    two is exact and ``round`` is half-to-even, as ``rintf`` is."""
    cnt2 = torch.where(live, counters - step[:, None], counters)
    exp = live & (cnt2 == 0)
    deliver = (nexp == 1)[:, None]
    collide = (nexp >= 2)[:, None]
    nd = torch.clamp(doublings + 1, max=max_doublings)
    redraw = torch.clamp(
        torch.round(rand.float() * windows.float() * _pow2_f32(nd)),
        1.0, float(CONTENTION_BIG)).to(torch.int32)
    coll_exp = exp & collide
    return (torch.where(coll_exp, redraw, cnt2),
            torch.where(coll_exp, nd, doublings),
            live & ~(exp & deliver))


def contention_event_ref(counters, live, doublings, windows, rand,
                         max_doublings: int):
    """One slotted-CSMA medium event over B parallel rounds — the three
    passes in order.

    counters:  (B, N) int32 backoff counters (slots)
    live:      (B, N) bool — active AND still-running rows
    doublings: (B, N) int32 binary-exponential-backoff exponents
    windows:   (B, N) float32 CW sizes in slots
    rand:      (B, N) float32 U(0,1) redraw material

    Returns ``(step, nexp, winner, new_counters, new_doublings,
    new_active)`` (int32 x5, bool): per-row idle countdown to the next
    expiry, the number of counters expiring in that slot, the delivering
    user (min expiring index; N when none), and the post-event state.
    Rows without live users return step=BIG, nexp=0.
    """
    counters = counters.to(torch.int32)
    doublings = doublings.to(torch.int32)
    live = live.to(torch.bool)
    step = contention_min_ref(counters, live)
    nexp, winner = contention_expiry_ref(counters, live, step)
    return (step, nexp, winner) + contention_transition_ref(
        counters, live, doublings, windows, rand, step, nexp,
        max_doublings)
