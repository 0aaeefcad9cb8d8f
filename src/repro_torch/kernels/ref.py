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
    -> ``(d2 (U,), g2 ())`` f32. ``g2`` is computed once. Each row is
    summed on its own: a multi-row ``sum(dim=1)`` orders a row's
    additions by the row count (torch's CPU reduction does), and a row's
    result must not depend on the rows beside it."""
    wg = w_global.float()
    d = stack.float() - wg.unsqueeze(0)
    sq = (d * d).reshape(stack.shape[0], -1)
    d2 = torch.stack([r.sum() for r in sq.unbind(0)]) if len(sq) \
        else sq.sum(dim=1)
    return d2, torch.sum(wg * wg)


def token_sum_ref(x):
    """``x`` (R, N, C) f32 -> ``(R, C)``: each column's N values padded
    with zeros to the next power of two and added in adjacent pairs,
    level by level (``x[2i] + x[2i+1]``). Elementwise adds only, so row
    r's bits follow its own N values and not R or C, on any device."""
    R, N, C = x.shape
    P = 1 << max(N - 1, 0).bit_length()
    if P != N:
        x = torch.cat([x, x.new_zeros((R, P - N, C))], dim=1)
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def delta_norm_leaves_ref(stacks, globs):
    """Every leaf at once: ``stacks[l]`` (U, ...) against ``globs[l]``
    (...) -> ``(d2 (L, U), g2 (L,))`` f32, ``delta_norm_stacked_ref``
    leaf by leaf."""
    d2, g2 = zip(*(delta_norm_stacked_ref(s, g)
                   for s, g in zip(stacks, globs)))
    return torch.stack(d2), torch.stack(g2)


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


def aircomp_combine_ref(stacked, weights, noise, scale):
    """AirComp over-the-air merge: ``(sum_j w_j * stacked[j] + noise)
    * scale``.

    stacked: (K, ...); weights: (K,) f32 effective receive weights
    (alpha_k * misalignment c_k); noise: the f32 receiver-noise plane of
    the output shape, or None for none; scale: f32 scalar (tensor) —
    sum(alpha) / sum(weight), restoring the Eq. 1 mass the truncated
    power control attenuated. The sum runs j = 0, 1, ... in order with
    each product and addition rounded on its own; a zero weight
    contributes EXACT zero even for a non-finite row. With no noise and
    ``scale == 1`` this is ``gather_combine_ref``'s sum over the same
    rows, bit for bit.
    """
    acc = _ordered_masked_sum(stacked, weights)
    if noise is not None:
        acc = acc + noise.float()
    return (acc * scale.float()).to(stacked.dtype)


def robust_combine_ref(stacked, weights, scales, global_ref):
    """Robust Eq. 1: each row shrunk in delta space against the old
    global, ``row' = g + s_k * (row - g)``, then the masked weighted sum
    in order.

    stacked: (K, ...); weights, scales: (K,) f32; global_ref: (...).
    ``s_k == 1`` takes the row untouched (no arithmetic), and a zero
    weight contributes EXACT zero even when the row or its scale is
    non-finite — so all-ones scales give ``gather_combine_ref``'s sum
    over the same rows, bit for bit.
    """
    w = weights.float()
    s = scales.float()
    g = global_ref.float()
    acc = torch.zeros(stacked.shape[1:], dtype=torch.float32,
                      device=stacked.device)
    zero = torch.zeros((), dtype=torch.float32, device=stacked.device)
    for j in range(stacked.shape[0]):
        x = stacked[j].float()
        shrunk = torch.where(s[j] == 1.0, x, g + s[j] * (x - g))
        acc = acc + torch.where(w[j] != 0.0, shrunk * w[j], zero)
    return acc.to(stacked.dtype)


def server_opt_combine_ref(avg, old, m, v, consts):
    """Server aggregator step on the pseudo-gradient ``d = old - avg``.

    avg: (...) the Eq. 1 merged average; old: (...) the round-start
    global; m, v: (...) server-opt state; consts: (5,) f32 ``[kind,
    beta1, beta2, server_lr, eps]`` with kind 0 = identity (plain
    FedAvg), 1 = momentum (FedAvgM: ``m' = beta1*m + d; out = old -
    server_lr*m'``), 2 = adam (FedAdam, no bias correction: ``m' =
    beta1*m + (1-beta1)*d; v' = beta2*v + ((1-beta2)*d)*d; out = old -
    server_lr * m' / (sqrt(v') + eps)``). Returns ``(new_global, new_m,
    new_v)`` in the dtypes of ``avg``, ``m``, ``v``.

    Every operation is one f32 operation, rounded on its own, and
    ``1 - beta1`` / ``1 - beta2`` are f32 differences. Kind 0, and kind 1
    with ``beta1 == 0 and server_lr == 1``, take a passthrough select:
    the output is bitwise ``avg`` (``old - (old - avg)`` is not an
    IEEE-754 identity). Kind 2 has no inert setting.
    """
    c = torch.as_tensor(consts).to(device=avg.device, dtype=torch.float32)
    kind, b1, b2, slr, eps = c[0], c[1], c[2], c[3], c[4]
    a, o, mm, vv = avg.float(), old.float(), m.float(), v.float()
    one = torch.ones((), dtype=torch.float32, device=avg.device)
    d = o - a
    scale1 = torch.where(kind == 2.0, one - b1, one)
    nm = torch.where(kind == 0.0, mm, b1 * mm + scale1 * d)
    nv = torch.where(kind == 2.0, b2 * vv + (one - b2) * d * d, vv)
    step = torch.where(kind == 2.0, nm / (torch.sqrt(nv) + eps), nm)
    inert = (kind == 0.0) | ((kind == 1.0) & (b1 == 0.0) & (slr == 1.0))
    out = torch.where(inert, a, o - slr * step)
    return out.to(avg.dtype), nm.to(m.dtype), nv.to(v.dtype)


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
