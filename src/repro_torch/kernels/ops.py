"""Wrappers choosing the CUDA kernel or its plain version — by where
the tensor lies, and by nothing else.

Dispatch policy:
  * a CUDA tensor launches the hand-written kernel (``csrc/*.cu``, built
    at first use by ``build.py``) or raises; it never reaches a plain
    version — there is no flag, no environment switch and no ``try``
    that reroutes it;
  * a CPU tensor takes the plain PyTorch version in ``ref.py`` (the CPU
    tests run the whole port this way).

``LAUNCHES[name]`` counts kernel launches per wrapper: one is added
exactly where a wrapper launches its kernel, nowhere else, so a run can
show that a path really went through the kernels.

Kernels, one wrapper each: ``fused_sgd_leaves`` (the local step, every
leaf in one launch; ``fused_sgd`` is its one-leaf case),
``delta_norm_leaves`` (Eq. 2 and the fault guard's clip, every leaf in
one launch; ``delta_norm`` / ``delta_norm_stacked`` are its one-leaf
cases), ``gather_combine`` and ``fedavg_combine`` (Eq. 1),
``aircomp_combine`` / ``aircomp_combine_weighted`` (the channel layer's
over-the-air merge, from alphas or from weights formed once a merge),
``robust_combine`` (the fault layer's guarded merge),
``server_opt_leaves`` (the objectives layer's FedAvgM / FedAdam server
step, every leaf in one launch; ``server_opt_combine`` is its one-leaf
case), ``contention_loop`` (a whole CSMA contention attempt, the
persistent event-loop kernel) and ``contention_event`` (the three
per-event CSMA passes), ``token_sum`` (the LLM local step's sums
over a user's tokens in one fixed tree; ``models/layers.py::token_sum``
wraps it for autograd and ``vmap``), and ``conv_pool`` /
``conv_pool_grad`` (the paper CNN's first block, conv1, bias, ReLU and
the 2x2 max-pool, over a stacked cohort, and its weight and bias
gradients; ``models/paper_models.py::conv_pool`` wraps the pair for
autograd and ``vmap``).

No op of the reference's kernels is differentiated, so none of those
has a backward kernel, and ``token_sum``'s backward is a broadcast; the
port's own first CNN block is the one op with a backward kernel,
``conv_pool_grad``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.aircomp import aircomp_cuda
from repro_torch.kernels.conv_pool import conv_pool_cuda, conv_pool_grad_cuda
from repro_torch.kernels.contention import (_contend_device,
                                            contention_expiry_cuda,
                                            contention_loop_cuda,
                                            contention_min_cuda,
                                            contention_transition_cuda,
                                            counter_uniform)
from repro_torch.kernels import delta_norm as kdn, server_opt as kso
from repro_torch.kernels.fedavg import fedavg_cuda
from repro_torch.kernels.fused_sgd import (fused_sgd_leaves_cuda_,
                                           max_leaves as fused_sgd_max_leaves)
from repro_torch.kernels.gather import gather_combine_cuda
from repro_torch.kernels.robust import robust_cuda
from repro_torch.kernels.token_sum import token_sum_cuda

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {"fused_sgd": 0, "delta_norm": 0,
                            "gather_combine": 0, "fedavg_combine": 0,
                            "contention_min": 0, "contention_expiry": 0,
                            "contention_transition": 0,
                            "contention_loop": 0,
                            "aircomp_combine": 0, "robust_combine": 0,
                            "server_opt": 0, "token_sum": 0,
                            "conv_pool": 0, "conv_pool_grad": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on(device, x, dtype):
    """``x`` (numpy array, sequence or tensor) as a contiguous ``dtype``
    tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device=device, dtype=dtype).contiguous()


def _check_idx(idx, S, name):
    """Host-side range check of a gather index (a device index is
    checked by the kernel, which traps)."""
    if not isinstance(idx, torch.Tensor) or not idx.is_cuda:
        i_host = np.asarray(idx)
        if i_host.size and (i_host.min() < 0 or i_host.max() >= S):
            raise IndexError(f"{name}: idx outside [0, {S})")


def delta_norm_leaves(stacks, globs):
    """Eq. 2's reduction for every leaf of a model at once: ``stacks[l]``
    (U, ...) against ``globs[l]`` (...) -> ``(d2 (L, U), g2 (L,))`` f32,
    ``d2[l, u] = ||stacks[l][u] - globs[l]||^2``, ``g2[l] =
    ||globs[l]||^2``. One U, dtype and device for the list. On CUDA
    tensors it is ONE launch for up to ``max_leaves()`` (32) leaves; on
    CPU tensors the plain version, leaf by leaf."""
    stacks, globs = list(stacks), list(globs)
    kdn.check_leaves(stacks, globs)
    if not stacks[0].is_cuda:
        return ref.delta_norm_leaves_ref(stacks, globs)
    step = kdn.max_leaves()
    parts = []
    for i in range(0, len(stacks), step):
        parts.append(kdn.delta_norm_leaves_cuda(stacks[i:i + step],
                                                globs[i:i + step]))
        LAUNCHES["delta_norm"] += 1
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([d2 for d2, _ in parts]),
            torch.cat([g2 for _, g2 in parts]))


def token_sum(x):
    """``x`` (R, N, C) f32 -> ``(R, C)``, each column's N values summed
    in one fixed tree (``ref.token_sum_ref``) whose order follows N
    alone: a row's bits do not depend on R or C. On a CUDA tensor ONE
    launch, bit-equal to the plain version; on a CPU tensor the plain
    version."""
    if not x.is_cuda:
        return ref.token_sum_ref(x)
    out = token_sum_cuda(x.contiguous())
    LAUNCHES["token_sum"] += 1
    return out


def conv_pool(x, w, b):
    """The paper CNN's first block, ``maxpool2x2(relu(conv5x5_same(x, w)
    + b))``: ``x`` (B, H, W, C) NHWC, ``w`` (5, 5, C, O) HWIO, ``b`` (O,)
    -> ``(out, codes)`` (B, O, H/2, W/2), or a stack of each — ``x`` (R,
    B, H, W, C), ``w`` (R, 5, 5, C, O), ``b`` (R, O) -> (B, R, O, H/2,
    W/2). ``codes`` (uint8) name each pooled output's winner in its 2x2
    window (dy * 2 + dx, the first maximum in row-major order), 4 where
    the maximum is <= 0. f32. On a CUDA tensor ONE launch; on a CPU
    tensor the plain version (``F.conv2d``, the bias, ``F.relu``,
    ``F.max_pool2d``)."""
    if not x.is_cuda:
        return ref.conv_pool_ref(x, w, b)
    one = x.dim() == 4
    if one:
        x, w, b = x.unsqueeze(0), w.unsqueeze(0), b.unsqueeze(0)
    out, codes = conv_pool_cuda(x, w, b)
    if out.numel():  # R or B == 0 launches nothing
        LAUNCHES["conv_pool"] += 1
    return (out[:, 0], codes[:, 0]) if one else (out, codes)


def conv_pool_grad(g, x, w, b, codes):
    """``conv_pool``'s weight and bias gradients for a cotangent ``g`` of
    its output -> ``(dw, db)`` in ``w``'s and ``b``'s shapes (no gradient
    for the data ``x``). On a CUDA tensor ONE launch from ``codes`` (``w``
    and ``b`` are not read), each user's sums in a fixed order that
    follows (B, H, W, C) alone; on a CPU tensor the plain version, the
    vjp of ``conv_pool``'s (``codes`` not read)."""
    if not g.is_cuda:
        return ref.conv_pool_grad_ref(g, x, w, b)
    one = x.dim() == 4
    if one:
        g, x, codes = g.unsqueeze(1), x.unsqueeze(0), codes.unsqueeze(1)
    dw, db = conv_pool_grad_cuda(g, x, codes)
    if g.numel():  # R or B == 0 launches nothing
        LAUNCHES["conv_pool_grad"] += 1
    return (dw[0], db[0]) if one else (dw, db)


def delta_norm(w_local, w_global):
    """(||w_local - w_global||^2, ||w_global||^2) as two f32 scalars;
    operands of equal shape (the reference's two-operand entry)."""
    if w_local.shape != w_global.shape:
        raise ValueError(
            f"delta_norm: shapes differ ({tuple(w_local.shape)} vs "
            f"{tuple(w_global.shape)}); use delta_norm_stacked for a "
            "(U, ...) stack")
    if w_local.is_cuda:
        d2, g2 = delta_norm_leaves([w_local.unsqueeze(0)], [w_global])
        return d2[0, 0], g2[0]
    return ref.delta_norm_ref(w_local, w_global)


def delta_norm_stacked(stack, w_global):
    """``delta_norm_leaves`` of one leaf: ``stack`` (U, ...) against
    ``w_global`` (...) -> ``(d2 (U,), g2 ())`` f32."""
    if stack.is_cuda:
        d2, g2 = delta_norm_leaves([stack], [w_global])
        return d2[0], g2[0]
    return ref.delta_norm_stacked_ref(stack, w_global)


def fedavg_combine(stacked, alphas):
    """``sum_k alpha_k * stacked[k]`` in the stack's dtype; a zero alpha
    masks its row to exact zero even when the row is non-finite."""
    a = _on(stacked.device, alphas, torch.float32)
    if stacked.is_cuda:
        out = fedavg_cuda(stacked, a)
        LAUNCHES["fedavg_combine"] += 1
        return out
    return ref.fedavg_combine_ref(stacked, a)


def gather_combine(stacked, idx, weights, glob):
    """Winner-sparse Eq. 1: gather the rows at ``idx`` out of a
    (S, ...) stack and reduce them, in delivery order, under (K,) merge
    weights, keeping ``glob`` when no weight is nonzero.

    One op for both merge formulations: winner ids into the full
    (U, ...) trained stack, or positions into a compact (K_max, ...)
    stack — the reduce sees the same gathered rows either way and the
    results are bit-identical. ``idx`` / ``weights`` may be host arrays
    (validated here, then copied to the stack's device) or tensors
    already on it (the kernel traps on an index outside [0, S)).
    """
    _check_idx(idx, stacked.shape[0], "gather_combine")
    i = _on(stacked.device, idx, torch.int32)
    w = _on(stacked.device, weights, torch.float32)
    if stacked.is_cuda:
        out = gather_combine_cuda(stacked, i, w, glob)
        LAUNCHES["gather_combine"] += 1
        return out
    return ref.gather_combine_ref(stacked, i, w, glob)


def aircomp_weights(alphas, coeffs, device):
    """The AirComp wrapper's weight and scale algebra, on ``device``:
    ``w = a * c`` and ``scale = sum(a) / sum(w)`` (1.0 when
    ``sum(w) == 0``, and when ``coeffs`` is None, which means perfect
    power control: ``w = a``). Both sums are the same reduction over
    equal-length vectors, so unit coefficients give ``scale == 1.0``
    exactly. Returns ``(w (K,) f32, scale (1,) f32)``; no host sync."""
    a = _on(device, alphas, torch.float32)
    if coeffs is None:
        return a, torch.ones(1, dtype=torch.float32, device=device)
    w = a * _on(device, coeffs, torch.float32)
    sa, sw = a.sum(), w.sum()
    nz = sw != 0.0
    scale = torch.where(nz, sa / torch.where(nz, sw, torch.ones_like(sw)),
                        torch.ones_like(sw))
    return w, scale.reshape(1)


def aircomp_combine(stacked, alphas, coeffs=None, noise=None, *, idx=None):
    """AirComp analog over-the-air Eq. 1: ``(sum_j w_j * row_j + noise)
    * scale`` with ``w``, ``scale`` from ``aircomp_weights``.

    stacked: (S, ...); idx: (K,) row indices into it in delivery order,
    or None for rows 0..K-1 of a (K, ...) stack; alphas: (K,) Eq. 1
    weights; coeffs: (K,) misalignment coefficients in (0, 1] or None;
    noise: the receiver-noise plane of the output shape, already scaled
    to its post-processing std, or None / 0.0 for none. A zero alpha
    masks its row (never read). With unit coefficients and no noise the
    result is ``gather_combine``'s over the same rows, bit for bit.
    """
    w, scale = aircomp_weights(alphas, coeffs, stacked.device)
    return aircomp_combine_weighted(stacked, w, scale, noise, idx=idx)


def aircomp_combine_weighted(stacked, w, scale, noise=None, *, idx=None):
    """``aircomp_combine`` with its weights already formed: ``(w,
    scale)`` as ``aircomp_weights`` returns them, so a merge that runs
    the kernel once per leaf forms them once."""
    dev = stacked.device
    i = None
    if idx is not None:
        _check_idx(idx, stacked.shape[0], "aircomp_combine")
        i = _on(dev, idx, torch.int32)
    nz = None
    if noise is not None and (isinstance(noise, torch.Tensor)
                              or np.any(np.asarray(noise) != 0.0)):
        nz = _on(dev, noise, torch.float32).expand(stacked.shape[1:]) \
            .contiguous()
    if stacked.is_cuda:
        out = aircomp_cuda(stacked, i, w, nz, scale)
        LAUNCHES["aircomp_combine"] += 1
        return out
    rows = stacked if i is None else torch.index_select(stacked, 0, i.long())
    return ref.aircomp_combine_ref(rows, w, nz, scale[0])


def robust_combine(stacked, weights, scales, global_ref):
    """Robust Eq. 1: per-row delta shrink against the old global, then
    the masked weighted sum in order. stacked: (K, ...); weights: (K,)
    merge weights (zero = masked row, EXACT zero even when non-finite);
    scales: (K,) shrink factors, ``row' = g + s_k * (row - g)`` (``s_k
    == 1``: the row untouched); global_ref: (...) the old global. With
    all-ones scales this is ``gather_combine``'s sum, bit for bit."""
    w = _on(stacked.device, weights, torch.float32)
    s = _on(stacked.device, scales, torch.float32)
    if stacked.is_cuda:
        out = robust_cuda(stacked, w, s, global_ref)
        LAUNCHES["robust_combine"] += 1
        return out
    return ref.robust_combine_ref(stacked, w, s, global_ref)


def server_opt_leaves(avgs, olds, ms, vs, consts):
    """The server aggregator step after Eq. 1 (see
    ``ref.server_opt_combine_ref``) for every leaf of the global:
    ``(new_globals, m's, v's)``, one list each, from the merged averages
    ``avgs``, the round-start global ``olds`` and the server-opt state
    ``ms``, ``vs`` (the four operands of a leaf of one shape; one dtype
    and device for the list). ``consts``: the five host values ``[kind,
    beta1, beta2, server_lr, eps]`` (numpy, a sequence or a CPU tensor)
    — the kernel takes them by value, so no merge reads a device scalar.
    Returns fresh tensors. On CUDA tensors it is ONE launch for up to
    ``max_leaves()`` (32) leaves; on CPU tensors the plain version, leaf
    by leaf."""
    avgs, olds, ms, vs = (list(x) for x in (avgs, olds, ms, vs))
    c = np.asarray(consts, np.float32)
    if c.shape != (5,):
        raise ValueError(f"server_opt: consts must be (5,), got {c.shape}")
    kso.check_leaves(avgs, olds, ms, vs)
    if avgs[0].is_cuda:
        out = ([], [], [])
        step = kso.max_leaves()
        for i in range(0, len(avgs), step):
            part = kso.server_opt_leaves_cuda(
                avgs[i:i + step], olds[i:i + step], ms[i:i + step],
                vs[i:i + step], c)
            LAUNCHES["server_opt"] += 1
            for acc, p in zip(out, part):
                acc.extend(p)
        return out
    ct = torch.from_numpy(c)
    rows = [ref.server_opt_combine_ref(a, o, m, v, ct)
            for a, o, m, v in zip(avgs, olds, ms, vs)]
    return tuple([r[i] for r in rows] for i in range(3))


def server_opt_combine(avg, old, m, v, consts):
    """``server_opt_leaves`` of one leaf: ``(new_global, m', v')``."""
    outs, nms, nvs = server_opt_leaves([avg], [old], [m], [v], consts)
    return outs[0], nms[0], nvs[0]


def fused_sgd_leaves(params, grads, lr):
    """SGD step ``p <- p - lr * g`` (f32 math, cast back) for every pair
    of the two equal-length lists, IN PLACE on each ``p``; returns
    ``params``. The reference returns new arrays and donates the old
    buffers; updating in place is the same saving said directly. On CUDA
    tensors it is ONE launch for up to ``max_leaves()`` (32) leaves, so a
    model's local step is one launch; on CPU tensors the plain version,
    leaf by leaf."""
    params, grads = list(params), list(grads)
    if len(params) != len(grads):
        raise ValueError(f"fused_sgd: {len(params)} params vs {len(grads)} "
                         "grads")
    if any(p.is_cuda or g.is_cuda for p, g in zip(params, grads)):
        step = fused_sgd_max_leaves()
        for i in range(0, len(params), step):
            fused_sgd_leaves_cuda_(params[i:i + step], grads[i:i + step], lr)
            LAUNCHES["fused_sgd"] += 1
        return params
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.copy_(ref.fused_sgd_ref(p, g, lr))
    return params


def fused_sgd(param, grad, lr):
    """``fused_sgd_leaves`` of one leaf: ``param <- param - lr * grad``
    in place; returns ``param``."""
    fused_sgd_leaves([param], [grad], lr)
    return param


def contention_event(counters, live, doublings, windows, rand,
                     max_doublings: int):
    """One batched CSMA medium event (see ``ref.contention_event_ref``):
    ``(step, nexp, winner, new_counters, new_doublings, new_active)``.
    On a CUDA device it is three launches, one per pass. Operands are
    taken as int32 / bool / f32, contiguous; ``max_doublings`` in
    [0, 30] (a window doubled further is past the 2^29 clamp)."""
    if not 0 <= max_doublings <= 30:
        raise ValueError(f"max_doublings={max_doublings} outside [0, 30]")
    cnt = counters.to(torch.int32).contiguous()
    liv = live.to(torch.bool).contiguous()
    dbl = doublings.to(torch.int32).contiguous()
    win = windows.to(torch.float32).contiguous()
    rnd = rand.to(torch.float32).contiguous()
    if cnt.is_cuda:
        step = contention_min_cuda(cnt, liv)
        LAUNCHES["contention_min"] += 1
        nexp, winner = contention_expiry_cuda(cnt, liv, step)
        LAUNCHES["contention_expiry"] += 1
        out = contention_transition_cuda(cnt, liv, dbl, win, rnd, step, nexp,
                                         max_doublings)
        LAUNCHES["contention_transition"] += 1
        return (step, nexp, winner) + out
    return ref.contention_event_ref(cnt, liv, dbl, win, rnd, max_doublings)


def contention_loop(pool_exp, pool_win, pool_idx, threshold, k_arr, *,
                    k_max: int, tx_slots: int, max_doublings: int,
                    max_sim_slots: int, key: int):
    """One contention attempt over (B, M) candidate pools (int32 absolute
    expiries, f32 windows, int32 user ids; (B,) int32 thresholds and k):
    the whole event loop, redraws from ``counter_uniform`` under ``key``.
    Returns the packed (B, 5 + 2 k_max) int32 result (see
    ``contention.HEAD``). On a CUDA device it is ONE launch of the
    persistent kernel; on the CPU the Python loop with the plain event
    op, which draws the same numbers."""
    if not 0 <= max_doublings <= 30:
        raise ValueError(f"max_doublings={max_doublings} outside [0, 30]")
    kw = dict(k_max=k_max, tx_slots=tx_slots, max_doublings=max_doublings,
              max_sim_slots=max_sim_slots)
    if pool_exp.is_cuda:
        out = contention_loop_cuda(pool_exp, pool_win, pool_idx, threshold,
                                   k_arr, key=key, **kw)
        LAUNCHES["contention_loop"] += 1
        return out
    dev = pool_exp.device
    return _contend_device(
        pool_exp, pool_win, pool_idx, threshold, k_arr,
        draw=lambda ev, B, M: counter_uniform(key, ev, B, M, dev),
        event_op=ref.contention_event_ref, **kw)
