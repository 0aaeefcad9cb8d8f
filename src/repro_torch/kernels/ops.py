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

No op is differentiated in the reference, so none has a backward
kernel.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.contention import (contention_expiry_cuda,
                                            contention_min_cuda,
                                            contention_transition_cuda)
from repro_torch.kernels.delta_norm import delta_norm_cuda
from repro_torch.kernels.fedavg import fedavg_cuda
from repro_torch.kernels.fused_sgd import fused_sgd_cuda_
from repro_torch.kernels.gather import gather_combine_cuda

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {"fused_sgd": 0, "delta_norm": 0,
                            "gather_combine": 0, "fedavg_combine": 0,
                            "contention_min": 0, "contention_expiry": 0,
                            "contention_transition": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on(device, x, dtype):
    """``x`` (numpy array, sequence or tensor) as a contiguous ``dtype``
    tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device=device, dtype=dtype).contiguous()


def delta_norm(w_local, w_global):
    """(||w_local - w_global||^2, ||w_global||^2) as two f32 scalars;
    operands of equal shape (the reference's two-operand entry)."""
    if w_local.shape != w_global.shape:
        raise ValueError(
            f"delta_norm: shapes differ ({tuple(w_local.shape)} vs "
            f"{tuple(w_global.shape)}); use delta_norm_stacked for a "
            "(U, ...) stack")
    if w_local.is_cuda:
        d2, g2 = delta_norm_cuda(w_local.unsqueeze(0), w_global)
        LAUNCHES["delta_norm"] += 1
        return d2[0], g2
    return ref.delta_norm_ref(w_local, w_global)


def delta_norm_stacked(stack, w_global):
    """Eq. 2's reduction for a whole cohort in ONE launch: ``stack``
    (U, ...) against ``w_global`` (...) -> ``(d2 (U,), g2 ())`` f32."""
    if stack.is_cuda:
        out = delta_norm_cuda(stack, w_global)
        LAUNCHES["delta_norm"] += 1
        return out
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
    if not isinstance(idx, torch.Tensor) or not idx.is_cuda:
        i_host = np.asarray(idx)
        if i_host.size and (i_host.min() < 0
                            or i_host.max() >= stacked.shape[0]):
            raise IndexError(
                f"gather_combine: idx outside [0, {stacked.shape[0]})")
    i = _on(stacked.device, idx, torch.int32)
    w = _on(stacked.device, weights, torch.float32)
    if stacked.is_cuda:
        out = gather_combine_cuda(stacked, i, w, glob)
        LAUNCHES["gather_combine"] += 1
        return out
    return ref.gather_combine_ref(stacked, i, w, glob)


def fused_sgd(param, grad, lr):
    """SGD step ``param <- param - lr * grad`` (f32 math, cast back),
    IN PLACE on ``param``, which is returned. The reference returns a
    new array and donates the old buffer; updating in place is the same
    saving said directly."""
    if param.is_cuda:
        fused_sgd_cuda_(param, grad, lr)
        LAUNCHES["fused_sgd"] += 1
        return param
    with torch.no_grad():
        param.copy_(ref.fused_sgd_ref(param, grad, lr))
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
