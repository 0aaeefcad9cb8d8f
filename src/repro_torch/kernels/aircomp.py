"""CUDA kernel binding: the AirComp over-the-air merge
``out = (sum_j w_j * stack[idx_j] + noise) * scale``.

Counterpart of ``repro/kernels/aircomp.py``; the kernel is
``csrc/combine.cu`` (``repro_aircomp_combine``). Unlike the reference
entry it can read the rows straight out of a ``(S, ...)`` stack through
``idx``, so the fused merge needs no gathered copy of the winners.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import (check_launch, dtype_code,
                                       launch_stream, library)


def aircomp_cuda(stacked: torch.Tensor, idx: Optional[torch.Tensor],
                 weights: torch.Tensor, noise: Optional[torch.Tensor],
                 scale: torch.Tensor) -> torch.Tensor:
    """``stacked``: (S, ...) contiguous CUDA f32/bf16; ``idx``: (K,)
    int32 row indices, or None for rows 0..K-1 (then S == K);
    ``weights``: (K,) f32; ``noise``: f32 plane of the output shape, or
    None for none; ``scale``: one f32 element. All on the stack's
    device. Returns a fresh (...) tensor in the stack's dtype."""
    if not stacked.is_cuda:
        raise ValueError("aircomp_combine: stacked must be a CUDA tensor")
    operands = [("weights", weights, torch.float32), ("scale", scale,
                                                      torch.float32)]
    if idx is not None:
        operands.append(("idx", idx, torch.int32))
    if noise is not None:
        operands.append(("noise", noise, torch.float32))
    for name, t, dt in operands:
        if not t.is_cuda or t.device != stacked.device:
            raise ValueError(
                f"aircomp_combine: {name} is not on {stacked.device}")
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"aircomp_combine: {name} must be contiguous {dt}")
    if stacked.dim() < 1 or stacked.shape[0] < 1 \
            or not stacked.is_contiguous():
        raise ValueError(f"aircomp_combine: stack {tuple(stacked.shape)} "
                         "must be a contiguous (S, ...) stack")
    K = weights.shape[0]
    if weights.dim() != 1 or (idx is not None and idx.shape != weights.shape) \
            or (idx is None and K != stacked.shape[0]):
        raise ValueError("aircomp_combine: weights (and idx) must be (K,), "
                         "K = the stack's length without idx")
    if noise is not None and noise.shape != stacked.shape[1:]:
        raise ValueError(f"aircomp_combine: noise {tuple(noise.shape)} vs "
                         f"output {tuple(stacked.shape[1:])}")
    if scale.numel() != 1:
        raise ValueError("aircomp_combine: scale must hold one element")
    code = dtype_code(stacked.dtype)
    out = torch.empty(stacked.shape[1:], dtype=stacked.dtype,
                      device=stacked.device)
    rc = library("combine").repro_aircomp_combine(
        stacked.data_ptr(), None if idx is None else idx.data_ptr(),
        weights.data_ptr(), None if noise is None else noise.data_ptr(),
        scale.data_ptr(), out.data_ptr(), stacked.shape[0], K, out.numel(),
        code, launch_stream(stacked))
    check_launch(rc, "aircomp_combine")
    return out
