"""CUDA kernel binding: the fault layer's robust Eq. 1 combine
``out = sum_k w_k * (s_k == 1 ? x_k : g + s_k * (x_k - g))``.

Counterpart of ``repro/kernels/robust.py``; the kernel is
``csrc/combine.cu`` (``repro_robust_combine``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (check_launch, dtype_code,
                                       launch_stream, library)


def robust_cuda(stacked: torch.Tensor, weights: torch.Tensor,
                scales: torch.Tensor,
                global_ref: torch.Tensor) -> torch.Tensor:
    """``stacked``: (K, ...) contiguous CUDA f32/bf16; ``weights`` and
    ``scales``: (K,) f32; ``global_ref``: (...) in the stack's dtype.
    All on one device. Returns a fresh (...) tensor."""
    if not stacked.is_cuda:
        raise ValueError("robust_combine: stacked must be a CUDA tensor")
    for name, t in (("weights", weights), ("scales", scales),
                    ("global_ref", global_ref)):
        if not t.is_cuda or t.device != stacked.device:
            raise ValueError(
                f"robust_combine: {name} is not on {stacked.device}")
    if weights.dtype != torch.float32 or scales.dtype != torch.float32:
        raise ValueError("robust_combine: weights and scales must be f32")
    if stacked.dim() < 1 or weights.shape != (stacked.shape[0],) \
            or scales.shape != weights.shape:
        raise ValueError("robust_combine: weights and scales must be (K,) "
                         f"for a stack of {tuple(stacked.shape)}")
    if stacked.shape[1:] != global_ref.shape \
            or stacked.dtype != global_ref.dtype:
        raise ValueError(
            f"robust_combine: stack {tuple(stacked.shape)} {stacked.dtype} "
            f"vs global {tuple(global_ref.shape)} {global_ref.dtype}")
    if not all(t.is_contiguous()
               for t in (stacked, weights, scales, global_ref)):
        raise ValueError("robust_combine: operands must be contiguous")
    code = dtype_code(stacked.dtype)
    out = torch.empty_like(global_ref)
    rc = library("combine").repro_robust_combine(
        stacked.data_ptr(), weights.data_ptr(), scales.data_ptr(),
        global_ref.data_ptr(), out.data_ptr(), stacked.shape[0],
        global_ref.numel(), code, launch_stream(stacked))
    check_launch(rc, "robust_combine")
    return out
