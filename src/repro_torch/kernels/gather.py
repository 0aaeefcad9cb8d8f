"""CUDA kernel binding: the gather-K Eq. 1 combine.

Counterpart of ``repro/kernels/gather.py``; the kernel is
``csrc/combine.cu`` (shared with ``fedavg.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (check_launch, dtype_code,
                                       launch_stream, library)


def gather_combine_cuda(stacked: torch.Tensor, idx: torch.Tensor,
                        weights: torch.Tensor,
                        glob: torch.Tensor) -> torch.Tensor:
    """``stacked``: (S, ...) contiguous CUDA f32/bf16; ``idx``: (K,)
    int32 and ``weights``: (K,) f32, both on the same device; ``glob``:
    (...) in the stack's dtype. Returns a fresh (...) tensor."""
    for name, t in (("idx", idx), ("weights", weights), ("glob", glob)):
        if not t.is_cuda or t.device != stacked.device:
            raise ValueError(
                f"gather_combine: {name} is not on {stacked.device}")
    if not stacked.is_cuda:
        raise ValueError("gather_combine: stacked must be a CUDA tensor")
    if idx.dtype != torch.int32 or weights.dtype != torch.float32:
        raise ValueError("gather_combine: idx must be int32, weights f32")
    if idx.dim() != 1 or idx.shape != weights.shape:
        raise ValueError("gather_combine: idx and weights must be (K,)")
    if stacked.dim() < 1 or stacked.shape[0] < 1 \
            or stacked.shape[1:] != glob.shape or stacked.dtype != glob.dtype:
        raise ValueError(
            f"gather_combine: stack {tuple(stacked.shape)} {stacked.dtype} "
            f"vs glob {tuple(glob.shape)} {glob.dtype}")
    if not all(t.is_contiguous() for t in (stacked, idx, weights, glob)):
        raise ValueError("gather_combine: operands must be contiguous")
    code = dtype_code(stacked.dtype)
    out = torch.empty_like(glob)
    rc = library("combine").repro_gather_combine(
        stacked.data_ptr(), idx.data_ptr(), weights.data_ptr(),
        glob.data_ptr(), out.data_ptr(), stacked.shape[0], idx.shape[0],
        glob.numel(), code, launch_stream(stacked))
    check_launch(rc, "gather_combine")
    return out
