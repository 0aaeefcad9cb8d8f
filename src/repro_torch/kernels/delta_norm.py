"""CUDA kernel binding: the Eq. 2 reduction over a stacked cohort.

Counterpart of ``repro/kernels/delta_norm.py``; the kernel is
``csrc/delta_norm.cu``. The entry is batched: ``(U, n)`` local models
against one ``(n,)`` global give ``d2 (U,)`` and one ``g2``; the
reference's two-operand call is the ``U = 1`` case.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (check_launch, dtype_code,
                                       launch_stream, library)


def delta_norm_cuda(stack: torch.Tensor, glob: torch.Tensor):
    """``stack``: (U, ...) contiguous CUDA f32/bf16; ``glob``: (...) of
    the same dtype. Returns ``(d2 (U,) f32, g2 () f32)``."""
    if not (stack.is_cuda and glob.is_cuda and stack.device == glob.device):
        raise ValueError("delta_norm: operands must share a CUDA device")
    if stack.dtype != glob.dtype:
        raise ValueError(
            f"delta_norm: dtypes differ ({stack.dtype} vs {glob.dtype})")
    if stack.dim() < 1 or stack.shape[1:] != glob.shape:
        raise ValueError(
            f"delta_norm: stack {tuple(stack.shape)} is not (U,) + glob "
            f"{tuple(glob.shape)}")
    if not (stack.is_contiguous() and glob.is_contiguous()):
        raise ValueError("delta_norm: operands must be contiguous")
    U, n = stack.shape[0], glob.numel()
    if not 1 <= U <= 65535:
        raise ValueError(f"delta_norm: U={U} outside [1, 65535]")
    code = dtype_code(stack.dtype)
    lib = library("delta_norm")
    blocks = lib.repro_delta_norm_blocks(n)
    # one allocation: the first U + 1 floats take the results, the other
    # (U + 1) * blocks the per-block partials of the first pass
    buf = torch.empty(((U + 1) * (blocks + 1),), dtype=torch.float32,
                      device=stack.device)
    rc = lib.repro_delta_norm(
        stack.data_ptr(), glob.data_ptr(), buf[U + 1:].data_ptr(),
        buf.data_ptr(), U, n, code, launch_stream(stack))
    check_launch(rc, "delta_norm")
    return buf[:U], buf[U]
