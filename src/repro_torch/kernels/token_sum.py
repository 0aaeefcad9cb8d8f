"""CUDA kernel binding: the fixed-order token sum of the LLM local step.

The kernel is ``csrc/token_sum.cu``; no reference kernel stands behind
it (the reference's sums over a user's tokens are XLA's). It sums a
``(R, N, C)`` f32 tensor over N in the adjacent-pair tree of
``ref.token_sum_ref``, bit for bit, so row r's result follows its N
values alone and not R or C: a user's loss and norm gradients keep
their bits whether the local step stacks 10 users or a sweep's 30.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, launch_stream, library


def token_sum_cuda(x: torch.Tensor) -> torch.Tensor:
    """ONE launch: ``x`` (R, N, C) contiguous CUDA f32 -> ``(R, C)`` f32,
    each column's N values summed in the fixed tree."""
    if x.dim() != 3 or not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f"token_sum: takes a (R, N, C) CUDA float32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("token_sum: the operand must be contiguous")
    R, N, C = x.shape
    out = torch.empty((R, C), dtype=torch.float32, device=x.device)
    if R == 0 or C == 0:
        return out
    rc = library("token_sum").repro_token_sum(
        x.data_ptr(), out.data_ptr(), R, N, C, launch_stream(x))
    check_launch(rc, "token_sum")
    return out
