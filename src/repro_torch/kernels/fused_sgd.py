"""CUDA kernel binding: fused SGD update ``p <- p - lr * g`` in place.

Counterpart of ``repro/kernels/fused_sgd.py``; the kernel is
``csrc/fused_sgd.cu``. One launch covers a whole tensor of any shape —
in the fused round, the stacked ``(U, ...)`` leaf of the cohort.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (check_launch, dtype_code,
                                       launch_stream, library)


def fused_sgd_cuda_(param: torch.Tensor, grad: torch.Tensor,
                    lr: float) -> torch.Tensor:
    """In place on ``param`` (contiguous CUDA f32/bf16); returns it."""
    if not (param.is_cuda and grad.is_cuda and param.device == grad.device):
        raise ValueError("fused_sgd: param and grad must share a CUDA device")
    if param.dtype != grad.dtype or param.shape != grad.shape:
        raise ValueError(
            f"fused_sgd: param {tuple(param.shape)} {param.dtype} vs grad "
            f"{tuple(grad.shape)} {grad.dtype}")
    if not (param.is_contiguous() and grad.is_contiguous()):
        raise ValueError("fused_sgd: operands must be contiguous")
    code = dtype_code(param.dtype)
    rc = library("fused_sgd").repro_fused_sgd(
        param.data_ptr(), grad.data_ptr(), float(lr), param.numel(), code,
        launch_stream(param))
    check_launch(rc, "fused_sgd")
    return param
