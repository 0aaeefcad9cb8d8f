"""CUDA kernel binding: the FedAvg combine ``sum_k alpha_k * x_k``.

Counterpart of ``repro/kernels/fedavg.py``; the kernel is
``csrc/combine.cu`` (shared with ``gather.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (check_launch, dtype_code,
                                       launch_stream, library)


def fedavg_cuda(stacked: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """``stacked``: (K, ...) contiguous CUDA f32/bf16; ``alphas``: (K,)
    f32 on the same device. Returns a fresh (...) tensor."""
    if not (stacked.is_cuda and alphas.is_cuda
            and stacked.device == alphas.device):
        raise ValueError("fedavg_combine: operands must share a CUDA device")
    if alphas.dtype != torch.float32 or alphas.dim() != 1 \
            or stacked.dim() < 1 or alphas.shape[0] != stacked.shape[0] \
            or stacked.shape[0] < 1:
        raise ValueError(
            f"fedavg_combine: stack {tuple(stacked.shape)} vs alphas "
            f"{tuple(alphas.shape)} {alphas.dtype}")
    if not (stacked.is_contiguous() and alphas.is_contiguous()):
        raise ValueError("fedavg_combine: operands must be contiguous")
    code = dtype_code(stacked.dtype)
    out = torch.empty(stacked.shape[1:], dtype=stacked.dtype,
                      device=stacked.device)
    rc = library("combine").repro_fedavg_combine(
        stacked.data_ptr(), alphas.data_ptr(), out.data_ptr(),
        stacked.shape[0], out.numel(), code, launch_stream(stacked))
    check_launch(rc, "fedavg_combine")
    return out
