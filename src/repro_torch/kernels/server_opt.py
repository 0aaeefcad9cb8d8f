"""CUDA kernel binding: the objectives layer's server aggregator step
(FedAvgM / FedAdam on the pseudo-gradient ``d = old - avg``).

Counterpart of ``repro/kernels/server_opt.py``; the kernel is
``csrc/server_opt.cu``. One launch per leaf of the global.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.build import (check_launch, dtype_code,
                                       launch_stream, library)


def server_opt_cuda(avg: torch.Tensor, old: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, consts: np.ndarray):
    """``avg``, ``old``, ``m``, ``v``: one shape and dtype (f32/bf16),
    contiguous, on one CUDA device; ``consts``: five host f32 values
    ``[kind, beta1, beta2, server_lr, eps]``, passed by value. Returns
    fresh ``(out, m', v')``."""
    for name, t in (("avg", avg), ("old", old), ("m", m), ("v", v)):
        if not t.is_cuda or t.device != avg.device:
            raise ValueError(f"server_opt: {name} is not on {avg.device}")
        if t.shape != avg.shape or t.dtype != avg.dtype:
            raise ValueError(
                f"server_opt: {name} {tuple(t.shape)} {t.dtype} vs avg "
                f"{tuple(avg.shape)} {avg.dtype}")
        if not t.is_contiguous():
            raise ValueError("server_opt: operands must be contiguous")
    c = np.asarray(consts, np.float32)
    if c.shape != (5,):
        raise ValueError(f"server_opt: consts must be (5,), got {c.shape}")
    code = dtype_code(avg.dtype)
    out, nm, nv = (torch.empty_like(avg) for _ in range(3))
    rc = library("server_opt").repro_server_opt(
        avg.data_ptr(), old.data_ptr(), m.data_ptr(), v.data_ptr(),
        out.data_ptr(), nm.data_ptr(), nv.data_ptr(), *map(float, c),
        avg.numel(), code, launch_stream(avg))
    check_launch(rc, "server_opt")
    return out, nm, nv
