"""CUDA kernel binding: fused SGD update ``p <- p - lr * g`` in place,
for a whole list of leaves in one launch.

Counterpart of ``repro/kernels/fused_sgd.py``; the kernel is
``csrc/fused_sgd.cu``. One launch covers up to ``max_leaves()`` tensors
of any shapes — in the fused round, every stacked ``(U, ...)`` leaf of
the cohort, so a local step is one launch. The leaves' pointers and
sizes go to the kernel by value, with no host-to-device copy.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels.build import (check_launch, dtype_code,
                                       launch_stream, library)


def max_leaves() -> int:
    """The most leaves one launch takes (a longer list takes more)."""
    return library("fused_sgd").repro_fused_sgd_max_leaves()


def fused_sgd_leaves_cuda_(params: Sequence[torch.Tensor],
                           grads: Sequence[torch.Tensor],
                           lr: float) -> None:
    """ONE launch, in place on every ``params[i]`` (contiguous CUDA
    f32/bf16, one dtype and device for the list, at most
    ``max_leaves()`` of them, at least one) from ``grads[i]`` of the same
    shape."""
    if len(params) != len(grads) or not 0 < len(params) <= max_leaves():
        raise ValueError(f"fused_sgd: {len(params)} params and {len(grads)} "
                         f"grads; one launch takes 1 to {max_leaves()}")
    dev, dt = params[0].device, params[0].dtype
    for p, g in zip(params, grads):
        if not (p.is_cuda and g.is_cuda and p.device == dev
                and g.device == dev):
            raise ValueError("fused_sgd: every param and grad must lie on "
                             f"{dev}, a CUDA device")
        if p.dtype != dt or g.dtype != dt or p.shape != g.shape:
            raise ValueError(
                f"fused_sgd: param {tuple(p.shape)} {p.dtype} vs grad "
                f"{tuple(g.shape)} {g.dtype} (the list is {dt})")
        if not (p.is_contiguous() and g.is_contiguous()):
            raise ValueError("fused_sgd: operands must be contiguous")
    k = len(params)
    rc = library("fused_sgd").repro_fused_sgd_leaves(
        (ctypes.c_void_p * k)(*(p.data_ptr() for p in params)),
        (ctypes.c_void_p * k)(*(g.data_ptr() for g in grads)),
        (ctypes.c_longlong * k)(*(p.numel() for p in params)),
        k, float(lr), dtype_code(dt), launch_stream(params[0]))
    check_launch(rc, "fused_sgd")
