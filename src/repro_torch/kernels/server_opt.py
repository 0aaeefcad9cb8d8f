"""CUDA kernel binding: the objectives layer's server aggregator step
(FedAvgM / FedAdam on the pseudo-gradient ``d = old - avg``) for every
leaf of the global.

Counterpart of ``repro/kernels/server_opt.py``; the kernel is
``csrc/server_opt.cu``. One launch covers up to ``max_leaves()`` leaves;
their pointers and sizes, and the five constants, go to the kernel by
value.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.build import (check_launch, dtype_code,
                                       launch_stream, library)


def max_leaves() -> int:
    """The most leaves one launch takes (a longer list takes more)."""
    return library("server_opt").repro_server_opt_max_leaves()


def check_leaves(avgs: Sequence[torch.Tensor], olds: Sequence[torch.Tensor],
                 ms: Sequence[torch.Tensor],
                 vs: Sequence[torch.Tensor]) -> None:
    """Raise unless the four lists pair up leaf by leaf: equal lengths,
    at least one leaf, the four operands of a leaf of one shape, one
    dtype and one device for the list."""
    if not avgs or not len(avgs) == len(olds) == len(ms) == len(vs):
        raise ValueError(f"server_opt: {len(avgs)} / {len(olds)} / "
                         f"{len(ms)} / {len(vs)} leaves (at least one, "
                         "equal counts)")
    dev, dt = avgs[0].device, avgs[0].dtype
    for leaf in zip(avgs, olds, ms, vs):
        for name, t in zip(("avg", "old", "m", "v"), leaf):
            if t.shape != leaf[0].shape or t.dtype != dt or t.device != dev:
                raise ValueError(
                    f"server_opt: {name} {tuple(t.shape)} {t.dtype} "
                    f"{t.device} vs avg {tuple(leaf[0].shape)} (the list "
                    f"is {dt} on {dev})")


def server_opt_leaves_cuda(avgs: Sequence[torch.Tensor],
                           olds: Sequence[torch.Tensor],
                           ms: Sequence[torch.Tensor],
                           vs: Sequence[torch.Tensor], consts: np.ndarray):
    """ONE launch over 1 to ``max_leaves()`` leaves: ``avgs[l]``,
    ``olds[l]``, ``ms[l]``, ``vs[l]`` of one shape, contiguous, one dtype
    (f32/bf16) and CUDA device for the list; ``consts``: five host f32
    values ``[kind, beta1, beta2, server_lr, eps]``, passed by value.
    Returns fresh ``(outs, m's, v's)``, one list each."""
    check_leaves(avgs, olds, ms, vs)
    L, dev = len(avgs), avgs[0].device
    if L > max_leaves() or dev.type != "cuda":
        raise ValueError(f"server_opt: {L} leaves on {dev}; one launch "
                         f"takes 1 to {max_leaves()} CUDA leaves")
    if not all(t.is_contiguous() for ts in (avgs, olds, ms, vs) for t in ts):
        raise ValueError("server_opt: operands must be contiguous")
    c = np.ascontiguousarray(consts, np.float32)
    outs = [[torch.empty_like(a) for a in avgs] for _ in range(3)]

    def ptrs(ts):
        return (ctypes.c_void_p * L)(*(t.data_ptr() for t in ts))

    rc = library("server_opt").repro_server_opt_leaves(
        ptrs(avgs), ptrs(olds), ptrs(ms), ptrs(vs), *map(ptrs, outs),
        (ctypes.c_longlong * L)(*(a.numel() for a in avgs)), L,
        c.ctypes.data, dtype_code(avgs[0].dtype), launch_stream(avgs[0]))
    check_launch(rc, "server_opt")
    return tuple(outs)
