"""CUDA kernel binding: the Eq. 2 reduction for every leaf of a model.

Counterpart of ``repro/kernels/delta_norm.py``; the kernel is
``csrc/delta_norm.cu``. One launch covers up to ``max_leaves()`` leaves:
each leaf's ``(U, ...)`` stack of local models against its ``(...)``
global gives a row of ``d2 (L, U)`` and one ``g2 (L,)``. The leaves'
pointers and sizes go to the kernel by value, with no host-to-device
copy; the reference's two-operand call is the one-leaf, ``U = 1`` case.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels.build import (check_launch, dtype_code,
                                       launch_stream, library, scratch)


def max_leaves() -> int:
    """The most leaves one launch takes (a longer list takes more)."""
    return library("delta_norm").repro_delta_norm_max_leaves()


def check_leaves(stacks: Sequence[torch.Tensor],
                 globs: Sequence[torch.Tensor]) -> None:
    """Raise unless the two lists pair up leaf by leaf: equal lengths, at
    least one leaf, every ``stacks[l]`` a ``(U, ...)`` stack over
    ``globs[l]`` with one U, one dtype and one device for the list."""
    if len(stacks) != len(globs) or not stacks:
        raise ValueError(f"delta_norm: {len(stacks)} stacks and "
                         f"{len(globs)} globals (at least one leaf)")
    U, dev, dt = stacks[0].shape[:1], stacks[0].device, stacks[0].dtype
    for s, g in zip(stacks, globs):
        if s.dim() < 1 or s.shape[:1] != U or s.shape[1:] != g.shape:
            raise ValueError(
                f"delta_norm: stack {tuple(s.shape)} is not ({U[0]},) + "
                f"glob {tuple(g.shape)}")
        if s.dtype != dt or g.dtype != dt:
            raise ValueError(f"delta_norm: dtypes differ ({s.dtype}, "
                             f"{g.dtype}; the list is {dt})")
        if s.device != dev or g.device != dev:
            raise ValueError(f"delta_norm: devices differ ({s.device}, "
                             f"{g.device}; the list is on {dev})")


def delta_norm_leaves_cuda(stacks: Sequence[torch.Tensor],
                           globs: Sequence[torch.Tensor]):
    """ONE launch: ``stacks[l]`` (U, ...) contiguous CUDA f32/bf16 against
    ``globs[l]`` (...) of the same dtype, one U, dtype and device for the
    list, 1 to ``max_leaves()`` leaves. Returns ``(d2 (L, U), g2 (L,))``
    f32."""
    check_leaves(stacks, globs)
    L, U = len(stacks), stacks[0].shape[0]
    dev, dt = stacks[0].device, stacks[0].dtype
    if L > max_leaves() or U < 1 or dev.type != "cuda":
        raise ValueError(f"delta_norm: {L} leaves of {U} rows on {dev}; one "
                         f"launch takes 1 to {max_leaves()} CUDA leaves of "
                         "at least one row")
    if not all(s.is_contiguous() and g.is_contiguous()
               for s, g in zip(stacks, globs)):
        raise ValueError("delta_norm: operands must be contiguous")
    out = torch.empty((L * (U + 1),), dtype=torch.float32, device=dev)
    stream = launch_stream(stacks[0])
    args = ((ctypes.c_void_p * L)(*(s.data_ptr() for s in stacks)),
            (ctypes.c_void_p * L)(*(g.data_ptr() for g in globs)),
            (ctypes.c_longlong * L)(*(g.numel() for g in globs)), L, U,
            out.data_ptr())
    lib = library("delta_norm")
    need = 0
    while True:
        tk, pt = scratch(dev, stream, L * (U + 1), need)
        rc = lib.repro_delta_norm_leaves(
            *args, pt.data_ptr(), pt.numel(), tk.data_ptr(), tk.numel(),
            dtype_code(dt), stream)
        if rc >= 0:
            break
        need = -rc                       # the fold's partials: grow, retry
    check_launch(rc, "delta_norm")
    return out[:L * U].view(L, U), out[L * U:]
