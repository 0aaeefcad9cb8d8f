"""CUDA kernel binding: the paper CNN's first block over a stacked cohort.

The kernels are ``csrc/conv_pool.cu``; no reference kernel stands behind
them (the reference leaves ``conv -> relu -> max-pool`` to XLA). The
forward computes ``maxpool2x2(relu(conv5x5_same(x, w) + b))`` for every
row of a ``(R, ...)`` stack and a one-byte winner code a pooled output;
the backward turns a cotangent of the pooled output and those codes into
the weight and bias gradients, in a fixed order that follows ``(B, H, W,
C)`` alone, so a user's bits do not depend on the rows beside it.

``conv_pool_plan`` is the launch geometry: a plain function of the
shape, so the CPU tests read it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.build import (check_launch, launch_stream, library,
                                       scratch)

#: the kernel side (5 x 5, "SAME": padding 2); threads a block; output
#: channels a forward block and a backward block; pooled positions a
#: backward chunk and a staged slab; the card's shared memory a block
K = 5
THREADS = 256
WARPS = THREADS // 32
FWD_TILE = 64
GRAD_TILE = 32
CHUNK_POSITIONS = 512
SLAB = 256
SMEM_MAX = 232448


class ConvPoolPlan(NamedTuple):
    """One shape's geometry. ``rs`` the padded row stride in shared
    memory (at least W + 4, and not 0 or +-1 modulo 32: a warp's four
    winner offsets fall in four banks), ``plane`` the floats of a padded
    channel plane; the backward takes ``cg`` input channels a block (3
    where C is a multiple of 3, else 1),
    ``chunk`` images a chunk (``chunks`` of them), ``slab`` positions a
    staged slab at stride ``ps`` (odd); ``fwd_smem`` / ``grad_smem`` the
    dynamic shared memory bytes."""
    rs: int
    plane: int
    fwd_smem: int
    cg: int
    chunk: int
    chunks: int
    slab: int
    ps: int
    grad_smem: int


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def conv_pool_plan(B: int, H: int, W: int, C: int, O: int) -> ConvPoolPlan:
    """The geometry of an ``(R, B, H, W, C)`` stack into ``O`` channels
    (R does not enter it). Raises ``ValueError`` for a shape the kernels
    do not take."""
    if min(B, C) < 1 or min(H, W) < 2 or O < 8 or O % 8:
        raise ValueError(f"conv_pool: no plan for B={B}, H={H}, W={W}, "
                         f"C={C}, O={O} (O a multiple of 8, H, W >= 2)")
    rs = W + 2 * (K // 2)
    while rs % 32 in (0, 1, 31):
        rs += 1
    plane = (H + 2 * (K // 2)) * rs
    P = (H // 2) * (W // 2)
    fwd = 4 * (_round4(C * plane) + K * K * C * FWD_TILE + FWD_TILE)
    cg = 3 if C % 3 == 0 else 1     # the backward is built for 1 and 3
    chunk = max(1, CHUNK_POSITIONS // P)
    slab = min(P, SLAB)
    ps = slab | 1
    stage = _round4(cg * plane) + 2 * GRAD_TILE * ps + P
    red = WARPS * (K * K * cg + 1) * 32
    grad = 4 * max(stage, red)
    if max(fwd, grad) > SMEM_MAX:
        raise ValueError(f"conv_pool: ({H}, {W}, {C}) -> {O} needs "
                         f"{max(fwd, grad)} bytes of shared memory a "
                         f"block, over the card's {SMEM_MAX}")
    return ConvPoolPlan(rs=rs, plane=plane, fwd_smem=fwd, cg=cg, chunk=chunk,
                        chunks=-(-B // chunk), slab=slab, ps=ps,
                        grad_smem=grad)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (R, B, H, W, C) with each row contiguous (rows may lie any
    stride apart, an expanded stack 0)."""
    if x.shape[0] and not x[0].is_contiguous():
        return x.contiguous()
    return x


def _check(name, *ts):
    for t in ts:
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"{name}: takes CUDA float32 tensors, got "
                             f"{t.dtype} on {t.device}")


def conv_pool_cuda(x, w, b):
    """ONE launch: ``x`` (R, B, H, W, C), ``w`` (R, 5, 5, C, O), ``b``
    (R, O) CUDA f32 -> ``(out, codes)``, both (B, R, O, H/2, W/2), out
    f32 and codes uint8."""
    _check("conv_pool", x, w, b)
    R, B, H, W, C = x.shape
    O = w.shape[-1]
    if tuple(w.shape) != (R, K, K, C, O) or tuple(b.shape) != (R, O):
        raise ValueError(f"conv_pool: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    out = torch.empty((B, R, O, H // 2, W // 2), dtype=torch.float32,
                      device=x.device)
    codes = torch.empty(out.shape, dtype=torch.uint8, device=x.device)
    if R == 0 or B == 0:
        return out, codes
    p = conv_pool_plan(B, H, W, C, O)
    x, w, b = _rows(x), w.contiguous(), b.contiguous()
    rc = library("conv_pool").repro_conv_pool(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        codes.data_ptr(), R, B, H, W, C, O, x.stride(0), p.rs, p.fwd_smem,
        launch_stream(x))
    check_launch(rc, "conv_pool")
    return out, codes


def conv_pool_grad_cuda(g, x, codes):
    """ONE launch: the cotangent ``g`` and ``codes`` (B, R, O, H/2, W/2)
    of ``conv_pool_cuda``'s output and its input ``x`` (R, B, H, W, C) ->
    ``(dw (R, 5, 5, C, O), db (R, O))`` f32, contiguous."""
    _check("conv_pool_grad", g, x)
    R, B, H, W, C = x.shape
    O = g.shape[2]
    if tuple(g.shape) != (B, R, O, H // 2, W // 2) or \
            codes.shape != g.shape or codes.dtype != torch.uint8:
        raise ValueError(f"conv_pool_grad: g {tuple(g.shape)}, codes "
                         f"{tuple(codes.shape)} {codes.dtype}, x "
                         f"{tuple(x.shape)}")
    if R == 0 or B == 0:
        return (torch.zeros((R, K, K, C, O), device=x.device),
                torch.zeros((R, O), device=x.device))
    p = conv_pool_plan(B, H, W, C, O)
    dw = torch.empty((R, K, K, C, O), dtype=torch.float32, device=x.device)
    db = torch.empty((R, O), dtype=torch.float32, device=x.device)
    x, g, codes = _rows(x), g.contiguous(), codes.contiguous()
    stream = launch_stream(x)
    tiles = -(-O // GRAD_TILE)
    tk, pt = scratch(x.device, stream, R * tiles * (C // p.cg),
                     R * p.chunks * (K * K * C + 1) * O if p.chunks > 1
                     else 0)
    rc = library("conv_pool").repro_conv_pool_grad(
        g.data_ptr(), x.data_ptr(), codes.data_ptr(), dw.data_ptr(),
        db.data_ptr(), pt.data_ptr(), pt.numel(), tk.data_ptr(), tk.numel(),
        R, B, H, W, C, O, x.stride(0), p.rs, p.cg, p.chunk, p.slab, p.ps,
        p.grad_smem, stream)
    check_launch(rc, "conv_pool_grad")
    return dw, db
