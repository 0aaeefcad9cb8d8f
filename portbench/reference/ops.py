"""The reference's products, in f32 with TF32 off, or with their operands
rounded to fewer mantissa bits (the control, set by the configuration:
``control(cfg)``).

An operand is rounded to the nearest value of ``bits`` mantissa bits,
ties away from zero (for 10 bits TF32's, as ``cvt.rna.tf32.f32`` does;
for 3 bits fp8 e4m3's mantissa, its exponent range not applied), and the
products are accumulated in f32. Each product's backward rounds its
operands the same way, so a whole local step runs in that precision.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def set_tf32_off() -> None:
    """The reference's own f32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` (f32) rounded to ``bits`` of f32's 23 mantissa bits, ties
    away from zero."""
    drop = 23 - bits
    v = x.contiguous().view(torch.int32)
    return ((v + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10-bit mantissa, ties away."""
    return round_mantissa(x, 10)


def control_bits(cfg) -> int:
    """Mantissa bits of the precision below the configuration's: TF32's
    10 for f32 with TF32 off, fp8 e4m3's 3 for bf16."""
    dtype, tf32 = cfg.get("dtype", "float32"), bool(cfg.get("tf32"))
    if dtype == "float32" and not tf32:
        return 10
    if dtype == "bfloat16":
        return 3
    raise ValueError(f"no control for dtype {dtype!r} (tf32={tf32})")


def _rounder(bits):
    return (lambda t: t) if bits is None else \
        (lambda t: round_mantissa(t, bits))


class _MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, bits):
        ctx.save_for_backward(a, b)
        ctx.bits = bits
        r = _rounder(bits)
        return torch.matmul(r(a), r(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = _rounder(ctx.bits)
        ga = torch.matmul(r(g), r(b).transpose(-1, -2))
        gb = torch.matmul(r(a).transpose(-1, -2), r(g))
        return ga, gb, None


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, pad, bits):
        ctx.save_for_backward(x, w)
        ctx.pad, ctx.bits = pad, bits
        r = _rounder(bits)
        return F.conv2d(r(x), r(w), padding=pad)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        r = _rounder(ctx.bits)
        gx = (torch.nn.grad.conv2d_input(x.shape, r(w), r(g),
                                         padding=ctx.pad)
              if ctx.needs_input_grad[0] else None)
        gw = torch.nn.grad.conv2d_weight(r(x), w.shape, r(g),
                                         padding=ctx.pad)
        return gx, gw, None, None


class Ops:
    """The products a reference model calls: ``matmul(a, b)`` (batched
    over leading axes) and ``conv2d(x NCHW, w OIHW, pad)``; ``bits``
    rounds their operands (None: f32 as it is)."""

    def __init__(self, bits: Optional[int] = None):
        self.bits = bits

    def matmul(self, a, b):
        return _MatMul.apply(a, b, self.bits)

    def conv2d(self, x, w, pad):
        return _Conv.apply(x, w, pad, self.bits)


def control(cfg) -> Ops:
    """The control's products for the configuration ``cfg``."""
    return Ops(bits=control_bits(cfg))
