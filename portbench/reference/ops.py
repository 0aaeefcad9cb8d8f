"""The reference's products, in f32 with TF32 off, or with their operands
rounded to TF32 (the control: ``tf32=True``).

TF32 keeps 10 of f32's 23 mantissa bits: an operand is rounded to the
nearest TF32 value, ties away from zero (as ``cvt.rna.tf32.f32`` does),
and the products are accumulated in f32. Each product's backward rounds
its operands the same way, so a whole local step runs in that precision.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def set_tf32_off() -> None:
    """The reference's own f32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10-bit mantissa, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, tf32):
        ctx.save_for_backward(a, b)
        ctx.tf32 = tf32
        r = to_tf32 if tf32 else (lambda t: t)
        return torch.matmul(r(a), r(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = to_tf32 if ctx.tf32 else (lambda t: t)
        ga = torch.matmul(r(g), r(b).transpose(-1, -2))
        gb = torch.matmul(r(a).transpose(-1, -2), r(g))
        return ga, gb, None


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, pad, tf32):
        ctx.save_for_backward(x, w)
        ctx.pad, ctx.tf32 = pad, tf32
        r = to_tf32 if tf32 else (lambda t: t)
        return F.conv2d(r(x), r(w), padding=pad)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        r = to_tf32 if ctx.tf32 else (lambda t: t)
        gx = (torch.nn.grad.conv2d_input(x.shape, r(w), r(g),
                                         padding=ctx.pad)
              if ctx.needs_input_grad[0] else None)
        gw = torch.nn.grad.conv2d_weight(r(x), w.shape, r(g),
                                         padding=ctx.pad)
        return gx, gw, None, None


class Ops:
    """The products a reference model calls: ``matmul(a, b)`` (batched
    over leading axes) and ``conv2d(x NCHW, w OIHW, pad)``."""

    def __init__(self, tf32: bool = False):
        self.tf32 = bool(tf32)

    def matmul(self, a, b):
        return _MatMul.apply(a, b, self.tf32)

    def conv2d(self, x, w, pad):
        return _Conv.apply(x, w, pad, self.tf32)
