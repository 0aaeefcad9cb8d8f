"""The paper's own evaluation models (Sec. IV-A2).

MLP: d_input x 200 x 10 (one 200-node hidden layer).
CNN: conv 5x5x128 -> pool -> conv 5x5x256 -> pool -> fc -> 10, with the
paper's channel counts (128, 256) and a 10-way classifier head.

Both are (init, apply) pairs over plain param dicts; the FL core is
model-agnostic and treats each weight tensor as one "layer" for the
Eq. 2 priority product.

Layouts at the public functions are the reference's, so a parameter
tree means the same thing in both packages: dense weights ``(in,
out)``, conv weights HWIO, inputs NHWC. ``apply_cnn`` permutes to
PyTorch's NCHW / OIHW inside and back to NHWC before the flatten, so
the rows of ``fc.w`` index the same (h, w, c) positions.

The CNN's first block (conv1, its bias, the ReLU and the 2x2 max-pool)
runs as one op, ``conv_pool``: on the card the hand-written kernel pair
``kernels/csrc/conv_pool.cu`` (the forward, and the weight and bias
gradient from the forward's winner codes), one launch each for a whole
stacked cohort under ``vmap``; on the CPU the plain version, the same
``F.conv2d`` / bias / ``F.relu`` / ``F.max_pool2d`` chain as before.
Its output comes back NCHW with the users next to the channels, the
layout conv2's grouped call under ``vmap`` reads without a copy. conv2
and the head stay PyTorch's (cuDNN, cuBLAS).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


def _generator(seed) -> torch.Generator:
    """An explicit CPU generator: draws are made on the host and moved,
    so one seed gives the same parameters on every device."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device="cpu").manual_seed(int(seed))


def _dense_init(gen, shape):
    std = 1.0 / np.sqrt(shape[0])
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0
            - 1.0) * std


# ------------------------------------------------------------------ MLP
def init_mlp(seed, d_input=784, d_hidden=200, n_classes=10, device=None):
    """``seed``: int or CPU ``torch.Generator``; ``device=None`` is the
    CUDA device."""
    dev, gen = resolve_device(device), _generator(seed)
    return {
        "fc1": {"w": _dense_init(gen, (d_input, d_hidden)).to(dev),
                "b": torch.zeros((d_hidden,), device=dev)},
        "fc2": {"w": _dense_init(gen, (d_hidden, n_classes)).to(dev),
                "b": torch.zeros((n_classes,), device=dev)},
    }


def apply_mlp(params, x):
    """x: (B, ...) flattened internally -> logits (B, 10)."""
    x = x.reshape(x.shape[0], -1)
    h = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return h @ params["fc2"]["w"] + params["fc2"]["b"]


# ------------------------------------------------------------------ CNN
def init_cnn(seed, in_channels=1, image_size=28, n_classes=10, device=None):
    dev, gen = resolve_device(device), _generator(seed)
    # paper: 5x5 kernels, 128 then 256 channels, fc head
    s = image_size // 4  # two 2x2 max-pools
    d_flat = 256 * s * s

    def normal(shape):
        return 0.05 * torch.randn(shape, generator=gen, dtype=torch.float32)

    return {
        "conv1": {"w": normal((5, 5, in_channels, 128)).to(dev),
                  "b": torch.zeros((128,), device=dev)},
        "conv2": {"w": normal((5, 5, 128, 256)).to(dev),
                  "b": torch.zeros((256,), device=dev)},
        "fc": {"w": _dense_init(gen, (d_flat, n_classes)).to(dev),
               "b": torch.zeros((n_classes,), device=dev)},
    }


def _conv(x, w, b):
    """x: NCHW; w: HWIO (the reference's layout) -> relu(conv + b), NCHW.
    5x5 stride 1 with padding 2 is the reference's "SAME"."""
    y = F.conv2d(x, w.permute(3, 2, 0, 1), padding=w.shape[0] // 2)
    return F.relu(y + b.reshape(1, -1, 1, 1))


def _stack(t, d, n, axis, stacked):
    """A ``vmap`` rule's physical operand with the batch dimension ``d``
    (None: unbatched, expanded) made the stack axis ``axis``, merged into
    the operand's own stack there when it has one (``stacked``)."""
    if d is None:
        t = t.unsqueeze(axis).expand(*t.shape[:axis], n, *t.shape[axis:])
    else:
        t = t.movedim(d, axis)
    return t.flatten(axis, axis + 1) if stacked else t


def _unstack(t, n, axis, stacked):
    return t.unflatten(axis, (n, -1)) if stacked else t


class _ConvPool(torch.autograd.Function):
    """``kops.conv_pool`` (one launch over a stack on the card) with its
    winner codes as a second, non-differentiable output (saved for the
    backward, ``_ConvPoolGrad``). Under ``vmap`` the batch axis joins the
    stack, whatever it was (nested ``vmap``s fold in turn): a user's
    block is a row of one launch, and its bits follow its own operands
    alone."""

    @staticmethod
    def forward(x, w, b):
        return kops.conv_pool(x, w, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(*inputs, output[1])

    @staticmethod
    def backward(ctx, g, _):
        if ctx.needs_input_grad[0]:
            raise NotImplementedError("conv_pool: no gradient for the input")
        dw, db = _ConvPoolGrad.apply(g, *ctx.saved_tensors)
        return None, dw, db

    @staticmethod
    def vmap(info, in_dims, x, w, b):
        n, st = info.batch_size, x.dim() - (in_dims[0] is not None) == 5
        out, codes = _ConvPool.apply(
            *(_stack(t, d, n, 0, st) for t, d in zip((x, w, b), in_dims)))
        return (_unstack(out, n, 1, st), _unstack(codes, n, 1, st)), (1, 1)


class _ConvPoolGrad(torch.autograd.Function):
    """``kops.conv_pool_grad``: ``(dw, db)`` from the pooled output's
    cotangent; a row of the batch dimension joins the stack under
    ``vmap``. First order only."""

    @staticmethod
    def forward(g, x, w, b, codes):
        return kops.conv_pool_grad(g, x, w, b, codes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("conv_pool: no second derivative")

    @staticmethod
    def vmap(info, in_dims, g, x, w, b, codes):
        n, st = info.batch_size, x.dim() - (in_dims[1] is not None) == 5
        g, codes = (_stack(t, d, n, 1, st)
                    for t, d in ((g, in_dims[0]), (codes, in_dims[4])))
        x, w, b = (_stack(t, d, n, 0, st)
                   for t, d in zip((x, w, b), in_dims[1:4]))
        dw, db = _ConvPoolGrad.apply(g, x, w, b, codes)
        return (_unstack(dw, n, 0, st), _unstack(db, n, 0, st)), (0, 0)


def conv_pool(x, w, b):
    """The CNN's first block, ``maxpool2x2(relu(conv5x5_same(x, w) +
    b))``: ``x`` (B, H, W, C) NHWC, ``w`` (5, 5, C, O) HWIO, ``b`` (O,)
    -> (B, O, H/2, W/2) NCHW, differentiable in ``w`` and ``b`` (``x`` is
    data). A max-pool's gradient goes to the first maximum of its window
    in row-major order, as ``F.max_pool2d``'s does, and to nothing where
    the maximum is <= 0."""
    return _ConvPool.apply(x, w, b)[0]


def apply_cnn(params, x):
    """x: (B, H, W, C) -> logits (B, 10)."""
    if x.dim() == 2:  # flattened input
        side = int(np.sqrt(x.shape[-1]))
        x = x.reshape(x.shape[0], side, side, 1)
    x = conv_pool(x, params["conv1"]["w"], params["conv1"]["b"])
    x = F.max_pool2d(_conv(x, params["conv2"]["w"], params["conv2"]["b"]), 2)
    x = x.permute(0, 2, 3, 1)                          # back to NHWC
    x = x.reshape(x.shape[0], -1)
    return x @ params["fc"]["w"] + params["fc"]["b"]


def get_paper_model(name: str, dataset: str = "fashion"):
    """Returns (init_fn(seed, device=None), apply_fn(params, x)) for
    'mlp' | 'cnn'."""
    if dataset == "fashion":
        d_input, channels, size = 784, 1, 28
    elif dataset == "cifar":
        d_input, channels, size = 3072, 3, 32
    else:
        raise ValueError(dataset)
    if name == "mlp":
        return functools.partial(init_mlp, d_input=d_input), apply_mlp
    if name == "cnn":
        return (functools.partial(init_cnn, in_channels=channels,
                                  image_size=size), apply_cnn)
    raise ValueError(name)
