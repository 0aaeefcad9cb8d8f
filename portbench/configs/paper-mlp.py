"""Plain reference of ``paper-mlp``: 784 x 200 x 10, ReLU, softmax
cross-entropy; weights (in, out), the users' models stacked on a leading
axis and trained together (each user's loss depends on its own rows
only, so the gradient of the summed losses is every user's gradient)."""
from __future__ import annotations

import math

import torch


def shapes(cfg):
    dims = [cfg["d_input"], *cfg["hidden"], cfg["classes"]]
    out = {}
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        out[f"fc{i + 1}.b"] = (b,)
        out[f"fc{i + 1}.w"] = (a, b)
    return dict(sorted(out.items()))


def init(cfg, gen, device):
    """Dense weights U(-1/sqrt(in), 1/sqrt(in)), biases zero: one draw for
    every weight on ``gen``'s device."""
    sh = shapes(cfg)
    ws = [k for k in sh if k.endswith(".w")]
    flat = torch.rand(sum(math.prod(sh[k]) for k in ws), generator=gen,
                      device=device, dtype=torch.float32)
    out, at = {}, 0
    for k in sh:
        if k.endswith(".b"):
            out[k] = torch.zeros(sh[k], device=device)
            continue
        n = math.prod(sh[k])
        out[k] = ((flat[at:at + n].view(sh[k]) * 2.0 - 1.0)
                  / math.sqrt(sh[k][0]))
        at += n
    return out


def logits(p, x, ops):
    """``p`` leaves (U, ...), ``x`` (U, B, d) -> (U, B, classes)."""
    n = len([k for k in p if k.endswith(".w")])
    h = x.reshape(x.shape[0], x.shape[1], -1)
    for i in range(1, n + 1):
        h = ops.matmul(h, p[f"fc{i}.w"]) + p[f"fc{i}.b"][:, None, :]
        if i < n:
            h = torch.relu(h)
    return h


def losses_and_grads(stack, x, y, ops):
    """Every user's mean cross-entropy on its batch and its gradient:
    ``stack`` leaves (U, ...), ``x`` (U, B, ...), ``y`` (U, B)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in stack.items()}
    logp = torch.log_softmax(logits(leaves, x, ops), dim=-1)
    loss = -logp.gather(-1, y.long()[..., None])[..., 0].mean(dim=1)
    grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))
