"""Plain reference of ``paper-cnn``: 5x5 convolutions of 128 then 256
channels ("same" padding, ReLU, 2x2 max-pool each), then a dense layer to
10 classes; weights HWIO and (in, out), inputs NHWC, the flatten in (h,
w, c) order. Users run one after another, each through autograd."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def shapes(cfg):
    h, w, c = cfg["input_shape"]
    k, pool = cfg["kernel_size"], cfg["pool"]
    out = {}
    for i, cout in enumerate(cfg["conv_channels"]):
        out[f"conv{i + 1}.b"] = (cout,)
        out[f"conv{i + 1}.w"] = (k, k, c, cout)
        h, w, c = h // pool, w // pool, cout
    out["fc.b"] = (cfg["classes"],)
    out["fc.w"] = (h * w * c, cfg["classes"])
    return dict(sorted(out.items()))


def init(cfg, gen, device):
    """Convolutions 0.05 N(0, 1), the dense layer U(-1/sqrt(in),
    1/sqrt(in)), biases zero: one normal and one uniform draw on
    ``gen``'s device."""
    sh = shapes(cfg)
    convs = [k for k in sh if k.startswith("conv") and k.endswith(".w")]
    normal = torch.randn(sum(math.prod(sh[k]) for k in convs), generator=gen,
                         device=device, dtype=torch.float32)
    fc = torch.rand(sh["fc.w"], generator=gen, device=device,
                    dtype=torch.float32)
    out, at = {}, 0
    for k in sh:
        if k.endswith(".b"):
            out[k] = torch.zeros(sh[k], device=device)
        elif k in convs:
            n = math.prod(sh[k])
            out[k] = 0.05 * normal[at:at + n].view(sh[k])
            at += n
    out["fc.w"] = (fc * 2.0 - 1.0) / math.sqrt(sh["fc.w"][0])
    return out


def logits(p, x, ops):
    """One user's ``p``, ``x`` (B, H, W, C) -> (B, classes)."""
    h = x.permute(0, 3, 1, 2)
    i = 1
    while f"conv{i}.w" in p:
        w = p[f"conv{i}.w"]
        h = ops.conv2d(h, w.permute(3, 2, 0, 1), w.shape[0] // 2)
        h = F.max_pool2d(torch.relu(h + p[f"conv{i}.b"][None, :, None, None]),
                         2)
        i += 1
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return ops.matmul(h, p["fc.w"]) + p["fc.b"]


def losses_and_grads(stack, x, y, ops):
    """Every user's mean cross-entropy on its batch and its gradient:
    ``stack`` leaves (U, ...), ``x`` (U, B, H, W, C), ``y`` (U, B)."""
    losses, grads = [], {k: [] for k in stack}
    for u in range(x.shape[0]):
        leaves = {k: v[u].detach().requires_grad_(True)
                  for k, v in stack.items()}
        logp = torch.log_softmax(logits(leaves, x[u], ops), dim=-1)
        loss = -logp.gather(-1, y[u].long()[:, None]).mean()
        for k, g in zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))):
            grads[k].append(g)
        losses.append(loss.detach())
    return torch.stack(losses), {k: torch.stack(v) for k, v in grads.items()}
