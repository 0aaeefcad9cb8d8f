"""Kind ``classification`` (a configuration without a ``kind`` key): the
paper's classifiers, ``model`` ``mlp`` or ``cnn`` as the program's
``models/paper_models.py`` names them, trained on class-conditional
images with integer labels.

Data (``make_data``): images shaped as the configuration's input
(Fashion-MNIST's 28 x 28 x 1 for the paper's models). Each class has a
smooth template (four random 2-D cosines a channel, scaled to [0, 1]);
an example is its class's template plus ``noise`` N(0, 1), scaled by
U(0.7, 1.3), shifted by U(-0.15, 0.15), clipped to [0, 1]. The users'
labels are the non-IID split of McMahan et al. that the paper uses: a
balanced label vector sorted by class, cut into ``shards_per_user *
users`` shards, dealt out by a random permutation. Test labels are
uniform. Users are made a block at a time on the device and copied into
one host array, which the program takes as its users' host data.

The program: ``get_paper_model``'s apply function under
``classification_loss``, users ``{"x", "y"}``, and
``make_accuracy_eval`` on the test set. The work: ``work/models.py``'s
FLOPs an example.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.harness.program import Pieces
from portbench.work import models as work_models

#: users made on the device at a time (bounds the generator's memory)
BLOCK_USERS = 256


def check(cfg, model) -> None:
    if cfg.get("model") not in ("mlp", "cnn"):
        raise ValueError(f"portbench kind classification: model "
                         f"{cfg.get('model')!r} is not 'mlp' or 'cnn'")


def _templates(gen, classes, shape, device):
    h, w, c = shape
    yy = torch.arange(h, device=device, dtype=torch.float64)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float64)[None, :]
    draws = torch.rand((classes, c, 4, 5), generator=gen, device=device,
                       dtype=torch.float64)
    freq = 0.5 + 2.5 * draws[..., :2]
    phase = 2 * math.pi * draws[..., 2:4]
    amp = 0.3 + 0.7 * draws[..., 4]
    img = (amp[..., None, None]
           * torch.cos(2 * math.pi * freq[..., 0, None, None] * yy / h
                       + phase[..., 0, None, None])
           * torch.cos(2 * math.pi * freq[..., 1, None, None] * xx / w
                       + phase[..., 1, None, None])).sum(dim=2)
    lo = img.amin(dim=(2, 3), keepdim=True)
    hi = img.amax(dim=(2, 3), keepdim=True)
    img = (img - lo) / torch.clamp(hi - lo, min=1e-9)
    return img.permute(0, 2, 3, 1).to(torch.float32)       # (classes, h, w, c)


def _examples(gen, templates, labels, noise):
    x = templates[labels]
    x = x + noise * torch.randn(x.shape, generator=gen, device=x.device)
    lead = labels.shape + (1,) * (x.dim() - labels.dim())
    x = x * (0.7 + 0.6 * torch.rand(lead, generator=gen, device=x.device))
    x = x + (0.3 * torch.rand(lead, generator=gen, device=x.device) - 0.15)
    return torch.clamp(x, 0.0, 1.0)


def make_data(cell, gen, dev):
    """``(users, test)``: ``{"x": (U, n, ...) f32, "y": (U, n) int32}``
    and the test set alike, host arrays."""
    cfg, tr = cell.config, cell.traffic
    U, n = tr["users"], tr["examples_per_user"]
    shards = tr["shards_per_user"]
    if n % shards:
        raise ValueError("examples_per_user must divide into its shards")
    classes, shape = cfg["classes"], tuple(cfg["input_shape"])
    templates = _templates(gen, classes, shape, dev)
    total = U * n
    ordered = (torch.arange(total, device=dev) * classes) // total
    deal = torch.randperm(U * shards, generator=gen, device=dev)
    size = n // shards
    flat = cfg["model"] == "mlp"
    feat = (math.prod(shape),) if flat else shape
    x = np.empty((U, n) + feat, np.float32)
    y = np.empty((U, n), np.int32)
    for lo in range(0, U, BLOCK_USERS):
        hi = min(U, lo + BLOCK_USERS)
        starts = deal[lo * shards:hi * shards].view(hi - lo, shards) * size
        idx = (starts[..., None]
               + torch.arange(size, device=dev)).reshape(hi - lo, n)
        labels = ordered[idx]
        xb = _examples(gen, templates, labels, tr["noise"])
        torch.from_numpy(x[lo:hi]).copy_(xb.reshape((hi - lo, n) + feat))
        torch.from_numpy(y[lo:hi]).copy_(labels.to(torch.int32))
        del xb
    T = tr["test_examples"]
    y_test = torch.randint(0, classes, (T,), generator=gen, device=dev)
    x_test = _examples(gen, templates, y_test, tr["noise"])
    test = {"x": x_test.reshape((T,) + feat).cpu().numpy(),
            "y": y_test.to(torch.int32).cpu().numpy()}
    return {"x": x, "y": y}, test


def program(cell, inputs, device) -> Pieces:
    from repro_torch.engine import make_accuracy_eval
    from repro_torch.launch.train import classification_loss
    from repro_torch.models.paper_models import get_paper_model

    cfg = cell.config
    _, apply_fn = get_paper_model(cfg["model"], cfg["dataset"])
    evaluate = make_accuracy_eval(apply_fn, inputs.test["x"],
                                  inputs.test["y"], device=device)
    x, y = inputs.users["x"], inputs.users["y"]
    users = [{"x": x[u], "y": y[u]} for u in range(len(x))]
    return Pieces(classification_loss(apply_fn), users, evaluate)


def reference_step(cell, stack, batch, ops):
    """The users' losses (U,) and gradients on ``batch`` (``x`` (U, B,
    ...), ``y`` (U, B))."""
    return cell.model.losses_and_grads(stack, batch["x"], batch["y"], ops)


def round_flops(cell) -> dict:
    return work_models.round_flops(cell.config,
                                   {**cell.traffic, **cell.spec})
