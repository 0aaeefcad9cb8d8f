"""FL client: local SGD training + priority computation (Steps 2-3)."""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.core.priority import model_priority
from repro_torch.core.rngs import client_rng
from repro_torch.optim.sgd import sgd_update
from repro_torch.tree import tree_leaves, tree_map


def sgd_epoch_scan(loss_fn: Callable, lr: float) -> Callable:
    """Returns ``run(stack, batched) -> (stack, per_batch_losses)`` over
    a stacked cohort: one SGD step per batch for every user at once.

    ``stack`` leaves are ``(U, ...)``, ``batched`` leaves
    ``(U, num_batches, batch, ...)``; losses come back ``(U,
    num_batches)``. The reference's ``vmap`` over users is
    ``torch.func.vmap(grad_and_value(loss_fn))`` over the stack, its
    ``lax.scan`` over batches a Python loop, and its donated carry an
    IN-PLACE update: ``stack`` is overwritten and returned.

    THE local-SGD inner loop — the per-client trainer and the fused
    cohort round both build on this one closure.
    """
    grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    def run(stack, batched):
        nb = tree_leaves(batched)[0].shape[1]
        losses = []
        for i in range(nb):
            batch = tree_map(lambda a: a[:, i], batched)
            grads, loss = grad_fn(stack, batch)
            sgd_update(stack, grads, lr)
            losses.append(loss.detach())
        return stack, torch.stack(losses, dim=1)

    return run


def batch_epoch(rng: np.random.Generator, data, batch_size: int):
    """Shuffle + reshape host data into (nb, bs, ...); drops remainder."""
    n = len(tree_leaves(data)[0])
    nb = max(1, n // batch_size)
    perm = rng.permutation(n)[: nb * batch_size]
    return tree_map(
        lambda a: np.asarray(a)[perm].reshape((nb, batch_size) + a.shape[1:]),
        data)


class Client:
    """One FL user: local dataset + 1-epoch SGD + Eq. 2 priority.

    ``data`` stays host numpy (the per-user permutation stream draws on
    the host); ``train`` is the U = 1 case of the stacked step."""

    def __init__(self, uid: int, data, loss_fn, *, lr=1e-2, batch_size=32,
                 local_epochs=1, seed=0):
        self.uid = uid
        self.data = data
        self.num_examples = len(tree_leaves(data)[0])
        self.batch_size = batch_size
        self.local_epochs = local_epochs
        self._epoch_run = sgd_epoch_scan(loss_fn, lr)
        # per-user stream spawned from the experiment seed (core.rngs):
        # independent across users AND across experiment seeds
        self._rng = client_rng(seed, uid)

    def train(self, global_params) -> Tuple:
        """Step 2: returns (local_params, mean_loss). ``global_params``
        is left untouched (the local model starts from a copy)."""
        stack = tree_map(lambda p: p.detach().clone().unsqueeze(0),
                         global_params)
        device = tree_leaves(stack)[0].device
        loss = torch.zeros((), device=device)
        for _ in range(self.local_epochs):
            batched = tree_map(
                lambda a: torch.from_numpy(a).unsqueeze(0).to(device),
                batch_epoch(self._rng, self.data, self.batch_size))
            stack, losses = self._epoch_run(stack, batched)
            loss = losses[0].mean()
        return tree_map(lambda p: p[0], stack), loss

    def priority(self, local_params, global_params) -> float:
        """Step 3: Eq. 2."""
        return float(model_priority(local_params, global_params))
