"""Local objective step laws run inside the fused round's training loop.

``objective_epoch_scan`` is ``core.client.sgd_epoch_scan`` — the one
local-SGD loop — run under the FedProx / FedDyn-generalized gradient
law:

* a proximal gradient term ``prox * (w - w_global)`` (FedProx's ``mu``,
  FedDyn's ``alpha``), and
* an optional per-user h-vector subtracted from the gradient (FedDyn's
  dynamic regularizer; updated at merge time in the backend).

Bit-transparency: ``g + 0 * (w - w_g)`` is NOT an IEEE-754 identity (it
flips -0.0 gradients to +0.0), so the proximal term is added only when
``prox != 0`` — a host branch here, since one run serves one spec (the
reference's per-term ``where`` guard constant-folds to the same thing).
The h subtraction needs no guard: h is exactly +0.0 until the first
``alpha != 0`` merge, and ``x - (+0.0)`` IS a bitwise identity for every
x (including -0.0). So an inert spec trains bit-equal to the plain loop,
and its Eq. 2 priorities and contention winners are the plain run's.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.client import sgd_epoch_scan
from repro_torch.objectives.spec import LocalObjective, register_local
from repro_torch.tree import tree_map

register_local(LocalObjective("fedavg", uses_h=False, coeff=lambda s: 0.0))
register_local(LocalObjective("fedprox", uses_h=False, coeff=lambda s: s.mu))
register_local(LocalObjective("feddyn", uses_h=True, coeff=lambda s: s.alpha))


def objective_epoch_scan(loss_fn: Callable, lr: float,
                         use_h: bool) -> Callable:
    """Returns ``run(stack, batched, glob, prox[, h]) -> (stack,
    per_batch_losses)`` over a stacked cohort (the layout of
    ``sgd_epoch_scan``: ``stack`` leaves ``(U, ...)``, trained IN PLACE
    and returned; losses ``(U, num_batches)``).

    ``glob`` is the round-start global, the proximal anchor — a tensor
    that does not alias the stack, which the loop overwrites; ``prox`` a
    host scalar, rounded to f32 once so its product rounds like the
    reference's f32 scalar; ``h`` the ``(U, ...)`` per-user FedDyn state
    when ``use_h``.
    """
    epoch_run = sgd_epoch_scan(loss_fn, lr)

    def run(stack, batched, glob, prox, h=None):
        prox32 = float(np.float32(prox))

        def law(grads, stack):
            if prox32 != 0.0:
                grads = tree_map(
                    lambda g, p, wg: g + prox32 * (p - wg.unsqueeze(0)),
                    grads, stack, glob)
            if use_h:
                grads = tree_map(torch.sub, grads, h)
            return grads

        return epoch_run(stack, batched, law=law)

    return run
