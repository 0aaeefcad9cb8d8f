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
``prox != 0`` — a host branch here for a run, a per-lane select for a
sweep whose lanes differ (the reference's per-term ``where`` guard).
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
from repro_torch.tree import tree_leaves, tree_map

register_local(LocalObjective("fedavg", uses_h=False, coeff=lambda s: 0.0))
register_local(LocalObjective("fedprox", uses_h=False, coeff=lambda s: s.mu))
register_local(LocalObjective("feddyn", uses_h=True, coeff=lambda s: s.alpha))


def objective_epoch_scan(loss_fn: Callable, lr: float,
                         use_h: bool) -> Callable:
    """Returns ``run(stack, batched, glob, prox[, h]) -> (stack,
    per_batch_losses)`` over a stacked cohort (the layout of
    ``sgd_epoch_scan``: ``stack`` leaves ``(R, ...)``, trained IN PLACE
    and returned; losses ``(R, num_batches)``).

    The rows hold E lanes of U users each, lane-major (``R = E * U``; a
    single run is E = 1): ``prox`` is one host coefficient a lane — a
    scalar for one run, an ``(E,)`` vector for a sweep — each rounded to
    f32 once, so its product rounds like the reference's f32 scalar; a
    lane whose coefficient is 0 keeps its gradients' bits (the
    reference's ``where(prox != 0, ...)`` guard, taken per lane).
    ``glob`` holds the round-start globals, the proximal anchors: a
    single global for a scalar ``prox``, else the ``(E, ...)`` stack of
    the lanes' globals — tensors that do not alias the stack, which the
    loop overwrites. ``h`` is the ``(R, ...)`` per-user FedDyn state when
    ``use_h``.
    """
    epoch_run = sgd_epoch_scan(loss_fn, lr)

    def run(stack, batched, glob, prox, h=None):
        if np.ndim(prox) == 0:
            glob = tree_map(lambda p: p.unsqueeze(0), glob)
        prox32 = np.asarray(prox, np.float32).reshape(-1)
        E, on = len(prox32), prox32 != 0.0
        if on.any():
            dev = tree_leaves(glob)[0].device
            coef = torch.from_numpy(prox32).to(dev)
            keep = None if on.all() else torch.from_numpy(on).to(dev)

        def prox_term(g, p, wg):
            lanes = (E, -1) + tuple(g.shape[1:])
            bshape = (E,) + (1,) * g.dim()
            gl = g.reshape(lanes)
            term = coef.view(bshape) * (p.reshape(lanes) - wg.unsqueeze(1))
            out = gl + term.to(g.dtype)
            if keep is not None:
                out = torch.where(keep.view(bshape), out, gl)
            return out.reshape(g.shape)

        def law(grads, stack):
            if on.any():
                grads = tree_map(prox_term, grads, stack, glob)
            if use_h:
                grads = tree_map(torch.sub, grads, h)
            return grads

        return epoch_run(stack, batched, law=law)

    return run
