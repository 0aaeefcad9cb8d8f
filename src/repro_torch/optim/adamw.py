"""AdamW for the LLM federated-finetune examples (fp32 moments).

Port of ``repro/optim/adamw.py``: moments in f32, an int32 step
``count``, bias corrections ``1 - b ** c`` with ``c`` the count as an
f32 tensor, the update computed in f32 and cast back to each leaf's
dtype. Pure functions over nested dicts of tensors.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def adamw_init(params):
    """``{"mu", "nu"}`` f32 zeros in the params' shapes, and ``count`` an
    int32 zero, on the params' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(params, grads, state, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0):
    """One AdamW step; returns ``(new_params, new_state)``."""
    count = state["count"] + 1
    c = count.float()

    def upd(p, g, mu, nu):
        g32 = g.float()
        mu_n = b1 * mu + (1 - b1) * g32
        nu_n = b2 * nu + (1 - b2) * torch.square(g32)
        mu_hat = mu_n / (1 - b1 ** c)
        nu_hat = nu_n / (1 - b2 ** c)
        step = mu_hat / (torch.sqrt(nu_hat) + eps)
        if weight_decay:
            step = step + weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), mu_n, nu_n

    out = [upd(p, g, m, n) for p, g, m, n in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
        tree_leaves(state["nu"]))]
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_state = {"mu": tree_unflatten(params, [o[1] for o in out]),
                 "nu": tree_unflatten(params, [o[2] for o in out]),
                 "count": count}
    return new_params, new_state
