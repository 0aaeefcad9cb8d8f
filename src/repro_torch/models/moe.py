"""Mixture-of-Experts FFN: token-choice top-k routing with capacity,
sort-based dispatch (DeepSeek-V3 / Kimi-K2 style: shared + routed experts).

Port of ``repro/models/moe.py``, with its semantics: the router in f32,
top-k of the softmax renormalised, the Switch-style load-balance loss,
assignments sorted by expert with a STABLE sort (which assignments fall
beyond an expert's capacity depends on it), ``cap`` a Python int from
the shapes, an ``(E, cap, D)`` buffer through the experts' FFN, the
shared expert on every token. The reference leaves the expert products
to XLA einsums (no Pallas kernel), so they are ``torch.bmm`` here.

The reference's dispatch and combine are scatter-adds; on the card a
scatter-add is a float ``atomicAdd`` (in the forward, or in the backward
of a gather), whose order changes from run to run. Here both are gathers
by the sort permutation, and their backwards gathers by its inverse
(``_Dispatch``, ``_Combine``): a token's K rows are added in a fixed
order, k = 0, 1, ...; a dropped assignment contributes an exact zero.
Counting per expert is an integer sum and ``mean_prob`` a ``token_sum``,
so a user's bits do not follow the users beside it in a ``vmap``.
The mesh levers ``moe_buf_shard`` and ``moe_gather_weights`` constrain
the buffer and the expert weights at the reference's two sites
(``device.with_sharding_constraint``: ``RuntimeError`` with no mesh in
context, a value identity under one).
"""
from __future__ import annotations

import torch
from repro_torch.device import with_sharding_constraint
from repro_torch.models.layers import (apply_mlp, init_mlp, silu,
                                       token_sum, truncated_normal_init)


def init_moe(key, cfg, dtype, lead=()):
    E, D, Fh = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": truncated_normal_init(key, (D, E), 1.0, torch.float32,
                                        lead),
        "w_gate": truncated_normal_init(key, (E, D, Fh), 1.0, dtype, lead),
        "w_up": truncated_normal_init(key, (E, D, Fh), 1.0, dtype, lead),
        "w_down": truncated_normal_init(key, (E, Fh, D), 1.0, dtype, lead),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(key, cfg, dtype,
                               d_ff=cfg.moe_d_ff * cfg.num_shared_experts,
                               lead=lead)
    return p


def _sum_k(t):
    """(T, K, ...) -> (T, ...): the K entries added in order k = 0, 1, ..."""
    y = t[:, 0]
    for k in range(1, t.shape[1]):
        y = y + t[:, k]
    return y


def _rows(src, slot):
    """``src`` (E*cap, D) rows at ``slot`` (T, K) -> (T, K, D)."""
    T, K = slot.shape
    return src.index_select(0, slot.reshape(-1)).reshape(T, K, -1)


class _Dispatch(torch.autograd.Function):
    """Forward: slot s of the ``(E*cap, D)`` buffer is ``xt[src_tok[s]]``
    where ``valid[s]``, else zero. Backward: a token's gradient is the
    sum of its kept slots' rows (``slot``, ``keep``: (T, K) in
    assignment order); a dropped assignment adds an exact zero."""
    generate_vmap_rule = True

    @staticmethod
    def forward(xt, src_tok, valid, slot, keep):
        return torch.where(valid[:, None], xt.index_select(0, src_tok), 0.0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[3], inputs[4])

    @staticmethod
    def backward(ctx, g):
        slot, keep = ctx.saved_tensors
        rows = torch.where(keep[:, :, None], _rows(g, slot), 0.0)
        return _sum_k(rows), None, None, None, None


class _Combine(torch.autograd.Function):
    """Forward: ``y[t] = sum_k out_buf[slot[t, k]] * w[t, k]``, k in
    order, a dropped assignment (``keep`` false) an exact zero. Backward:
    a slot's gradient gathers its token's row times its weight
    (``src_tok``, ``slot_w``, ``valid``); a weight's gradient is its
    token's row dotted with its slot's row."""
    generate_vmap_rule = True

    @staticmethod
    def forward(out_buf, w, slot, keep, src_tok, slot_w, valid):
        rows = _rows(out_buf, slot) * w[:, :, None]
        return _sum_k(torch.where(keep[:, :, None], rows, 0.0))

    @staticmethod
    def setup_context(ctx, inputs, output):
        out_buf, w, slot, keep, src_tok, slot_w, valid = inputs
        ctx.save_for_backward(out_buf, slot, keep, src_tok, slot_w, valid)

    @staticmethod
    def backward(ctx, g):
        out_buf, slot, keep, src_tok, slot_w, valid = ctx.saved_tensors
        g_buf = torch.where(valid[:, None],
                            g.index_select(0, src_tok) * slot_w[:, None], 0.0)
        g_w = torch.where(keep, (_rows(out_buf, slot) * g[:, None, :])
                          .sum(dim=-1), 0.0)
        return g_buf, g_w, None, None, None, None, None


def apply_moe(params, x, cfg, capacity_factor=None):
    """x: (B, S, D) -> (y, aux_loss)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, D)
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    dev = x.device

    logits = xt.float() @ params["router"]                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)     # (T, K)
    gate_vals = gate_vals / torch.clamp(_sum_k(gate_vals)[:, None],
                                        min=1e-9)             # renormalize

    # -- load-balance aux loss (Switch-style) ------------------------------
    flat_e = expert_ids.reshape(T * K)
    experts = torch.arange(E, device=dev)
    counts = (flat_e[:, None] == experts[None, :]).long().sum(dim=0)  # (E,)
    density = counts.float() / (T * K)
    mean_prob = token_sum(probs, keep=1) / T
    aux_loss = cfg.router_aux_loss * E * token_sum(density * mean_prob)

    # -- sort-based dispatch with capacity ---------------------------------
    A = T * K                                                 # assignments
    cap = int(min(A, max(1, -(-A * capacity_factor // E))))   # ceil, <= A
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order)                   # position of each assignment
    starts = torch.cumsum(counts, dim=0) - counts             # exclusive
    rank = inv - starts.gather(0, flat_e)                     # pos in expert
    keep = rank < cap                                         # (A,)
    slot = (flat_e * cap + torch.clamp(rank, max=cap - 1)).reshape(T, K)
    # slot s = (e, c) holds sorted position starts[e] + c when c < counts[e]
    c = torch.arange(cap, device=dev)
    valid = (c[None, :] < counts[:, None]).reshape(E * cap)
    pos = torch.clamp(starts[:, None] + c[None, :], max=A - 1).reshape(-1)
    asg = order.gather(0, pos)                                # (E*cap,)
    src_tok = torch.div(asg, K, rounding_mode="floor")
    w = gate_vals.to(x.dtype)                                 # (T, K)
    slot_w = w.reshape(A).gather(0, asg)                      # (E*cap,)
    keep = keep.reshape(T, K)

    buf = _Dispatch.apply(xt, src_tok, valid, slot, keep).reshape(E, cap, D)
    if cfg.moe_buf_shard:
        buf = with_sharding_constraint(buf, ("model", "data", None))

    # -- per-expert FFN (batched over E) -----------------------------------
    w_gate, w_up, w_down = (params["w_gate"], params["w_up"],
                            params["w_down"])
    if cfg.moe_gather_weights:
        # beyond-paper lever: the FSDP'd expert weights gathered once a
        # layer (whole over 'data'), not the activation partials reduced
        con = lambda w: with_sharding_constraint(  # noqa: E731
            w, ("model", None, None))
        w_gate, w_up, w_down = con(w_gate), con(w_up), con(w_down)
    h = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    h = silu(h) * u
    out_buf = torch.bmm(h, w_down).reshape(E * cap, D)

    # -- combine back -------------------------------------------------------
    y = _Combine.apply(out_buf, w, slot, keep, src_tok, slot_w, valid)

    if cfg.num_shared_experts:
        y = y + apply_mlp(params["shared"], xt, cfg.activation)
    return y.reshape(B, S, D), aux_loss

