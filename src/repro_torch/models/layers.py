"""Basic neural-net layers as pure functions over param dicts.

Port of ``repro/models/layers.py``. Every function keeps the reference's
param layout and arithmetic (norms, the loss and the softcaps in f32,
cast back to the activation dtype), so a parameter tree carried across
with ``convert.params_from_numpy`` computes the same values.

Initialisers take ``key``: a ``torch.Generator`` (the draws are made on
its device; a CPU generator gives the same parameters on every device)
or a ``torch.device("meta")`` (shapes and dtypes only). ``lead`` is a
leading stack shape — the layer axis of a layer-stacked group — that
does not count toward the fan-in. The draws match the reference in
distribution only: ``jax.random`` cannot be replayed in torch.

Nothing here writes in place or reads a tensor's value on the host, so
the losses run under ``torch.func.vmap(torch.func.grad_and_value(...))``
(a cohort's local step).

Every sum over a user's tokens — the loss means, the norms' scale and
bias gradients, the MoE's mean router probability — goes through
``token_sum``: one fixed tree (``kernels.ops.token_sum``) whose order
follows the token count alone. torch's own CUDA sum splits a user's
additions by how many users share the launch, so a sweep's lane would
leave its run's bits.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

NEG_INF = -1e30


# ---------------------------------------------------------------- sums
class _TokenSum(torch.autograd.Function):
    """(R, N, C) f32 -> (R, C) through ``kops.token_sum`` (one fixed tree
    a column); the backward broadcasts. Under ``vmap`` the batch axis
    joins R, so a row's sum is a row of the same launch whatever the
    batch."""

    @staticmethod
    def forward(x):
        return kops.token_sum(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n = inputs[0].shape[1]

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(1).expand(g.shape[0], ctx.n, g.shape[1])

    @staticmethod
    def vmap(info, in_dims, x):
        if in_dims[0] is None:
            return _TokenSum.apply(x), None
        x = x.movedim(in_dims[0], 0)
        B, R, N, C = x.shape
        out = _TokenSum.apply(x.reshape(B * R, N, C))
        return out.reshape(B, R, C), 0


def token_sum(x, keep=0):
    """``x`` summed over all but its last ``keep`` dims (f32 in, f32
    out), in one fixed tree over the summed elements, row-major: the
    bits follow those elements alone, never the rows beside them in a
    launch or a ``vmap``."""
    rest = tuple(x.shape[x.dim() - keep:])
    C = int(np.prod(rest)) if rest else 1
    out = _TokenSum.apply(x.reshape(1, -1, C))
    return out.reshape(rest)


class _ScaleShift(torch.autograd.Function):
    """``x * (1 + scale) (+ bias)`` in f32, the norms' affine step, whose
    backward takes ``d_scale`` and ``d_bias`` with ``token_sum`` (autograd
    would reduce the broadcast with torch's sum)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, scale, bias):
        y = x * (1.0 + scale)
        return y if bias is None else y + bias

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, bias = inputs
        ctx.save_for_backward(x, scale)
        ctx.has_bias = bias is not None

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        need = ctx.needs_input_grad
        gx = g * (1.0 + scale) if need[0] else None
        gs = token_sum(g * x, keep=1) if need[1] else None
        gb = token_sum(g, keep=1) if ctx.has_bias and need[2] else None
        return gx, gs, gb


def _device(key):
    return key.device if isinstance(key, torch.Generator) else \
        torch.device(key)


#: a leaf past this many elements is drawn in slices of it (an f32 draw of
#: a whole full-width expert leaf would be 15 GB beside the params)
DRAW_SLICE = 1 << 28


def _trunc_normal(key, full, std, dtype):
    if not isinstance(key, torch.Generator):
        return torch.empty(full, dtype=dtype, device=_device(key))
    n = int(np.prod(full))
    if n <= DRAW_SLICE:
        out = torch.empty(full, dtype=torch.float32, device=key.device)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=key)
        return out.mul_(std).to(dtype)
    out = torch.empty(full, dtype=dtype, device=key.device)
    flat = out.view(-1)
    for lo in range(0, n, DRAW_SLICE):
        part = torch.empty(min(DRAW_SLICE, n - lo), dtype=torch.float32,
                           device=key.device)
        torch.nn.init.trunc_normal_(part, 0.0, 1.0, -2.0, 2.0, generator=key)
        flat[lo:lo + part.numel()] = part.mul_(std)
    return out


def truncated_normal_init(key, shape, scale, dtype, lead=()):
    """``scale / sqrt(shape[0])`` times a standard normal truncated to
    [-2, 2], of shape ``lead + shape``."""
    fan_in = shape[0] if len(shape) > 1 else 1
    return _trunc_normal(key, tuple(lead) + tuple(shape),
                         scale / np.sqrt(fan_in), dtype)


def zeros(key, shape, dtype, lead=()):
    """A zero leaf on ``key``'s device (the norms' zero-centred scales)."""
    return torch.zeros(tuple(lead) + tuple(shape), dtype=dtype,
                       device=_device(key))


# ---------------------------------------------------------------- norms
def init_norm(key, cfg, dtype, lead=()):
    p = {"scale": zeros(key, (cfg.d_model,), dtype, lead)}
    if cfg.norm == "layernorm":
        p["bias"] = zeros(key, (cfg.d_model,), dtype, lead)
    return p


def apply_norm(params, x, kind="rmsnorm", eps=1e-6):
    dt = x.dtype
    x = x.float()
    if kind == "layernorm":
        x = x - x.mean(dim=-1, keepdim=True)
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # zero-centered scale (gemma convention: stored scale is (gamma - 1))
    bias = params["bias"].float() if "bias" in params else None
    x = _ScaleShift.apply(x, params["scale"].float(), bias)
    return x.to(dt)


def rmsnorm_gated(scale, x, z, eps=1e-6):
    """Mamba-2 gated RMSNorm: rmsnorm(x * silu(z)) * (1 + scale)."""
    dt = x.dtype
    x = x.float() * F.silu(z.float())
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return x.to(dt)


# ---------------------------------------------------------------- MLP
def init_mlp(key, cfg, dtype, d_ff=None, lead=()):
    d_ff = d_ff or cfg.d_ff
    D = cfg.d_model
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "w_gate": truncated_normal_init(key, (D, d_ff), 1.0, dtype, lead),
            "w_up": truncated_normal_init(key, (D, d_ff), 1.0, dtype, lead),
            "w_down": truncated_normal_init(key, (d_ff, D), 1.0, dtype, lead),
        }
    return {
        "w_up": truncated_normal_init(key, (D, d_ff), 1.0, dtype, lead),
        "w_down": truncated_normal_init(key, (d_ff, D), 1.0, dtype, lead),
    }


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(params, x, activation="swiglu"):
    up = x @ params["w_up"]
    if activation in ("swiglu", "geglu"):
        gate = x @ params["w_gate"]
        act = F.silu if activation == "swiglu" else _gelu
        h = act(gate) * up
    else:
        h = _gelu(up)
    return h @ params["w_down"]


# ---------------------------------------------------------------- embed
def init_embedding(key, cfg, dtype):
    # std 1/sqrt(d_model): embed_tokens' sqrt(d) scaling then gives unit-rms
    # activations, and tied-unembed logits stay O(1) at init.
    emb = _trunc_normal(key, (cfg.padded_vocab, cfg.d_model),
                        1.0 / np.sqrt(cfg.d_model), dtype)
    return {"embedding": emb}


def embed_tokens(params, tokens, cfg):
    x = F.embedding(tokens.long(), params["embedding"])
    # gemma-style sqrt(d) scaling keeps tied embeddings well-conditioned;
    # the factor is rounded to the activation dtype first, as in JAX (on
    # the host: a device scalar would cost a synchronising copy)
    scale = float(torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype))
    return x * scale


def _vocab_mask(logits, cfg, start=0):
    ids = start + torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits,
                       torch.full_like(logits, NEG_INF))


def unembed(params_embed, params_head, x, cfg):
    if cfg.tie_embeddings:
        logits = x @ params_embed["embedding"].T
    else:
        logits = x @ params_head["w_out"]
    logits = logits.float()
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    if cfg.padded_vocab != cfg.vocab_size:
        logits = _vocab_mask(logits, cfg)
    return logits


def init_unembed(key, cfg, dtype):
    if cfg.tie_embeddings:
        return {}
    return {"w_out": truncated_normal_init(
        key, (cfg.d_model, cfg.padded_vocab), 1.0, dtype)}


# ---------------------------------------------------------------- positions
def sinusoidal_positions(seq_len, d_model, offset=0, device=None):
    """Classic transformer sin/cos absolute positions (whisper backbone)."""
    pos = np.arange(offset, offset + seq_len)[:, None].astype(np.float32)
    dim = np.arange(0, d_model, 2)[None, :].astype(np.float32)
    angle = pos / np.power(10000.0, dim / d_model)
    out = np.zeros((seq_len, d_model), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return torch.from_numpy(out).to(device)


def sinusoidal_positions_dynamic(positions, d_model):
    """Same, but for integer position tensors (decode step). Like the
    reference, the halves are concatenated, not interleaved."""
    pos = positions.float()[..., None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=positions.device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=pos.device),
                            dim / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)],
                     dim=-1).reshape(*positions.shape, d_model)


def chunked_cross_entropy(x, table, labels, cfg):
    """CE over vocab chunks without materializing (tokens, vocab) logits.

    x: (B, S, D) final-normed hidden; table: (padded_vocab, D) unembed
    rows (embedding for tied models, w_out.T otherwise); labels: (B, S).
    The reference recomputes each chunk's logits in the backward pass
    (``jax.checkpoint``); here autograd keeps them — the same values,
    without that memory trade.
    """
    B, S, D = x.shape
    T = B * S
    nc = cfg.loss_vocab_chunks
    Vp = cfg.padded_vocab
    assert Vp % nc == 0, (Vp, nc)
    C = Vp // nc
    xt = x.reshape(T, D)
    lab = labels.reshape(T).long()
    m = torch.full((T,), NEG_INF, dtype=torch.float32, device=x.device)
    s = torch.zeros((T,), dtype=torch.float32, device=x.device)
    gold = torch.full((T,), NEG_INF, dtype=torch.float32, device=x.device)
    for idx in range(nc):
        chunk = table[idx * C:(idx + 1) * C]
        logits = (xt @ chunk.T).float()                   # (T, C)
        if cfg.final_logit_softcap:
            c = cfg.final_logit_softcap
            logits = c * torch.tanh(logits / c)
        logits = _vocab_mask(logits, cfg, start=idx * C)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        local = lab - idx * C
        in_chunk = (local >= 0) & (local < C)
        g = logits.gather(1, local.clamp(0, C - 1)[:, None])[:, 0]
        gold = torch.where(in_chunk, g, gold)
    logz = m + torch.log(torch.clamp(s, min=1e-30))
    mask = (lab >= 0).float()
    return _masked_mean(logz - gold, mask)


def _masked_mean(nll, mask):
    """sum(nll * mask) / max(sum(mask), 1), both sums in one
    ``token_sum``."""
    tot = token_sum(torch.stack([nll * mask, mask], dim=-1), keep=1)
    return tot[0] / torch.clamp(tot[1], min=1.0)


def cross_entropy_loss(logits, labels, vocab_size):
    """Next-token CE in fp32; ignores label==-1 and padded vocab tail."""
    logits = logits.float()
    mask = (labels >= 0).float()
    labels_c = labels.clamp(0, vocab_size - 1).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels_c[..., None])[..., 0]
    return _masked_mean(logz - gold, mask)
