"""Plain reference of a dense causal language model (kind ``lm``), in
f32: a Llama-style decoder as the program builds it. Per layer a
pre-norm GQA causal attention with rotary positions, then a pre-norm
SwiGLU MLP, each added to the residual; a final RMSNorm and an untied
head; next-token cross-entropy, the mean over a user's batch of tokens.

Two choices follow the program's ``models/layers.py``, not the published
Llama or Yi models, which scale neither: the token embedding is
multiplied by sqrt(d_model), and RMSNorm is ``x / sqrt(mean(x^2) + 1e-6)
* (1 + scale)`` (scales stored zero-centred). A configuration lists them
under ``assumed``. Rotary positions rotate the two halves of each head
(``theta ** -(2i / head_dim)``); the query's head ``h`` reads the key and
value head ``h // (num_heads / num_kv_heads)``; a head's scores are
scaled by ``head_dim ** -0.5``; a vocabulary padded to
``vocab_pad_multiple`` rows has its padded logits left out of the
softmax. The leaves are the program's (``repro_torch.models.model``):
``embed.embedding`` (V', D), ``head.w_out`` (D, V'), ``final_norm.scale``,
and ``blocks0.*`` stacked over the layers (``attn.wq`` (n, D, H, Dh),
``attn.wk`` / ``attn.wv`` (n, D, Kv, Dh), ``attn.wo`` (n, H, Dh, D),
``mlp.w_gate`` / ``mlp.w_up`` (n, D, F), ``mlp.w_down`` (n, F, D),
``ln1.scale`` / ``ln2.scale`` (n, D)). Every size is read from the
configuration file's ``widths``; nothing of the program is imported.

Every product goes through ``ops.matmul`` (the control rounds its
operands). A user's model is one autograd graph; each layer is
recomputed in the backward pass (``torch.utils.checkpoint``), so a user
holds one layer's activations at a time. ``losses_and_grads`` runs the
users one after another.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: the ``widths`` keys this module reads
WIDTHS = ("family", "attention_type", "num_layers", "d_model", "num_heads",
          "num_kv_heads", "head_dim", "d_ff", "vocab_size",
          "vocab_pad_multiple", "rope_theta", "use_rope", "norm",
          "activation", "tie_embeddings", "sliding_window",
          "local_global_pattern", "attn_logit_softcap",
          "final_logit_softcap", "use_post_norm", "num_experts", "use_mtp")
#: what this reference computes; any other value of these keys is refused
PLAIN = {"attention_type": "gqa", "use_rope": True, "norm": "rmsnorm",
         "activation": "swiglu", "tie_embeddings": False,
         "sliding_window": 0, "local_global_pattern": [],
         "attn_logit_softcap": 0.0, "final_logit_softcap": 0.0,
         "use_post_norm": False, "num_experts": 0, "use_mtp": False}
EPS = 1e-6
LAYER_LEAVES = ("ln1.scale", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
                "ln2.scale", "mlp.w_gate", "mlp.w_up", "mlp.w_down")


def check(cfg) -> None:
    w = cfg["widths"]
    missing = [k for k in WIDTHS if k not in w]
    if missing:
        raise ValueError(f"reference lm: widths lack {missing}")
    other = {k: w[k] for k, v in PLAIN.items() if w[k] != v}
    if w["family"] not in ("dense", "vlm") or other:
        raise ValueError(f"reference lm: a dense GQA decoder only; "
                         f"family {w['family']!r}, {other}")


def padded_vocab(w) -> int:
    m = w["vocab_pad_multiple"]
    return -(-w["vocab_size"] // m) * m


def shapes(cfg):
    check(cfg)
    w = cfg["widths"]
    n, D, F_ = w["num_layers"], w["d_model"], w["d_ff"]
    H, Kv, Dh = w["num_heads"], w["num_kv_heads"], w["head_dim"]
    V = padded_vocab(w)
    out = {"embed.embedding": (V, D), "final_norm.scale": (D,),
           "head.w_out": (D, V),
           "blocks0.ln1.scale": (n, D), "blocks0.ln2.scale": (n, D),
           "blocks0.attn.wq": (n, D, H, Dh), "blocks0.attn.wk": (n, D, Kv, Dh),
           "blocks0.attn.wv": (n, D, Kv, Dh), "blocks0.attn.wo": (n, H, Dh, D),
           "blocks0.mlp.w_gate": (n, D, F_), "blocks0.mlp.w_up": (n, D, F_),
           "blocks0.mlp.w_down": (n, F_, D)}
    return dict(sorted(out.items()))


def _fan_in(name, shape):
    if name == "embed.embedding":
        return shape[1]            # unit-rms rows after the sqrt(D) scale
    if name.endswith("attn.wo"):
        return shape[1] * shape[2]
    return shape[1] if name.startswith("blocks") else shape[0]


def init(cfg, gen, device):
    """Weights N(0, 1) clipped to [-2, 2] over sqrt(fan-in), from one
    draw for every weight on ``gen``'s device; norm scales zero."""
    sh = shapes(cfg)
    ws = [k for k in sh if not k.endswith(".scale")]
    flat = torch.randn(sum(math.prod(sh[k]) for k in ws), generator=gen,
                       device=device, dtype=torch.float32).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for k in sh:
        if k.endswith(".scale"):
            out[k] = torch.zeros(sh[k], device=device)
            continue
        n = math.prod(sh[k])
        out[k] = flat[at:at + n].view(sh[k]).mul_(
            1.0 / math.sqrt(_fan_in(k, sh[k])))
        at += n
    return out


def _rms(x, scale):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + EPS) \
        * (1.0 + scale)


def _rope(x, cos, sin):
    """``x`` (B, S, heads, Dh): each head's halves rotated by its
    position's angles (``cos`` / ``sin`` (S, Dh/2))."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _mm(ops, x, w):
    """``x`` (..., K) times a weight ``w`` of K rows (its other axes
    flattened) -> (..., N), as one 2-D product."""
    out = ops.matmul(x.reshape(-1, x.shape[-1]), w.reshape(x.shape[-1], -1))
    return out.view(x.shape[:-1] + (-1,))


def _layer(x, cos, sin, ops, ln1, wq, wk, wv, wo, ln2, wg, wu, wd):
    B, S, D = x.shape
    _, H, Dh = wq.shape
    Kv = wk.shape[1]
    h = _rms(x, ln1)
    q = _rope(_mm(ops, h, wq).view(B, S, H, Dh), cos, sin)
    k = _rope(_mm(ops, h, wk).view(B, S, Kv, Dh), cos, sin)
    v = _mm(ops, h, wv).view(B, S, Kv, Dh)
    k = k.repeat_interleave(H // Kv, dim=2)
    v = v.repeat_interleave(H // Kv, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # (B, H, S, Dh)
    scores = ops.matmul(q * Dh ** -0.5, k.transpose(-1, -2))
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = ops.matmul(p, v).transpose(1, 2).reshape(B, S, H * Dh)
    x = x + _mm(ops, o, wo)
    h = _rms(x, ln2)
    return x + _mm(ops, F.silu(_mm(ops, h, wg)) * _mm(ops, h, wu), wd)


def user_loss(p, tokens, ops, cfg):
    """One user's mean next-token cross-entropy: ``p`` its leaves,
    ``tokens`` (B, S + 1)."""
    w = cfg["widths"]
    inputs, labels = tokens[:, :-1].long(), tokens[:, 1:].long()
    S = inputs.shape[1]
    D, Dh = w["d_model"], w["head_dim"]
    x = F.embedding(inputs, p["embed.embedding"]) \
        * float(torch.tensor(math.sqrt(D)))
    freqs = float(w["rope_theta"]) ** -(
        torch.arange(0, Dh, 2, device=x.device, dtype=torch.float32) / Dh)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    for i in range(w["num_layers"]):
        leaves = [p[f"blocks0.{n}"][i] for n in LAYER_LEAVES]
        x = checkpoint(_layer, x, cos, sin, ops, *leaves,
                       use_reentrant=False)
    logits = _mm(ops, _rms(x, p["final_norm.scale"]), p["head.w_out"])
    if logits.shape[-1] > w["vocab_size"]:
        logits = logits.clone()
        logits[..., w["vocab_size"]:] = float("-inf")
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def losses_and_grads(stack, batch, ops, cfg):
    """Every user's mean cross-entropy on its batch and its gradient:
    ``stack`` leaves (U, ...), ``batch["tokens"]`` (U, B, S + 1); the
    users one after another."""
    tokens = batch["tokens"]
    losses, grads = [], {k: [] for k in stack}
    for u in range(tokens.shape[0]):
        leaves = {k: v[u].detach().requires_grad_(True)
                  for k, v in stack.items()}
        loss = user_loss(leaves, tokens[u], ops, cfg)
        for k, g in zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))):
            grads[k].append(g)
        losses.append(loss.detach())
    return torch.stack(losses), {k: torch.stack(v) for k, v in grads.items()}


def forward_flops_per_token(cfg, seq_len: int) -> int:
    """FLOPs of one token's forward pass in a causal sequence of
    ``seq_len``: two a multiply-add of every projection (q, k, v, o, the
    three of the MLP, the head over the unpadded vocabulary) and of the
    scores and the weighted sum over the keys a token attends on average
    in a causal sequence, (seq_len + 1) / 2; norms, rotary positions,
    softmax and the embedding lookup are not counted."""
    w = cfg["widths"]
    D, H, Kv, Dh, F_ = (w["d_model"], w["num_heads"], w["num_kv_heads"],
                        w["head_dim"], w["d_ff"])
    proj = 2 * D * H * Dh + 2 * 2 * D * Kv * Dh + 2 * H * Dh * D
    attn = 2 * 2 * H * Dh * (seq_len + 1) // 2
    mlp = 3 * 2 * D * F_
    return w["num_layers"] * (proj + attn + mlp) + 2 * D * w["vocab_size"]
