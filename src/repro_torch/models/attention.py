"""Attention: GQA / MLA with a flash-style (chunked, online-softmax) loop.

Port of ``repro/models/attention.py``:
  * ``flash_attention`` walks the kv sequence in ``chunk``-sized blocks
    with a running (max, sumexp, acc) carry — the reference's
    ``lax.scan`` as a Python loop, with the same masks (invalid
    positions, causal, a per-layer window where 0 means full attention,
    the logit softcap) and the same ``-1e30`` fill. The reference has no
    Pallas kernel here, and ``scaled_dot_product_attention`` has neither
    the softcap nor the ring cache's position mask, so this is written
    in plain torch ops;
  * KV caches are ring buffers: write slot = position % cache_len at one
    token, a contiguous slab at more (``_cache_write``), and a stored
    position array drives the causal / window mask, so a windowed layer
    can keep a cache of exactly ``window`` entries;
  * MLA (DeepSeek) uses the *absorbed* formulation: W_UK is folded into
    the query and W_UV applied after the attention-weighted sum of the
    latent, so the KV cache holds only (kv_lora_rank + rope_dim) per
    token and no per-head K/V is ever materialised.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import (NEG_INF, apply_norm,
                                       truncated_normal_init, zeros)
from repro_torch.models.rope import apply_rope


def _pad_to_multiple(x, multiple, axis, value=0):
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    pad = [0, 0] * (x.dim() - 1 - axis) + [0, rem]
    return F.pad(x, pad, value=value)


def flash_attention(q, k, v, *, q_positions, k_positions, causal=True,
                    window=None, softcap=0.0, chunk=1024, scale=None,
                    chunk_remat=False):
    """Online-softmax attention over kv chunks.

    q: (B, S, Kv, G, Dh)   grouped queries
    k: (B, T, Kv, Dh)      v: (B, T, Kv, Dv)
    q_positions: (S,) int; k_positions: (T,) int, negative = invalid.
    window: None or 0 for full attention, or a scalar w (an int or a
      0-dim tensor) masking keys with q_pos - k_pos >= w; a tensor 0
      also means full attention.
    ``chunk_remat`` (recompute each chunk's softmax in the backward pass)
    is a memory lever of the reference's dry-run and is not ported: it
    raises.
    """
    if chunk_remat:
        raise NotImplementedError(
            "flash_chunk_remat belongs to the dry-run / hill-climb levers "
            "(ROADMAP.md Queue A item 6) and is not ported")
    B, S, Kv, G, Dh = q.shape
    if scale is None:
        scale = 1.0 / np.sqrt(Dh)
    chunk = int(min(chunk, k.shape[1]))

    k = _pad_to_multiple(k, chunk, axis=1)
    v = _pad_to_multiple(v, chunk, axis=1)
    k_positions = _pad_to_multiple(k_positions, chunk, axis=0, value=-1)
    n_chunks = k.shape[1] // chunk

    qf = q.float() * scale
    qp = q_positions[None, :, None]                            # (1,S,1)
    if isinstance(window, torch.Tensor):
        w_eff = torch.where(window > 0, window,
                            torch.full_like(window, 2**30))
    elif window is not None:
        # a Python int never becomes a device tensor: a host-to-device
        # copy per layer would synchronise the stream each time
        w_eff = window if window > 0 else 2**30
    m = torch.full((B, S, Kv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, S, Kv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, Kv, G, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        k_i, v_i, p_i = k[:, sl], v[:, sl], k_positions[sl]
        s = torch.einsum("bskgd,btkd->bskgt", qf, k_i.float())
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        pk = p_i[None, None, :]                                # (1,1,t)
        valid = pk >= 0
        if causal:
            valid = valid & (pk <= qp)
        if window is not None:
            valid = valid & (qp - pk < w_eff)
        s = torch.where(valid[:, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bskgt,btkd->bskgd", p, v_i.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


# ===================================================================== GQA
def init_gqa(key, cfg, dtype, lead=()):
    H, Kv, Dh, D = (cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim, cfg.d_model)
    return {
        "wq": truncated_normal_init(key, (D, H, Dh), 1.0, dtype, lead),
        "wk": truncated_normal_init(key, (D, Kv, Dh), 1.0, dtype, lead),
        "wv": truncated_normal_init(key, (D, Kv, Dh), 1.0, dtype, lead),
        "wo": truncated_normal_init(key, (H, Dh, D), 1.0, dtype, lead),
    }


def make_kv_cache(cfg, batch, cache_len, dtype, device=None):
    pos = torch.full((cache_len,), -1, dtype=torch.int32, device=device)
    if cfg.attention_type == "mla":
        d = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        return {"k": torch.zeros((batch, cache_len, 1, d), dtype=dtype,
                                 device=device),
                "pos": pos}
    Kv, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, cache_len, Kv, Dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, Kv, Dh), dtype=dtype,
                         device=device),
        "pos": pos,
    }


def _cache_write(cache, k_new, v_new, positions):
    """Cache write: ring-buffer for single-step decode (S==1), contiguous
    slab write for prefill (S>1, requires cache_len >= positions[-1]+1).
    Returns a new dict; ``cache`` is left as it was. The slab's start is
    clamped into the cache as ``dynamic_update_slice`` clamps it, and no
    position is read on the host."""
    C = cache["k"].shape[1]
    S = k_new.shape[1]
    first = positions[:1].long()
    if S == 1:
        slots = torch.remainder(first, C)
    else:
        slots = first.clamp(0, C - S) + torch.arange(
            S, device=positions.device)
    out = dict(cache)
    out["k"] = cache["k"].index_copy(1, slots, k_new)
    if v_new is not None:
        out["v"] = cache["v"].index_copy(1, slots, v_new)
    out["pos"] = cache["pos"].index_copy(0, slots, positions.to(torch.int32))
    return out


def apply_gqa(params, x, *, cfg, positions, window=None, cache=None,
              kv_override=None, causal=True, softcap=None, chunk=1024):
    """x: (B, S, D). Returns (y, new_cache).

    Modes: train/prefill (cache None), decode (cache dict, S==1),
    cross-attention (kv_override=(k, v, k_positions), causal=False).
    """
    B, S, D = x.shape
    H, Kv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G = H // Kv
    softcap = cfg.attn_logit_softcap if softcap is None else softcap

    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if cfg.use_rope and kv_override is None:
        q = apply_rope(q, positions[None, :], cfg.rope_theta)

    new_cache = cache
    if kv_override is not None:
        k, v, k_positions = kv_override
    elif cache is None:
        k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
        if cfg.use_rope:
            k = apply_rope(k, positions[None, :], cfg.rope_theta)
        k_positions = positions
    else:
        k_new = torch.einsum("bsd,dhk->bshk", x, params["wk"])
        v_new = torch.einsum("bsd,dhk->bshk", x, params["wv"])
        if cfg.use_rope:
            k_new = apply_rope(k_new, positions[None, :], cfg.rope_theta)
        new_cache = _cache_write(cache, k_new, v_new, positions)
        k, v, k_positions = new_cache["k"], new_cache["v"], new_cache["pos"]

    qg = q.reshape(B, S, Kv, G, Dh)
    out = flash_attention(
        qg, k, v, q_positions=positions, k_positions=k_positions,
        causal=causal, window=window, softcap=softcap, chunk=chunk,
        chunk_remat=cfg.flash_chunk_remat and cache is None)
    out = out.reshape(B, S, H, Dh)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, new_cache


# ===================================================================== MLA
def init_mla(key, cfg, dtype, lead=()):
    D, H = cfg.d_model, cfg.num_heads
    R, Rq = cfg.kv_lora_rank, cfg.q_lora_rank
    Dn, Dr, Dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    p = {
        "w_dkv": truncated_normal_init(key, (D, R), 1.0, dtype, lead),
        "w_krope": truncated_normal_init(key, (D, Dr), 1.0, dtype, lead),
        "w_uk": truncated_normal_init(key, (R, H, Dn), 1.0, dtype, lead),
        "w_uv": truncated_normal_init(key, (R, H, Dv), 1.0, dtype, lead),
        "wo": truncated_normal_init(key, (H, Dv, D), 1.0, dtype, lead),
        "kv_norm_scale": zeros(key, (R,), dtype, lead),
    }
    if Rq:
        p["w_dq"] = truncated_normal_init(key, (D, Rq), 1.0, dtype, lead)
        p["w_uq"] = truncated_normal_init(key, (Rq, H, Dn + Dr), 1.0, dtype,
                                          lead)
        p["q_norm_scale"] = zeros(key, (Rq,), dtype, lead)
    else:
        p["wq"] = truncated_normal_init(key, (D, H, Dn + Dr), 1.0, dtype,
                                        lead)
    return p


def _mla_latent(params, x, cfg, positions):
    """Compressed latent + rope key for new tokens: (B,S,1,R+Dr). The
    latent's norm is ``apply_norm``'s default rmsnorm, not ``cfg.norm``,
    as in the reference."""
    ckv = apply_norm({"scale": params["kv_norm_scale"]}, x @ params["w_dkv"])
    krope = (x @ params["w_krope"])[:, :, None, :]           # (B,S,1,Dr)
    krope = apply_rope(krope, positions[None, :], cfg.rope_theta)
    return torch.cat([ckv[:, :, None, :], krope], dim=-1)


def apply_mla(params, x, *, cfg, positions, window=None, cache=None,
              chunk=1024):
    B, S, D = x.shape
    H = cfg.num_heads
    R, Dn, Dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim

    if cfg.q_lora_rank:
        cq = apply_norm({"scale": params["q_norm_scale"]}, x @ params["w_dq"])
        q = torch.einsum("bsr,rhk->bshk", cq, params["w_uq"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    q_nope, q_rope = q[..., :Dn], q[..., Dn:]
    q_rope = apply_rope(q_rope, positions[None, :], cfg.rope_theta)
    # absorb W_UK into the query -> queries live in latent space
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope, params["w_uk"])
    q_eff = torch.cat([q_abs, q_rope], dim=-1)               # (B,S,H,R+Dr)

    k_new = _mla_latent(params, x, cfg, positions)           # (B,S,1,R+Dr)
    new_cache = cache
    if cache is None:
        k_eff, k_positions = k_new, positions
    else:
        new_cache = _cache_write(cache, k_new, None, positions)
        k_eff, k_positions = new_cache["k"], new_cache["pos"]
    v_eff = k_eff[..., :R]                                    # latent is V

    qg = q_eff.reshape(B, S, 1, H, R + Dr)
    # the head's own dims set the scale, not the latent's (R + Dr)
    o = flash_attention(
        qg, k_eff, v_eff, q_positions=positions, k_positions=k_positions,
        causal=True, window=window, softcap=cfg.attn_logit_softcap,
        chunk=chunk, scale=1.0 / np.sqrt(Dn + Dr),
        chunk_remat=cfg.flash_chunk_remat and cache is None)  # (B,S,1,H,R)
    o = torch.einsum("bshr,rhv->bshv", o.reshape(B, S, H, R), params["w_uv"])
    y = torch.einsum("bshv,hvd->bsd", o, params["wo"])
    return y, new_cache


def init_attention(key, cfg, dtype, lead=()):
    if cfg.attention_type == "mla":
        return init_mla(key, cfg, dtype, lead)
    return init_gqa(key, cfg, dtype, lead)


def apply_attention(params, x, *, cfg, positions, window=None, cache=None,
                    kv_override=None, causal=True, chunk=1024):
    if cfg.attention_type == "mla":
        return apply_mla(params, x, cfg=cfg, positions=positions,
                         window=window, cache=cache, chunk=chunk)
    return apply_gqa(params, x, cfg=cfg, positions=positions, window=window,
                     cache=cache, kv_override=kv_override, causal=causal,
                     chunk=chunk)
