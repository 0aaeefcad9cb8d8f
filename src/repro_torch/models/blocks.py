"""Encoder / decoder blocks (port of ``repro/models/blocks.py``: the
dense, MoE, Mamba-2, hybrid, encoder and cross blocks).

Every block type shares one apply signature, so the model loops over a
layer-stacked param dict one layer at a time:

    apply_block(params, x, cfg=..., block_type=..., positions=...,
                window=..., cache=..., enc_out=...)
      -> (x_out, new_cache, aux_loss)

``"dense"`` (with gemma2's post-norm sandwich, ``cfg.use_post_norm``),
``"moe"`` (the routed FFN of ``models/moe.py``), ``"mamba"`` (the
Mamba-2 layer of ``models/ssm.py`` is the whole block), ``"hybrid"``
(Hymba: attention and Mamba-2 heads on the same normed input, their
outputs normed and averaged, then the MLP), ``"encoder"`` (Whisper's
encoder layer: the dense block with bidirectional attention) and
``"cross"`` (Whisper's decoder layer: causal self-attention, then
attention over the encoder's output through ``ln_x`` / ``xattn``, then
the MLP). A cross block's keys and values are projected from
``enc_out`` when it is given (training, prefill: the prefill stores
them in the cache's ``cross_k`` / ``cross_v``) and read from the cache
otherwise (decode); that cache has the encoder's length and no ring.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import apply_attention, apply_gqa, \
    init_attention, init_gqa, make_kv_cache
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, \
    init_norm, zeros
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.ssm import apply_mamba2, init_mamba2, make_ssm_cache

BLOCK_TYPES = ("dense", "moe", "mamba", "hybrid", "encoder", "cross")


def _check_block(block_type):
    if block_type not in BLOCK_TYPES:
        raise ValueError(f"unknown block type {block_type!r}")


def init_block(key, cfg, block_type, dtype, lead=()):
    """One block's params; ``lead`` stacks them (the layer axis)."""
    _check_block(block_type)
    p = {"ln1": init_norm(key, cfg, dtype, lead)}
    if block_type == "mamba":
        p["mamba"] = init_mamba2(key, cfg, dtype, lead)
        return p
    p["attn"] = init_attention(key, cfg, dtype, lead)
    if cfg.use_post_norm:
        p["ln1_post"] = init_norm(key, cfg, dtype, lead)
    if block_type == "hybrid":
        p["mamba"] = init_mamba2(key, cfg, dtype, lead)
        p["attn_out_scale"] = zeros(key, (cfg.d_model,), dtype, lead)
        p["ssm_out_scale"] = zeros(key, (cfg.d_model,), dtype, lead)
    if block_type == "cross":
        p["ln_x"] = init_norm(key, cfg, dtype, lead)
        p["xattn"] = init_gqa(key, cfg, dtype, lead)
    p["ln2"] = init_norm(key, cfg, dtype, lead)
    if block_type == "moe":
        p["moe"] = init_moe(key, cfg, dtype, lead)
        return p
    p["mlp"] = init_mlp(key, cfg, dtype, lead=lead)
    if cfg.use_post_norm:
        p["ln2_post"] = init_norm(key, cfg, dtype, lead)
    return p


def make_block_cache(cfg, block_type, batch, cache_len, dtype, device=None,
                     enc_len: int = 0):
    """Decode-time cache skeleton for one layer: ``attn`` (a KV ring
    cache), ``ssm`` (the conv and SSM states, no length axis), and for a
    cross block ``cross_k`` / ``cross_v`` (``enc_len`` entries, no ring);
    an encoder block keeps none."""
    _check_block(block_type)
    c = {}
    if block_type in ("dense", "moe", "hybrid", "cross"):
        c["attn"] = make_kv_cache(cfg, batch, cache_len, dtype, device)
    if block_type in ("mamba", "hybrid"):
        c["ssm"] = make_ssm_cache(cfg, batch, dtype, device)
    if block_type == "cross":
        shape = (batch, enc_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def _norm(p, x, cfg):
    return apply_norm(p, x, cfg.norm)


def apply_block(params, x, *, cfg, block_type, positions, window=None,
                cache=None, enc_out=None, chunk=1024):
    _check_block(block_type)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = dict(cache) if cache is not None else None

    # ---------------- attention / mamba / hybrid sublayer -----------------
    h = _norm(params["ln1"], x, cfg)
    if block_type == "mamba":
        y, ssm_cache = apply_mamba2(
            params["mamba"], h, cfg,
            cache=None if cache is None else cache["ssm"])
        if new_cache is not None:
            new_cache["ssm"] = ssm_cache
        return x + y, new_cache, aux
    y, attn_cache = apply_attention(
        params["attn"], h, cfg=cfg, positions=positions, window=window,
        cache=None if cache is None else cache.get("attn"),
        causal=block_type != "encoder", chunk=chunk)
    if block_type == "hybrid":
        y_ssm, ssm_cache = apply_mamba2(
            params["mamba"], h, cfg,
            cache=None if cache is None else cache["ssm"])
        # Hymba: per-channel normalized mean of the two heads' outputs
        y = 0.5 * (apply_norm({"scale": params["attn_out_scale"]}, y)
                   + apply_norm({"scale": params["ssm_out_scale"]}, y_ssm))
        if new_cache is not None:
            new_cache["ssm"] = ssm_cache
    elif cfg.use_post_norm:
        y = _norm(params["ln1_post"], y, cfg)
    if new_cache is not None and "attn" in new_cache:
        new_cache["attn"] = attn_cache
    x = x + y

    # ---------------- cross attention (whisper decoder) --------------------
    if block_type == "cross":
        h = _norm(params["ln_x"], x, cfg)
        if enc_out is not None:  # train / prefill: (re)compute cross kv
            ck = torch.einsum("btd,dhk->bthk", enc_out, params["xattn"]["wk"])
            cv = torch.einsum("btd,dhk->bthk", enc_out, params["xattn"]["wv"])
            if new_cache is not None:
                new_cache["cross_k"], new_cache["cross_v"] = ck, cv
        else:
            ck, cv = cache["cross_k"], cache["cross_v"]
        kpos = torch.arange(ck.shape[1], dtype=torch.int32, device=ck.device)
        y, _ = apply_gqa(params["xattn"], h, cfg=cfg, positions=positions,
                         kv_override=(ck, cv, kpos), causal=False,
                         chunk=chunk)
        x = x + y

    # ---------------- FFN sublayer -----------------------------------------
    h = _norm(params["ln2"], x, cfg)
    if block_type == "moe":
        # decode batches are tiny and sparse over experts: widen capacity
        # whenever a cache is passed, prefill included (train keeps the
        # config factor)
        cf = (max(cfg.moe_capacity_factor, 4.0) if cache is not None
              else cfg.moe_capacity_factor)
        y, aux = apply_moe(params["moe"], h, cfg, capacity_factor=cf)
        return x + y, new_cache, aux
    y = apply_mlp(params["mlp"], h, cfg.activation)
    if cfg.use_post_norm:
        y = _norm(params["ln2_post"], y, cfg)
    x = x + y
    return x, new_cache, aux
