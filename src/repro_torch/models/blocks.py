"""Decoder blocks (port of ``repro/models/blocks.py``: the dense and MoE
blocks).

Every block type shares one apply signature, so the model loops over a
layer-stacked param dict one layer at a time:

    apply_block(params, x, cfg=..., block_type=..., positions=...,
                window=..., cache=..., enc_out=...)
      -> (x_out, new_cache, aux_loss)

``"dense"`` (with gemma2's post-norm sandwich, ``cfg.use_post_norm``)
and ``"moe"`` (the routed FFN of ``models/moe.py``) are ported. The
Mamba, hybrid, encoder and cross blocks come with their families'
slices and raise.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import apply_attention, init_attention, \
    make_kv_cache
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, \
    init_norm
from repro_torch.models.moe import apply_moe, init_moe

BLOCK_TYPES = ("dense", "moe", "mamba", "hybrid", "encoder", "cross")
PORTED_BLOCKS = ("dense", "moe")


def _check_block(block_type):
    if block_type not in BLOCK_TYPES:
        raise ValueError(f"unknown block type {block_type!r}")
    if block_type not in PORTED_BLOCKS:
        raise NotImplementedError(
            f"block type {block_type!r}: the port runs the dense and MoE "
            "blocks; SSM, hybrid and audio blocks wait for their slices "
            "(ROADMAP.md Queue A item 4)")


def init_block(key, cfg, block_type, dtype, lead=()):
    """One block's params; ``lead`` stacks them (the layer axis)."""
    _check_block(block_type)
    p = {"ln1": init_norm(key, cfg, dtype, lead),
         "attn": init_attention(key, cfg, dtype, lead)}
    if cfg.use_post_norm:
        p["ln1_post"] = init_norm(key, cfg, dtype, lead)
    p["ln2"] = init_norm(key, cfg, dtype, lead)
    if block_type == "moe":
        p["moe"] = init_moe(key, cfg, dtype, lead)
        return p
    p["mlp"] = init_mlp(key, cfg, dtype, lead=lead)
    if cfg.use_post_norm:
        p["ln2_post"] = init_norm(key, cfg, dtype, lead)
    return p


def make_block_cache(cfg, block_type, batch, cache_len, dtype, device=None):
    """Decode-time cache skeleton for one layer."""
    _check_block(block_type)
    return {"attn": make_kv_cache(cfg, batch, cache_len, dtype, device)}


def _norm(p, x, cfg):
    return apply_norm(p, x, cfg.norm)


def apply_block(params, x, *, cfg, block_type, positions, window=None,
                cache=None, enc_out=None, chunk=1024):
    _check_block(block_type)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = dict(cache) if cache is not None else None

    # ---------------- attention sublayer -----------------------------------
    h = _norm(params["ln1"], x, cfg)
    y, attn_cache = apply_attention(
        params["attn"], h, cfg=cfg, positions=positions, window=window,
        cache=None if cache is None else cache.get("attn"), chunk=chunk)
    if cfg.use_post_norm:
        y = _norm(params["ln1_post"], y, cfg)
    if new_cache is not None and "attn" in new_cache:
        new_cache["attn"] = attn_cache
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
