"""Model assembly: layer groups over layer-stacked params.

Port of ``repro/models/model.py`` for every family: dense, vlm, moe,
ssm, hybrid and audio.
A model is a sequence of *layer groups*; each group's params are stacked
over a leading layer axis, in the reference's layout and leaf order, so
a JAX parameter tree carried across with ``convert.params_from_numpy``
is this module's parameter tree. The reference's ``lax.scan`` over the
stack is a Python loop over the layer index; the per-layer windows
(gemma2's local / global layers, hymba's three global layers among
sliding-window ones; 0 for every Mamba-2 layer and every Whisper layer)
are Python ints. A MoE model's leading dense layers are their own group
(``first_dense_layers``), and DeepSeek-V3's multi-token prediction adds
the ``mtp`` subtree and its loss term. An encoder-decoder (Whisper)
adds the ``encoder`` stack and ``enc_norm``: ``encode_audio`` runs the
frame embeddings (``enc_frames``, ``batch["frames"]``) with sinusoidal
positions through the bidirectional encoder, and each decoder layer
attends to its output. A group's decode caches are layer-stacked dicts:
a KV ring cache with a length axis, the Mamba-2 conv and SSM states,
which have none, and a cross block's encoder keys and values
(``enc_len`` entries). Like the reference, ``forward`` and the encoder
add interleaved sin / cos positions, and ``decode_step`` the
concatenated halves of ``layers.sinusoidal_positions_dynamic``.

The memory levers are honoured: ``cfg.remat`` (on in every published
config) runs each layer of a training forward through
``layers.recompute``, and ``flash_chunk_remat`` each kv chunk of the
flash loop; the backward pass recomputes them, and the values and
gradients keep their bits. ``shard_activations`` (a sharding
constraint over a device mesh) raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.blocks import apply_block, init_block, \
    make_block_cache
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

#: DeepSeek-V3's weight of the multi-token-prediction loss
MTP_WEIGHT = 0.3


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run."""
    if cfg.shard_activations:
        raise NotImplementedError(
            "shard_activations: a sharding constraint over a device mesh, "
            "which the port does not build (one device runs every user); "
            "the port never ignores it")


# ----------------------------------------------------------- group layout
def layer_groups(cfg: ModelConfig, long_context: bool = False):
    """Static group descriptors: (name, block_type, n_layers, windows)."""
    check_ported(cfg)
    win = cfg.layer_windows(0, long_context=long_context)
    if cfg.family in ("dense", "vlm"):
        return [("blocks0", "dense", cfg.num_layers, win)]
    if cfg.family == "moe":
        fd = cfg.first_dense_layers
        groups = [("blocks0", "dense", fd, win[:fd])] if fd else []
        groups.append(("blocks1", "moe", cfg.num_layers - fd, win[fd:]))
        return groups
    if cfg.family == "ssm":
        return [("blocks0", "mamba", cfg.num_layers, [0] * cfg.num_layers)]
    if cfg.family == "hybrid":
        return [("blocks0", "hybrid", cfg.num_layers, win)]
    if cfg.family == "audio":
        return [("blocks0", "cross", cfg.num_layers, [0] * cfg.num_layers)]
    raise ValueError(cfg.family)


def _group_cfg(cfg, block_type):
    """A MoE model's leading dense layers run a dense-FFN stand-in
    config (no experts)."""
    if cfg.family == "moe" and block_type == "dense":
        return dataclasses.replace(cfg, num_experts=0)
    return cfg


# ----------------------------------------------------------- init
def init_params(key, cfg: ModelConfig, long_context: bool = False,
                device=None):
    """``key``: an int seed (a CPU ``torch.Generator`` draws, so one seed
    gives the same params on every device), a ``torch.Generator`` (draws
    on its device — a CUDA generator for a full-size model), or
    ``torch.device("meta")`` (shapes and dtypes only). The params go to
    ``device`` (``None`` = the CUDA device)."""
    if isinstance(key, (int, np.integer)):
        key = torch.Generator(device="cpu").manual_seed(int(key))
    dev = resolve_device(device) if isinstance(key, torch.Generator) \
        else torch.device(key)
    dtype = getattr(torch, cfg.param_dtype)
    params = {"embed": L.init_embedding(key, cfg, dtype),
              "final_norm": L.init_norm(key, cfg, dtype),
              "head": L.init_unembed(key, cfg, dtype)}
    for name, btype, n, _ in layer_groups(cfg, long_context):
        params[name] = init_block(key, _group_cfg(cfg, btype), btype, dtype,
                                  lead=(n,))
    if cfg.is_encdec:
        params["encoder"] = init_block(key, cfg, "encoder", dtype,
                                       lead=(cfg.encoder_layers,))
        params["enc_norm"] = L.init_norm(key, cfg, dtype)
    if cfg.use_mtp:
        params["mtp"] = {
            "proj": L.truncated_normal_init(
                key, (2 * cfg.d_model, cfg.d_model), 1.0, dtype),
            "norm_h": L.init_norm(key, cfg, dtype),
            "norm_e": L.init_norm(key, cfg, dtype),
            "block": init_block(key, cfg, "moe", dtype),
        }
    return tree_map(lambda p: p.to(dev), params)


# ----------------------------------------------------------- layer loop
def _layer(tree, i):
    return tree_map(lambda a: a[i], tree)


def _run_group(params_stack, x, *, cfg, block_type, windows, positions,
               caches=None, enc_out=None, chunk=1024, remat=False):
    """Apply a homogeneous block stack layer by layer. Returns (x,
    new_caches (layer-stacked, or None), aux_sum). ``remat`` (with no
    caches) runs each layer through ``layers.recompute``: the backward
    pass recomputes the layer from its input, its params (views of the
    stack) and ``positions`` / ``enc_out``, as the reference's
    ``jax.checkpoint`` of the scan body does."""
    gcfg = _group_cfg(cfg, block_type)
    new, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for i, w in enumerate(windows):
        p = _layer(params_stack, i)
        if remat and caches is None:
            x, a = _recompute_block(p, x, cfg=gcfg, block_type=block_type,
                                    positions=positions, window=w,
                                    enc_out=enc_out, chunk=chunk)
            c = None
        else:
            # a layer's own alias of ``enc_out``: its two uses' gradients
            # (the cross keys' and values') are summed before they join the
            # other layers', as under ``recompute``, so the two routes give
            # the encoder the same bits
            x, c, a = apply_block(
                p, x, cfg=gcfg, block_type=block_type, positions=positions,
                window=w, cache=None if caches is None else _layer(caches, i),
                enc_out=None if enc_out is None else enc_out.view_as(enc_out),
                chunk=chunk)
        new.append(c)
        aux = aux + a
    if caches is None:
        return x, None, aux
    return x, tree_map(lambda *ls: torch.stack(ls), *new), aux


def _recompute_block(params, x, *, positions, enc_out, **kw):
    """One layer's ``apply_block`` (no cache) through ``recompute``: the
    layer's param dict goes in as its leaves in ``tree_leaves`` order and
    is rebuilt inside the body. Returns (x, aux)."""
    leaves = tree_leaves(params)
    n = len(leaves)

    def body(x, positions, *rest):
        y, _, a = apply_block(
            tree_unflatten(params, rest[:n]), x, positions=positions,
            enc_out=rest[n] if len(rest) > n else None, **kw)
        return y, a

    extra = () if enc_out is None else (enc_out,)
    return L.recompute(body, x, positions, *leaves, *extra)


def _positions(offset, length, device):
    return offset + torch.arange(length, dtype=torch.int32, device=device)


# ----------------------------------------------------------- forward
def encode_audio(params, frames, cfg, chunk=1024):
    """Whisper encoder over stub frame embeddings (B, T_enc, D):
    interleaved sinusoidal positions added, the bidirectional encoder
    stack, then ``enc_norm``."""
    T = frames.shape[1]
    x = frames + L.sinusoidal_positions(
        T, cfg.d_model, device=frames.device)[None].to(frames.dtype)
    x, _, _ = _run_group(
        params["encoder"], x, cfg=cfg, block_type="encoder",
        windows=[0] * cfg.encoder_layers,
        positions=_positions(0, T, x.device), chunk=chunk, remat=cfg.remat)
    return L.apply_norm(params["enc_norm"], x, cfg.norm)


def embed_inputs(params, tokens, cfg, *, prefix_embeds=None, offset=0):
    """Token embedding (+ optional vision prefix, + abs positions)."""
    x = L.embed_tokens(params["embed"], tokens, cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    if not cfg.use_rope:  # whisper-style absolute sinusoidal positions
        x = x + L.sinusoidal_positions(
            x.shape[1], cfg.d_model, offset, device=x.device)[None].to(x.dtype)
    return x


def forward(params, tokens, cfg: ModelConfig, *, prefix_embeds=None,
            enc_frames=None, long_context=False, chunk=1024, caches=None,
            offset=0, return_hidden=False):
    """Full-sequence forward. Returns (logits, new_caches, aux_loss).

    ``enc_frames`` (B, T_enc, D): an encoder-decoder's stub frame
    embeddings, encoded once (``encode_audio``) for every cross block.
    ``caches`` non-None => prefill (cache written for later decode; the
    caller's caches are left as they were).
    ``return_hidden`` => first element is the final-normed hidden state
    instead of logits (chunked-loss path).
    """
    groups = layer_groups(cfg, long_context)
    x = embed_inputs(params, tokens, cfg, prefix_embeds=prefix_embeds,
                     offset=offset)
    x = x.to(cfg.activation_dtype)
    pos = _positions(offset, x.shape[1], x.device)
    enc_out = (encode_audio(params, enc_frames, cfg, chunk)
               if cfg.is_encdec else None)

    new_caches = {} if caches is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for name, btype, n, windows in groups:
        g_caches = caches.get(name) if caches is not None else None
        x, g_new, aux = _run_group(
            params[name], x, cfg=cfg, block_type=btype, windows=windows,
            positions=pos, caches=g_caches, enc_out=enc_out, chunk=chunk,
            remat=cfg.remat and caches is None)
        if new_caches is not None:
            new_caches[name] = g_new
        aux_total = aux_total + aux

    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, new_caches, aux_total
    logits = L.unembed(params["embed"], params.get("head"), x, cfg)
    return logits, new_caches, aux_total


# ----------------------------------------------------------- loss / train
def compute_loss(params, batch, cfg: ModelConfig, long_context=False,
                 chunk=1024):
    """Next-token CE (+ router aux, + MTP) for one local training batch.
    Runs under ``torch.func.vmap(torch.func.grad_and_value(...))``."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    prefix = batch.get("patches")
    frames = batch.get("frames")

    if cfg.loss_vocab_chunks > 1:
        hidden, _, aux = forward(
            params, inputs, cfg, prefix_embeds=prefix, enc_frames=frames,
            long_context=long_context, chunk=chunk, return_hidden=True)
        if prefix is not None:
            hidden = hidden[:, prefix.shape[1]:]
        table = (params["embed"]["embedding"] if cfg.tie_embeddings
                 else params["head"]["w_out"].T)
        loss = L.chunked_cross_entropy(hidden, table, labels, cfg)
    else:
        logits, _, aux = forward(
            params, inputs, cfg, prefix_embeds=prefix, enc_frames=frames,
            long_context=long_context, chunk=chunk)
        if prefix is not None:
            # vision prefix positions produce logits too; only text scored
            logits = logits[:, prefix.shape[1]:]
        loss = L.cross_entropy_loss(logits, labels, cfg.vocab_size)

    if cfg.use_mtp and prefix is None and frames is None:
        # DeepSeek-V3 multi-token prediction: one extra block predicting
        # token t+2 from (h_t, emb_{t+1}).
        loss = loss + MTP_WEIGHT * _mtp_loss(params, inputs, labels, cfg,
                                             chunk)
    return loss + aux


def _mtp_loss(params, inputs, labels, cfg, chunk):
    # re-embed, as the reference does
    x = L.embed_tokens(params["embed"], inputs, cfg).to(cfg.activation_dtype)
    emb_next = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
    h = L.apply_norm(params["mtp"]["norm_h"], x, cfg.norm)
    e = L.apply_norm(params["mtp"]["norm_e"], emb_next, cfg.norm)
    z = torch.cat([h, e], dim=-1) @ params["mtp"]["proj"]
    pos = _positions(0, z.shape[1], z.device)
    z, _, aux = apply_block(
        params["mtp"]["block"], z, cfg=cfg, block_type="moe",
        positions=pos, window=0, chunk=chunk)
    logits2 = L.unembed(params["embed"], params.get("head"),
                        L.apply_norm(params["final_norm"], z, cfg.norm), cfg)
    labels2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)],
                        dim=1)
    return L.cross_entropy_loss(logits2, labels2, cfg.vocab_size) + aux


# ----------------------------------------------------------- decode
def make_caches(cfg: ModelConfig, batch, cache_len, *, long_context=False,
                dtype=None, enc_len=None, device=None):
    """Layer-stacked decode caches for every group (+ cross kv of
    ``enc_len`` entries, by default ``cfg.encoder_seq`` for an
    encoder-decoder), on ``device`` (``None`` = the CUDA device;
    ``"meta"`` for shapes only)."""
    dtype = dtype or cfg.activation_dtype
    dev = resolve_device(device)
    if enc_len is None:
        enc_len = cfg.encoder_seq if cfg.is_encdec else 0
    caches = {}
    for name, btype, n, windows in layer_groups(cfg, long_context):
        skel = make_block_cache(cfg, btype, batch, cache_len, dtype,
                                device=dev, enc_len=enc_len)
        caches[name] = tree_map(
            lambda a: a.unsqueeze(0).expand((n,) + tuple(a.shape))
            .contiguous(), skel)
    return caches


def decode_step(params, caches, token, index, cfg: ModelConfig, *,
                long_context=False, chunk=1024):
    """One-token decode. token: (B,) int; index: the absolute position
    (an int or a 0-dim integer tensor). Returns (logits (B, V),
    new_caches)."""
    groups = layer_groups(cfg, long_context)
    x = L.embed_tokens(params["embed"], token[:, None], cfg)
    pos = (index.reshape(1).to(device=x.device, dtype=torch.int32)
           if isinstance(index, torch.Tensor) else
           torch.full((1,), int(index), dtype=torch.int32, device=x.device))
    if not cfg.use_rope:
        x = x + L.sinusoidal_positions_dynamic(
            pos, cfg.d_model)[None].to(x.dtype)
    x = x.to(cfg.activation_dtype)

    new_caches = {}
    for name, btype, n, windows in groups:
        x, new_caches[name], _ = _run_group(
            params[name], x, cfg=cfg, block_type=btype, windows=windows,
            positions=pos, caches=caches[name], chunk=chunk)

    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    logits = L.unembed(params["embed"], params.get("head"), x, cfg)
    return logits[:, 0], new_caches


def param_count(params) -> int:
    return int(sum(p.numel() for p in tree_leaves(params)))
