"""Step builders + input specs shared by train and serve.

Port of ``repro/launch/steps.py``. One function per shape *kind*:
  train   -> train_step(params, batch)            = SGD on CE loss
  prefill -> prefill_step(params, caches, batch)  = logits + filled caches
  decode  -> serve_step(params, caches, token, index)

``input_specs``, ``params_struct`` and ``caches_struct`` return tensors
on the ``meta`` device: shapes and dtypes, no allocation.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import frontends
from repro_torch.models.model import (compute_loss, decode_step, forward,
                                      init_params, make_caches)
from repro_torch.tree import tree_leaves, tree_map

META = torch.device("meta")


def text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Text tokens for this shape (vlm: prefix patches use up sequence)."""
    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        return shape.seq_len - cfg.num_prefix_tokens
    return shape.seq_len


def params_struct(cfg: ModelConfig, long_context=False):
    return init_params(META, cfg, long_context=long_context)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Batch tensors on the meta device for train/prefill; the token and
    index for decode."""
    B = shape.global_batch
    S = text_len(cfg, shape)

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=META)

    tok = torch.int32
    if shape.kind == "train":
        specs = {"tokens": spec((B, S + 1), tok)}
    elif shape.kind == "prefill":
        specs = {"tokens": spec((B, S), tok)}
    else:  # decode: one new token
        return {"token": spec((B,), tok), "index": spec((), tok)}
    if cfg.family == "vlm":
        specs["patches"] = spec(*frontends.vision_patch_spec(
            B, cfg, cfg.activation_dtype))
    if cfg.family == "audio":
        specs["frames"] = spec(*frontends.audio_frame_spec(
            B, cfg, cfg.activation_dtype))
    return specs


def caches_struct(cfg: ModelConfig, shape: ShapeConfig, long_context=False,
                  bounded: bool = False):
    """bounded=True (beyond-paper lever): when every layer is windowed
    (long-context variants), allocate ring caches of window size instead
    of the full sequence — decode then touches O(window) KV per step."""
    cache_len = shape.seq_len
    if bounded:
        windows = cfg.layer_windows(shape.seq_len, long_context=long_context)
        if windows and all(w > 0 for w in windows):
            cache_len = min(cache_len, max(windows))
    return make_caches(cfg, shape.global_batch, cache_len,
                       long_context=long_context, device=META)


# ------------------------------------------------------------------ steps
def make_train_step(cfg: ModelConfig, lr: float = 1e-2, long_context=False):
    """``train_step(params, batch) -> (loss, new_params)``: one SGD step
    on a fresh copy of ``params`` (left untouched), through the fused SGD
    step (``kernels.ops.fused_sgd_leaves``: f32 math, cast back)."""
    def loss_fn(params, batch):
        return compute_loss(params, batch, cfg, long_context=long_context)

    grad_fn = torch.func.grad_and_value(loss_fn)

    def train_step(params, batch):
        grads, loss = grad_fn(params, batch)
        new_params = tree_map(lambda p: p.detach().clone(), params)
        with torch.no_grad():
            kops.fused_sgd_leaves(tree_leaves(new_params),
                                  [g.contiguous() for g in tree_leaves(grads)],
                                  lr)
        return loss, new_params

    return train_step


def make_prefill_step(cfg: ModelConfig, long_context=False):
    def prefill_step(params, caches, batch):
        logits, new_caches, _ = forward(
            params, batch["tokens"], cfg,
            prefix_embeds=batch.get("patches"),
            enc_frames=batch.get("frames"),
            long_context=long_context, caches=caches)
        return logits[:, -1], new_caches

    return prefill_step


def make_serve_step(cfg: ModelConfig, long_context=False):
    def serve_step(params, caches, token, index):
        return decode_step(params, caches, token, index, cfg,
                           long_context=long_context)

    return serve_step
