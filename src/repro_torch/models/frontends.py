"""Stand-in modality frontends (port of ``repro/models/frontends.py``).

The [audio] and [vlm] architectures get the transformer backbone only:
the modality encoder (mel-spectrogram + conv codec, ViT/CLIP) is
replaced by precomputed embeddings of the right shape. The
``*_embeddings`` helpers draw them (in distribution only: 0.02 times a
standard normal from a ``torch.Generator``, on its device) and the
``*_spec`` helpers give their ``(shape, dtype)``.
"""
from __future__ import annotations

import torch


def _draw(key, shape, dtype):
    x = torch.randn(shape, generator=key, device=key.device)
    return (0.02 * x).to(dtype)


def audio_frame_embeddings(key, batch, cfg, dtype=None):
    """Stand-in for mel + conv1d x2 + GELU: (B, encoder_seq, d_model)."""
    return _draw(key, audio_frame_spec(batch, cfg)[0],
                 dtype or cfg.activation_dtype)


def vision_patch_embeddings(key, batch, cfg, dtype=None):
    """Stand-in for CLIP-ViT patches + projector: (B, P, d_model)."""
    return _draw(key, vision_patch_spec(batch, cfg)[0],
                 dtype or cfg.activation_dtype)


def audio_frame_spec(batch, cfg, dtype=None):
    """The frame embeddings' ``(shape, dtype)``."""
    dtype = dtype or cfg.activation_dtype
    return (batch, cfg.encoder_seq, cfg.d_model), dtype


def vision_patch_spec(batch, cfg, dtype=None):
    """The patch embeddings' ``(shape, dtype)``."""
    dtype = dtype or cfg.activation_dtype
    return (batch, cfg.num_prefix_tokens, cfg.d_model), dtype
