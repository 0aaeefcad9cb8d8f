"""Stand-in modality frontends (port of ``repro/models/frontends.py``).

The [vlm] architecture gets the transformer backbone only: the ViT/CLIP
encoder is replaced by precomputed patch embeddings of the right shape.
``vision_patch_embeddings`` draws them (in distribution only, from a
``torch.Generator`` on its device) and ``vision_patch_spec`` gives their
``(shape, dtype)``. The audio helpers come with the audio slice.
"""
from __future__ import annotations

import torch

_AUDIO = ("audio frontends come with the audio slice (ROADMAP.md Queue A "
          "item 4)")


def audio_frame_embeddings(key, batch, cfg, dtype=None):
    raise NotImplementedError(_AUDIO)


def vision_patch_embeddings(key, batch, cfg, dtype=None):
    """Stand-in for CLIP-ViT patches + projector: (B, P, d_model), 0.02
    times a standard normal, on ``key``'s device."""
    dtype = dtype or cfg.activation_dtype
    x = torch.randn((batch, cfg.num_prefix_tokens, cfg.d_model),
                    generator=key, device=key.device)
    return (0.02 * x).to(dtype)


def audio_frame_spec(batch, cfg, dtype=None):
    raise NotImplementedError(_AUDIO)


def vision_patch_spec(batch, cfg, dtype=None):
    """The patch embeddings' ``(shape, dtype)``."""
    dtype = dtype or cfg.activation_dtype
    return (batch, cfg.num_prefix_tokens, cfg.d_model), dtype
