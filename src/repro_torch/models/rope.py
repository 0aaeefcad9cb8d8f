"""Rotary position embeddings (port of ``repro/models/rope.py``): split
halves, in f32, cast back."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim//2,)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., seq, hd/2)
    sin = torch.sin(angles)[..., None, :]                      # (..., seq, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
