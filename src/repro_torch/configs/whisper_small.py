"""Whisper-small — encoder-decoder audio backbone. [arXiv:2212.04356]

12L (12 encoder + 12 decoder) d_model=768 12H (kv=12) d_ff=3072
vocab=51865. The mel-spectrogram + conv frontend is a STUB per the
assignment carve-out: ``input_specs`` provides precomputed frame
embeddings (1500 x 768 for 30 s of audio). Positions are sinusoidal on
both sides (the real decoder uses learned positions capped at 448; we
use unbounded sinusoidal so decode shapes lower mechanically — see
DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=12,           # decoder layers
    encoder_layers=12,
    is_encdec=True,
    encoder_seq=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    use_rope=False,          # sinusoidal absolute positions
    activation="gelu",
    norm="layernorm",
    frontend="audio",
    tie_embeddings=True,
)
