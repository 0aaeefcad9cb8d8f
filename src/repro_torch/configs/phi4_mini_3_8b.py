"""Phi-4-mini 3.8B — dense RoPE SwiGLU GQA decoder with a large
multilingual vocab. [arXiv:2412.08905]

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    source="arXiv:2412.08905",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    rope_theta=10000.0,
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)
