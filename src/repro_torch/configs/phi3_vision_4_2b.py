"""Phi-3-vision 4.2B — phi3-mini language backbone + CLIP vision frontend.
[hf:microsoft/Phi-3-vision-128k-instruct]

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064. The ViT/CLIP
encoder + projector is a STUB per the assignment carve-out:
``input_specs`` provides 576 precomputed patch embeddings (24x24 grid)
already projected to d_model, prepended to the text tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    frontend="vision",
    num_prefix_tokens=576,
    activation="swiglu",
    norm="rmsnorm",
)
