"""Mamba-2 370M — attention-free SSM with state-space duality (SSD).
[arXiv:2405.21060]

48L d_model=1024, ssm_state=128, expand=2 (d_inner 2048, 32 heads of
head_dim 64), conv width 4, vocab=50280 (GPT-NeoX tokenizer).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                  # no MLP: mamba block is the whole layer
    vocab_size=50280,
    attention_type="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    activation="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)
