"""Hymba-1.5B — hybrid-head decoder: parallel attention + Mamba heads in
every block. [arXiv:2411.13676]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention (2048) on all but 3 global layers (first,
middle, last), per the Hymba paper.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    hybrid=True,
    sliding_window=2048,
    # global full-attention on layers 0, 15, 31 handled via pattern below
    local_global_pattern=tuple(
        "global" if i in (0, 15, 31) else "local" for i in range(32)
    ),
    local_window=2048,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    activation="swiglu",
    norm="rmsnorm",
)
