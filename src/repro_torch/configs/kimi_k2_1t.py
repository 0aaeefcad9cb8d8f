"""Kimi K2 1T-A32B — trillion-parameter MoE (paper-table spec).
[arXiv:2501.kimi2]

61L d_model=7168 64H (GQA kv=8) d_ff=2048(per expert) vocab=163840,
MoE 384 routed experts top-8 + 1 shared. First layer dense, per the
DeepSeek-style recipe the assignment table follows. The assignment
table specifies GQA kv=8 (not MLA); we follow the table.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2 (assignment paper-table)",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,              # dense-layer hidden
    vocab_size=163840,
    num_experts=384,
    num_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    first_dense_layers=1,
    activation="swiglu",
    norm="rmsnorm",
)
