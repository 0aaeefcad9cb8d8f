"""Gemma-2 27B — dense GQA with alternating local/global attention and
logit soft-capping. [arXiv:2408.00118]

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Local layers use a 4096-token sliding window; attn softcap 50, final
logit softcap 30 (per the Gemma-2 report). GeGLU activation.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    source="arXiv:2408.00118",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    rope_theta=10000.0,
    local_global_pattern=("local", "global"),
    local_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    activation="geglu",
    use_post_norm=True,
    norm="rmsnorm",
    tie_embeddings=True,
)
