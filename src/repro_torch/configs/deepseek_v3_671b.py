"""DeepSeek-V3 671B — MoE with Multi-head Latent Attention and MTP.
[arXiv:2412.19437]

61L d_model=7168 128H d_ff=2048(per expert) vocab=129280,
MoE 1 shared + 256 routed experts, top-8. First 3 layers dense
(d_ff 18432). MLA: kv_lora_rank 512, q_lora_rank 1536, qk nope/rope
128/64, v 128. Multi-token-prediction: 1 extra depth.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,        # MLA: per-head kv decompressed from latent
    head_dim=128,
    d_ff=18432,              # dense-layer / shared-expert-equivalent hidden
    vocab_size=129280,
    attention_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=256,
    num_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    use_mtp=True,
    activation="swiglu",
    norm="rmsnorm",
)
