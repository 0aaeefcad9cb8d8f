"""Config dataclasses for architectures and input shapes.

Every assigned architecture gets one module in this package defining a
``CONFIG = ModelConfig(...)`` with the exact published dimensions (source
cited in the module docstring) plus a ``reduced()`` smoke variant used by
CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ---------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""       # citation for the published dims

    # -- core dims --------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0      # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000

    # -- attention --------------------------------------------------------
    attention_type: str = "gqa"          # gqa | mla | none (pure ssm)
    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: int = 0              # 0 = full attention on every layer
    local_global_pattern: Tuple[str, ...] = ()  # e.g. ("local","global") cycle
    local_window: int = 4096
    attn_logit_softcap: float = 0.0      # 0 = disabled
    final_logit_softcap: float = 0.0
    # long-context variant: window applied to *all* layers for the
    # long_500k shape only (documented adaptation for full-attention archs)
    long_context_window: int = 8192

    # -- MLA (DeepSeek latent attention) -----------------------------------
    q_lora_rank: int = 0                 # 0 = full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # -- MoE ----------------------------------------------------------------
    num_experts: int = 0                 # 0 = dense FFN
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                    # per-expert hidden (d_ff used for dense/shared)
    first_dense_layers: int = 0          # DeepSeek: leading dense blocks
    moe_capacity_factor: float = 1.25
    router_aux_loss: float = 0.001
    # multi-token prediction (DeepSeek-V3): one extra scanned block + head
    use_mtp: bool = False

    # -- SSM (Mamba-2 SSD) ---------------------------------------------------
    ssm_state: int = 0                   # 0 = no ssm path
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # -- hybrid (Hymba): both attention and ssm in every block ---------------
    hybrid: bool = False

    # -- encoder/decoder (whisper backbone) ----------------------------------
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500              # whisper: 30 s audio -> 1500 frames

    # -- modality frontend STUB ----------------------------------------------
    frontend: str = ""                   # "" | "audio" | "vision"
    num_prefix_tokens: int = 0           # vision patches prepended to text

    # -- misc -----------------------------------------------------------------
    use_post_norm: bool = False          # gemma2 norm sandwich
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    activation: str = "swiglu"           # swiglu | geglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256        # pad vocab so it shards over tensor axis
    remat: bool = True                   # activation checkpointing in scan
    scan_unroll: int = 1                 # dryrun cost-correction variants only

    # -- beyond-paper perf levers (EXPERIMENTS.md §Perf; default = paper
    #    -faithful baseline, hillclimbs flip these) ----------------------
    shard_activations: Tuple[str, ...] = ()   # e.g. ("data",): constrain
    #   block activations to P(batch_axes, None, None)
    flash_chunk_remat: bool = False      # recompute flash softmax in bwd
    loss_vocab_chunks: int = 1           # chunked CE: never materialize
    #   the full (tokens, vocab) f32 logits for training loss
    moe_gather_weights: bool = False     # constrain expert weights to
    #   P('model',None,None) inside the FFN: pay one weight all-gather
    #   instead of per-matmul activation all-reduces
    moe_buf_shard: bool = False          # shard the dispatch capacity dim
    #   over 'data' (with gathered weights the expert FFN then needs no
    #   reduction at all and its FLOPs drop 16x per device)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return _ceil_to(self.vocab_size, self.vocab_pad_multiple)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def activation_dtype(self):
        return getattr(torch, self.dtype)

    def layer_windows(self, seq_len: int, long_context: bool = False) -> list:
        """Per-layer attention window (0 = full causal) for ``num_layers``."""
        if long_context and not self.is_subquadratic:
            # documented long-context variant: window on every layer
            base = [self.long_context_window] * self.num_layers
        elif self.local_global_pattern:
            cyc = self.local_global_pattern
            base = [
                (self.local_window if cyc[i % len(cyc)] == "local" else 0)
                for i in range(self.num_layers)
            ]
            if long_context:
                # global layers fall back to the long-context window
                base = [w if w else self.long_context_window for w in base]
        elif self.sliding_window:
            base = [self.sliding_window] * self.num_layers
        else:
            base = [0] * self.num_layers
        return base

    @property
    def is_subquadratic(self) -> bool:
        """True when decode-state is bounded (SSM / all-sliding-window)."""
        if self.family == "ssm":
            return True
        if self.hybrid and self.sliding_window:
            return True
        return False

    @property
    def kv_cache_per_token_bytes(self) -> int:
        """bf16 KV-cache bytes per token per layer (for roofline napkin math)."""
        if self.attention_type == "mla":
            return 2 * (self.kv_lora_rank + self.qk_rope_head_dim)
        return 2 * 2 * self.num_kv_heads * self.resolved_head_dim

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_d_ff=min(self.moe_d_ff, 256),
            first_dense_layers=min(self.first_dense_layers, 1),
            # no token dropping at smoke scale: decode parity vs forward
            moe_capacity_factor=float(max(self.num_experts, 1)),
            q_lora_rank=min(self.q_lora_rank, 64),
            kv_lora_rank=min(self.kv_lora_rank, 64),
            qk_nope_head_dim=32,
            qk_rope_head_dim=16,
            v_head_dim=32,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64),
            num_prefix_tokens=min(self.num_prefix_tokens, 16),
            local_window=64,
            sliding_window=64 if self.sliding_window else 0,
            long_context_window=64,
            ssm_chunk=32,
            dtype="float32",
            param_dtype="float32",
            vocab_pad_multiple=16,
            remat=False,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
    long_context: bool = False


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode", long_context=True),
}
