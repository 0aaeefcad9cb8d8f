"""Published peaks of one NVIDIA H100 SXM 80GB HBM3 (NVIDIA's data sheet,
dense rates, no sparsity), at the full 700 W power limit. A card set
below that limit runs slower under load; the harness prints the card's
limit beside every share of these peaks."""

PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12       # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12             # B/s

#: bytes of one element of a configuration's dtype
ITEM_BYTES = {"float32": 4, "bfloat16": 2}


def peak_flops(dtype: str, tf32: bool = False) -> float:
    """The peak of a configuration's compute ``dtype``: f32 with TF32
    off, or bf16."""
    if dtype == "float32" and not tf32:
        return PEAK_FLOPS_F32
    if dtype == "bfloat16":
        return PEAK_FLOPS_BF16
    raise ValueError(f"no peak for dtype {dtype!r} (tf32={tf32})")
