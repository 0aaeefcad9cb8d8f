"""Published peaks of one NVIDIA H100 SXM 80GB HBM3 (NVIDIA's data sheet,
dense rates, no sparsity), at the full 700 W power limit. A card set
below that limit runs slower under load; the harness prints the card's
limit beside every share of these peaks."""

PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12       # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12             # B/s
