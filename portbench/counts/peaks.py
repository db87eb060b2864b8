"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity; at the full 700 W power limit)."""

BF16_FLOP_PER_S = 989e12        # tensor cores, bf16 and fp16
HBM_BYTES_PER_S = 3.35e12       # 80 GB of HBM3
