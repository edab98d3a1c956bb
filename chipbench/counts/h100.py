"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core
GPU data sheet, dense rates, no sparsity), at the card's full 700 W."""

#: dense bfloat16 tensor-core rate, FLOP/s
PEAK_BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
