"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""

FP32_FLOP_PER_S = 67e12     # float32 outside the tensor cores (TF32 off)
HBM_BYTES_PER_S = 3.35e12   # HBM3
