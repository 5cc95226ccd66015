"""The chip's peaks, the yardstick of every roofline and MFU metric, for
every architecture: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates
without sparsity, at the 700 W power limit."""

PEAK_BF16 = 989e12  # FLOP/s on the tensor cores
PEAK_TF32 = 495e12  # FLOP/s on the tensor cores
PEAK_F32 = 67e12  # FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
