"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit), the yardstick of
every roofline share and of ``mfu``."""

DENSE_TENSOR_FLOPS = 989e12  # bf16/fp16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12
F32_CUDA_CORE_FLOPS = 67e12  # beside it, for reading; no share uses it
