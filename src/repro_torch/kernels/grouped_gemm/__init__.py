"""Grouped products over rows of varying length (CUDA kernel, plain
version): a dropless MoE layer's routed experts."""
from repro_torch.kernels.grouped_gemm.ops import (  # noqa: F401
    grouped_gemm, grouped_gemm_ref, grouped_mm)
