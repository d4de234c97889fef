"""Batched delta decode of columnar stripes (CUDA kernel, plain version)."""
from repro_torch.kernels.delta_decode.ops import (  # noqa: F401
    delta_decode,
    delta_decode_ref,
)
