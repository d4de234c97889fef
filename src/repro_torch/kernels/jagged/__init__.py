"""Jagged -> padded-dense conversion (CUDA kernel, plain versions)."""
from repro_torch.kernels.jagged.ops import (  # noqa: F401
    jagged_to_padded,
    jagged_to_padded_ref,
    padded_to_jagged_ref,
)
