"""Multi-tensor AdamW over a model's leaves (CUDA kernel, plain version)."""
from repro_torch.kernels.adamw.ops import (  # noqa: F401
    LeafTable, adamw, adamw_ref)
