"""Fused device-side late materialization (decode -> densify)."""
from repro_torch.kernels.fused.ops import (  # noqa: F401
    fused_densify,
    fused_densify_ref,
    pack_arena,
    unpack_dense,
)
