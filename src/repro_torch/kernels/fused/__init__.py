"""Fused device-side late materialization (decode -> densify -> embed)."""
from repro_torch.kernels.fused.ops import (  # noqa: F401
    fused_densify,
    fused_densify_ref,
    late_materialize,
    pack_arena,
    unpack_dense,
)
