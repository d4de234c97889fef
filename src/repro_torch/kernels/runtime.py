"""Shared kernel execution policy: kernel for a CUDA tensor, plain version for
a CPU tensor.

Counterpart of ``repro.kernels.runtime``. There is deliberately no switch that
forces the plain version on the card: a wrapper handed a CUDA tensor launches
its kernel or raises, so a run on the card can never silently bypass the
kernel. The CPU route exists for the tier-1 tests, which run the plain
versions against the JAX reference.
"""
from __future__ import annotations

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True iff every tensor lies on a CUDA device (launch the kernel); False
    iff every tensor lies on the CPU (run the plain version). Raises on any
    other device or on a mix."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all be on CUDA or all on the CPU, "
                     f"got devices {sorted(types)}")
