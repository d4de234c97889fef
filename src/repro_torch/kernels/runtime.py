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
    for t in tensors:
        if not t.is_cuda:
            break
    else:
        return True
    if all(t.device.type == "cpu" for t in tensors):
        return False
    types = sorted({t.device.type for t in tensors})
    raise ValueError(f"kernel inputs must all be on CUDA or all on the CPU, "
                     f"got devices {types}")


def raw_stream(t: torch.Tensor) -> int:
    """The raw handle of the caller's current stream on ``t``'s card (never
    stream 0 in its place: ``DevicePrefetcher`` launches on a side stream).
    ``torch._C._cuda_getCurrentRawStream`` reads it without building a
    ``torch.cuda.Stream``; it exists only in a CUDA build of PyTorch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
