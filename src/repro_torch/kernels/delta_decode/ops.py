"""Batched delta decode (row-wise prefix sum plus base) of columnar stripes.

Port of ``repro.kernels.delta_decode.ops`` and ``repro.kernels.delta_decode
.ref``. ``delta_decode`` launches the CUDA kernel (``csrc/delta_decode.cu``)
for CUDA tensors and runs ``delta_decode_ref`` for CPU tensors.

dtype contract, as the reference's wrapper: if either input is int64 the
decode is int64 and exact; otherwise both are cast to int32 and the sums
wrap in two's complement, as ``jnp.cumsum(..., dtype=int32)`` does. Two
departures: the result stays on the inputs' device (the reference returns
a numpy array for int64 inputs), and there is no host fallback for int64
windows that span more than int32 (the reference decodes those on the
host): the int64 kernel carries in 64 bits and is exact on the card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.build import KernelLibrary, check

LIBRARY = KernelLibrary(
    Path(__file__).parent / "csrc" / "delta_decode.cu",
    {
        "delta_decode_launch": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                                + [ctypes.c_void_p] * 2, ctypes.c_int),
        "cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
)
_MAX_N = 2**31 - 2**12      # the kernel's int column index never overflows


def _decode_dtype(deltas: torch.Tensor, bases: torch.Tensor) -> torch.dtype:
    """int64 if either input is int64, else int32 (``ops.py:55-57``)."""
    if deltas.dim() != 2 or bases.shape != deltas.shape[:1]:
        raise ValueError(f"delta_decode: want (B, N) deltas and (B,) bases, "
                         f"got {tuple(deltas.shape)} and "
                         f"{tuple(bases.shape)}")
    wide = torch.int64 in (deltas.dtype, bases.dtype)
    return torch.int64 if wide else torch.int32


def delta_decode_ref(deltas: torch.Tensor, bases: torch.Tensor
                     ) -> torch.Tensor:
    """Plain PyTorch version of ``delta_decode`` (same contract): an int64
    cumsum plus the base, wrapped to int32 on the int32 path."""
    dt = _decode_dtype(deltas, bases)
    d = deltas.to(dt).to(torch.int64)
    out = torch.cumsum(d, dim=1) + bases.to(dt).to(torch.int64)[:, None]
    return out.to(dt)                                   # int32: wraps


def delta_decode(deltas: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """(B, N) deltas + (B,) bases -> (B, N) ``bases[:, None] + cumsum``.

    int64 if either input is int64 (exact), else int32 (wrapping); the
    result lies on the inputs' device.

    Launches the CUDA kernel for CUDA tensors (counted in
    ``delta_decode.launches``) and runs ``delta_decode_ref`` for CPU
    tensors. ``B == 0`` or ``N == 0`` returns zeros without a launch."""
    if not runtime.use_kernel(deltas, bases):
        return delta_decode_ref(deltas, bases)
    dt = _decode_dtype(deltas, bases)
    b, n = deltas.shape
    out = torch.empty((b, n), dtype=dt, device=deltas.device)
    if b == 0 or n == 0:
        return out
    if n > _MAX_N:
        raise ValueError(f"delta_decode: {n} columns, at most {_MAX_N}")
    d = deltas.to(dt).contiguous()
    bs = bases.to(dt).contiguous()
    stream = torch.cuda.current_stream(deltas.device).cuda_stream
    status = LIBRARY.lib().delta_decode_launch(
        d.data_ptr(), bs.data_ptr(), b, n, int(dt == torch.int64),
        out.data_ptr(), stream)
    check(LIBRARY, status)
    delta_decode.launches += 1
    return out


delta_decode.launches = 0
