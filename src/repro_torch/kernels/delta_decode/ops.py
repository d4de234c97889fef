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
        "delta_decode_launch": (
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
            ctypes.c_int),
        "delta_decode_vector_path": (
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
        "cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
)
_MAX_N = 2**31 - 2**12      # the kernel's int column index never overflows
_WIDE = {torch.int32: 0, torch.int64: 1}    # read in their own width
_launch = None              # delta_decode_launch, bound at the first launch


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


def vector_path(deltas: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel moves these card tensors' columns as 16-byte
    vectors (every row of both starts 16-byte aligned), or scalar."""
    return bool(LIBRARY.function("delta_decode_vector_path")(
        deltas.data_ptr(), deltas.stride(0), _WIDE[deltas.dtype],
        deltas.shape[1], out.data_ptr(), _WIDE[out.dtype]))


def delta_decode(deltas: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """(B, N) deltas + (B,) bases -> (B, N) ``bases[:, None] + cumsum``.

    int64 if either input is int64 (exact), else int32 (wrapping); the
    result lies on the inputs' device.

    Launches the CUDA kernel for CUDA tensors, one launch a call (counted in
    ``delta_decode.launches``): int32 and int64 inputs are read in their own
    width, mixed ones too, and rows may be strided; other integer dtypes are
    cast to the result's dtype first, and deltas whose columns are not
    unit-stride are copied. Runs ``delta_decode_ref`` for CPU tensors.
    ``B == 0`` or ``N == 0`` returns an empty result without a launch."""
    global _launch
    if not runtime.use_kernel(deltas, bases):
        return delta_decode_ref(deltas, bases)
    dt = _decode_dtype(deltas, bases)
    b, n = deltas.shape
    out = deltas.new_empty((b, n), dtype=dt)
    if b == 0 or n == 0:
        return out
    if n > _MAX_N:
        raise ValueError(f"delta_decode: {n} columns, at most {_MAX_N}")
    d_wide = _WIDE.get(deltas.dtype)
    if d_wide is None:                   # an explicit conversion, not a route
        deltas, d_wide = deltas.to(dt), _WIDE[dt]
    b_wide = _WIDE.get(bases.dtype)
    if b_wide is None:
        bases, b_wide = bases.to(dt), _WIDE[dt]
    row, col = deltas.stride()
    if col != 1 and n > 1:
        deltas = deltas.contiguous()
        row = n
    launch = _launch
    if launch is None:
        launch = _launch = LIBRARY.function("delta_decode_launch")
    status = launch(deltas.data_ptr(), row, d_wide,
                    bases.data_ptr(), bases.stride(0), b_wide, b, n,
                    out.data_ptr(), runtime.raw_stream(deltas))
    if status:
        check(LIBRARY, status)
    delta_decode.launches += 1
    return out


delta_decode.launches = 0
