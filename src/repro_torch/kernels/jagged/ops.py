"""Jagged <-> padded-dense sequence conversion (right-aligned, most recent
last: the DPP featurizer contract).

Port of ``repro.kernels.jagged.ops`` and ``repro.kernels.jagged.ref``.
``jagged_to_padded`` launches the CUDA kernel (``csrc/jagged_to_padded.cu``)
for CUDA tensors and runs ``jagged_to_padded_ref`` for CPU tensors.
``padded_to_jagged_ref`` is the inverse; the reference has no kernel for it.

dtype contract: the values keep their dtype, whatever it is (float32, bf16,
float16, int8 to int64, bool): the kernel moves bytes. int64 values stay
exact int64; the JAX version wraps them to int32 because jax runs with x64
off. The TPU wrapper's front pad of ``max_len`` rows and lane pad of D to
128 were DMA artifacts and are not carried over.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.build import KernelLibrary, check

LIBRARY = KernelLibrary(
    Path(__file__).parent / "csrc" / "jagged_to_padded.cu",
    {
        "jagged_to_padded_launch": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
            ctypes.c_int),
        "jagged_to_padded_word_bytes": (
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
            ctypes.c_int),
        "cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
)
_OFFSET_DTYPES = (torch.int32, torch.int64)
_launch = None          # jagged_to_padded_launch, bound at the first launch


def _check(values: torch.Tensor, offsets: torch.Tensor, max_len: int
           ) -> None:
    if values.dim() != 2 or offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"jagged_to_padded: want (N, D) values and (B+1,) "
                         f"offsets, got {tuple(values.shape)} and "
                         f"{tuple(offsets.shape)}")
    if offsets.dtype not in _OFFSET_DTYPES:
        raise TypeError(f"jagged_to_padded: offsets must be int32 or int64, "
                        f"got {offsets.dtype}")
    if max_len < 0:
        raise ValueError(f"jagged_to_padded: max_len {max_len} < 0")


def jagged_to_padded_ref(values: torch.Tensor, offsets: torch.Tensor,
                         max_len: int) -> torch.Tensor:
    """Plain PyTorch version of ``jagged_to_padded`` (same contract): a
    gather of each row's ``max_len``-position window ending at
    ``offsets[b+1]``, source rows clamped into ``[0, N)``, and the
    right-align mask."""
    _check(values, offsets, max_len)
    n, d = values.shape
    b = offsets.shape[0] - 1
    if b == 0 or max_len == 0 or d == 0 or n == 0:
        return torch.zeros((b, max_len, d), dtype=values.dtype,
                           device=values.device)
    offs = offsets.to(torch.int64)
    ends = offs[1:]
    lens = torch.clamp(ends - offs[:-1], max=max_len)
    j = torch.arange(max_len, device=values.device)[None, :]
    valid = j >= (max_len - lens)[:, None]                        # (B, L)
    src = torch.clamp(ends[:, None] - max_len + j, 0, n - 1)
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    return torch.where(valid[..., None], values[src], zero)


def jagged_to_padded(values: torch.Tensor, offsets: torch.Tensor,
                     max_len: int) -> torch.Tensor:
    """(N, D) values + (B+1,) offsets -> (B, max_len, D), right-aligned.

    Row b holds the last ``min(offsets[b+1] - offsets[b], max_len)`` rows of
    its segment at its end, zeros (all bits 0) before them; a segment of
    negative length gives an all-zero row. Source rows are clamped into
    ``[0, N)``, so malformed offsets never read outside the arena. ``values``
    is any dtype and must be contiguous (it is never copied); ``offsets`` is
    int32 or int64 and is read in its own width.

    Launches the CUDA kernel for CUDA tensors (counted in
    ``jagged_to_padded.launches``) and runs ``jagged_to_padded_ref`` for CPU
    tensors. ``B == 0``, ``max_len == 0``, ``D == 0`` or ``N == 0`` returns
    zeros without a launch."""
    global _launch
    if not runtime.use_kernel(values, offsets):
        return jagged_to_padded_ref(values, offsets, max_len)
    _check(values, offsets, max_len)
    if not values.is_contiguous():
        raise ValueError("jagged_to_padded: values must be contiguous (the "
                         "arena is not copied)")
    n, d = values.shape
    b = offsets.shape[0] - 1
    out = torch.empty((b, max_len, d), dtype=values.dtype,
                      device=values.device)
    if b == 0 or max_len == 0 or d == 0 or n == 0:
        return out.zero_()
    offs = offsets.contiguous()
    launch = _launch
    if launch is None:
        launch = _launch = LIBRARY.function("jagged_to_padded_launch")
    status = launch(values.data_ptr(), offs.data_ptr(),
                    int(offs.dtype == torch.int64), n, b, max_len,
                    d * values.element_size(), out.data_ptr(),
                    runtime.raw_stream(values))
    if status:
        check(LIBRARY, status)
    jagged_to_padded.launches += 1
    return out


jagged_to_padded.launches = 0


def word_bytes(values: torch.Tensor, out: torch.Tensor) -> int:
    """The width in bytes (16, 4 or 1) of the words the kernel moves for
    these card tensors: 16 only when the row bytes and both base pointers
    are 16-byte aligned."""
    return LIBRARY.lib().jagged_to_padded_word_bytes(
        values.data_ptr(), values.shape[1] * values.element_size(),
        out.data_ptr())


def padded_to_jagged_ref(padded: torch.Tensor, offsets: torch.Tensor,
                         total: int) -> torch.Tensor:
    """Inverse of ``jagged_to_padded`` for rows whose length is at most L:
    scatter-add the right-aligned rows of (B, L, D) ``padded`` back into a
    (total, D) jagged buffer. Positions outside a row's kept span, and
    destinations at or past ``total``, are dropped."""
    b, l, d = padded.shape
    offs = offsets.to(torch.int64)
    ends = offs[1:]
    lens = torch.clamp(ends - offs[:-1], max=l)
    j = torch.arange(l, device=padded.device)[None, :]
    dst = ends[:, None] - l + j
    valid = (j >= (l - lens)[:, None]) & (dst >= 0) & (dst < total)
    out = torch.zeros((total + 1, d), dtype=padded.dtype,
                      device=padded.device)
    out.index_add_(0, torch.where(valid, dst, total).reshape(-1),
                   padded.reshape(-1, d))
    return out[:total]
