"""Products over groups of rows of varying length, one weight matrix a group
(a dropless MoE layer's routed experts): a CUDA kernel on the card, a loop
of ``matmul`` over the groups on the CPU.

Not a port of a Pallas kernel: the reference's MoE runs one batched product
over a fixed capacity (``repro.models.moe._moe_inner``). Here the rows of
group g are ``[offsets[g], offsets[g + 1])`` and the offsets stay on the
card, so no host sync is needed to know how many rows an expert got.
``grouped_mm(a, w, offsets)`` is the product ``C[r] = A[r] @ W[g]``, with
``torch.autograd`` through it: its backward runs the same kernel for the
rows' gradient (``DX``, ``dY @ W[g]^T``) and for each group's weight
gradient (``DW``, ``A[g's rows]^T @ dY[g's rows]``). Rows past
``offsets[-1]`` read as zero in C and in the rows' gradient.

Counters: ``grouped_gemm.launches`` (kernel launches, every form) and
``flops()``, the operations the launches did (2 x rows x K x N each), summed
on the card so that counting takes no sync; ``flops()`` itself reads the
card.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.build import KernelLibrary, check

LIBRARY = KernelLibrary(
    Path(__file__).parent / "csrc" / "grouped_gemm.cu",
    {
        "grouped_gemm_launch": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
        "cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
)
FWD, DX, DW = 0, 1, 2      # the kernel's forms (csrc/grouped_gemm.cu)
STEP = 32                  # K and N must be multiples of it
_launch = None             # grouped_gemm_launch, bound at the first launch
_FLOPS: Dict[torch.device, torch.Tensor] = {}   # int64 sums on each card


def _accumulate(totals: Dict[torch.device, torch.Tensor],
                x: torch.Tensor) -> None:
    acc = totals.get(x.device)
    if acc is None:
        totals[x.device] = x.clone()
    else:
        acc.add_(x)


def grouped_gemm_ref(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
                     mode: int) -> torch.Tensor:
    """Plain version of ``grouped_gemm``: one ``matmul`` a group (reads
    the offsets on the host)."""
    off = [min(int(o), a.shape[0]) for o in offsets.tolist()]
    groups = len(off) - 1
    if mode == DW:
        out = a.new_zeros((groups, a.shape[1], b.shape[1]))
    else:
        out = a.new_zeros((a.shape[0], b.shape[2 if mode == FWD else 1]))
    for g in range(groups):
        lo, hi = off[g], off[g + 1]
        if mode == FWD:
            out[lo:hi] = a[lo:hi] @ b[g]
        elif mode == DX:
            out[lo:hi] = a[lo:hi] @ b[g].T
        else:
            out[g] = a[lo:hi].T @ b[lo:hi]
    return out


def _check(a, b, offsets, mode) -> None:
    if mode not in (FWD, DX, DW):
        raise ValueError(f"grouped_gemm: mode {mode} is none of FWD, DX, DW")
    if offsets.dtype != torch.int64 or offsets.ndim != 1 \
            or offsets.numel() < 2:
        raise ValueError(f"grouped_gemm: offsets must be int64 (groups + 1,), "
                         f"got {offsets.dtype} {tuple(offsets.shape)}")
    if a.ndim != 2 or b.ndim != (2 if mode == DW else 3):
        raise ValueError(f"grouped_gemm: operands of {a.ndim} and {b.ndim} "
                         f"dims for mode {mode}")
    groups = offsets.numel() - 1
    if mode == DW:
        ok = b.shape[0] == a.shape[0]
    else:
        ok = b.shape[0] == groups and a.shape[1] == b.shape[1 + (mode == DX)]
    if not ok:
        raise ValueError(f"grouped_gemm: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not fit mode {mode} over "
                         f"{groups} groups")
    if a.dtype != b.dtype:
        raise TypeError(f"grouped_gemm: operands of {a.dtype} and {b.dtype}")


def grouped_gemm(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
                 mode: int) -> torch.Tensor:
    """One form of the grouped product (module docstring; the forms as in
    ``csrc/grouped_gemm.cu``): FWD ``a`` (R, K), ``b`` = W (G, K, N) -> (R,
    N); DX ``a`` (R, N), ``b`` = W -> (R, K); DW ``a`` (R, K), ``b`` (R, N)
    -> (G, K, N). Rows of the result past ``offsets[-1]`` are zero.

    For CUDA tensors: bf16 operands, K and N multiples of ``STEP``, one
    launch counted in ``grouped_gemm.launches``, its operations added to
    ``flops()``. Runs ``grouped_gemm_ref`` for CPU tensors."""
    global _launch
    _check(a, b, offsets, mode)
    if not runtime.use_kernel(a, b, offsets):
        return grouped_gemm_ref(a, b, offsets, mode)
    if a.dtype != torch.bfloat16:
        raise TypeError(f"grouped_gemm: the kernel takes bf16, got {a.dtype}")
    dev = a.device
    if b.device != dev or offsets.device != dev:
        raise ValueError(f"grouped_gemm: tensors on {a.device}, {b.device} "
                         f"and {offsets.device}")
    a, b, offsets = a.contiguous(), b.contiguous(), offsets.contiguous()
    groups = offsets.numel() - 1
    k, n = (a.shape[1], b.shape[1]) if mode == DW else b.shape[1:]
    if k % STEP or n % STEP:
        raise ValueError(f"grouped_gemm: K {k} and N {n} must be multiples "
                         f"of {STEP}")
    for name, t in (("a", a), ("b", b)):
        if t.data_ptr() % 16:
            raise ValueError(f"grouped_gemm: {name} is not 16-byte aligned")
    rows = a.shape[0]
    if mode == DW:
        out = torch.empty((groups, k, n), dtype=a.dtype, device=dev)
    else:
        out = torch.zeros((rows, n if mode == FWD else k), dtype=a.dtype,
                          device=dev)
    launch = _launch
    if launch is None:
        launch = _launch = LIBRARY.function("grouped_gemm_launch")
    status = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    offsets.data_ptr(), rows, groups, k, n, mode,
                    runtime.raw_stream(out))
    if status:
        check(LIBRARY, status)
    grouped_gemm.launches += 1
    _accumulate(_FLOPS, offsets[-1].clamp(max=rows) * (2 * k * n))
    return out


grouped_gemm.launches = 0    # kernel launches, every form


def flops() -> int:
    """Operations of every kernel launch so far (reads the card)."""
    return sum(int(t) for t in _FLOPS.values())


class _GroupedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, offsets):
        ctx.save_for_backward(a, w, offsets)
        return grouped_gemm(a, w, offsets, FWD)

    @staticmethod
    def backward(ctx, dy):
        a, w, offsets = ctx.saved_tensors
        dy = dy.contiguous()
        da = grouped_gemm(dy, w, offsets, DX) if ctx.needs_input_grad[0] \
            else None
        dw = grouped_gemm(a, dy, offsets, DW) if ctx.needs_input_grad[1] \
            else None
        return da, dw, None


def grouped_mm(a: torch.Tensor, w: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """``C[r] = a[r] @ w[g]`` for the rows r of group g (module docstring),
    differentiable in ``a`` and ``w``."""
    return _GroupedMM.apply(a, w, offsets)
