"""EmbeddingBag: fused gather + masked bag reduction.

Port of ``repro.kernels.embedding_bag.ops``. ``embedding_bag`` launches the
CUDA kernel (``csrc/embedding_bag.cu``) for CUDA tensors and runs
``embedding_bag_ref`` for CPU tensors. Forward only: the reference defines no
VJP. The TPU wrapper's lane pad of D to 128 was a DMA artifact and is not
carried over.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.build import KernelLibrary, check

LIBRARY = KernelLibrary(
    Path(__file__).parent / "csrc" / "embedding_bag.cu",
    {
        "embedding_bag_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                 + [ctypes.c_void_p], ctypes.c_int),
        "cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_COMBINERS = ("sum", "mean")


def _combine(out: torch.Tensor, mask: torch.Tensor, combiner: str
             ) -> torch.Tensor:
    """The ``mean`` combiner in the output dtype, as ``ops.py:31-33`` of the
    reference: the denominator is ``max(sum(mask), 1)``."""
    if combiner == "mean":
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
        out = out / denom.to(out.dtype)
    return out


def _check_combiner(combiner: str) -> None:
    if combiner not in _COMBINERS:
        raise ValueError(f"embedding_bag: combiner {combiner!r} not in "
                         f"{_COMBINERS}")


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      mask: torch.Tensor, combiner: str = "sum"
                      ) -> torch.Tensor:
    """Plain PyTorch version of ``embedding_bag`` (same contract): ids cast
    to int32 and clamped into ``[0, V)``, the gathered rows multiplied by the
    mask in the table's dtype and summed over the bag axis."""
    _check_combiner(combiner)
    v, d = table.shape
    b, l = ids.shape
    if b == 0 or l == 0:
        out = torch.zeros((b, d), dtype=table.dtype, device=table.device)
    else:
        idx = torch.clamp(ids.to(torch.int32), 0, v - 1).long()
        rows = table[idx] * mask.to(table.dtype)[..., None]
        out = rows.sum(dim=1)
    return _combine(out, mask, combiner)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """(V, D) table, (B, L) ids and mask -> (B, D) in the table's dtype.

    ids are cast to int32 and clamped into ``[0, V)`` before any row is read,
    so the featurizer's padded (and any poisoned) lanes ride through under
    mask 0. The weight of a position is the mask in the table's dtype.

    Launches the CUDA kernel for CUDA tensors (counted in
    ``embedding_bag.launches``; float32 and bf16 tables) and runs
    ``embedding_bag_ref`` for CPU tensors. An empty batch, ``L == 0`` or
    ``D == 0`` returns zeros without a launch."""
    _check_combiner(combiner)
    if not runtime.use_kernel(table, ids, mask):
        return embedding_bag_ref(table, ids, mask, combiner)
    if table.dim() != 2 or ids.dim() != 2 or mask.shape != ids.shape:
        raise ValueError(f"embedding_bag: want a (V, D) table and (B, L) ids "
                         f"and mask, got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(mask.shape)}")
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"embedding_bag: table dtype {table.dtype} not in "
                        f"{sorted(map(str, _DTYPE_CODE))}")
    if not table.is_contiguous():
        raise ValueError("embedding_bag: the table must be contiguous")
    v, d = table.shape
    b, l = ids.shape
    if b == 0 or l == 0 or d == 0:
        out = torch.zeros((b, d), dtype=table.dtype, device=table.device)
        return _combine(out, mask, combiner)
    if v == 0:
        raise ValueError("embedding_bag: the table has no rows")
    ids32 = ids.to(torch.int32).contiguous()
    weights = mask.to(table.dtype).contiguous()
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    status = LIBRARY.lib().embedding_bag_launch(
        table.data_ptr(), ids32.data_ptr(), weights.data_ptr(),
        out.data_ptr(), b, l, d, v, _DTYPE_CODE[table.dtype], stream)
    check(LIBRARY, status)
    embedding_bag.launches += 1
    return _combine(out, mask, combiner)


embedding_bag.launches = 0
