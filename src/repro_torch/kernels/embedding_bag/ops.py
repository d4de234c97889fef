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
        "embedding_bag_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                                 + [ctypes.c_void_p], ctypes.c_int),
        "embedding_bag_plan": ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                               + [ctypes.POINTER(ctypes.c_int)], None),
        "cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ID_CODE = {torch.int32: 0, torch.int64: 1}          # read in their own width
_MASK_CODE = {torch.bool: 0, torch.float32: 1, torch.bfloat16: 2}
_COMBINERS = ("sum", "mean")
_MAX_MEAN_L = 2**24     # a mean's count stays exact in the kernel's float
_launch = None          # embedding_bag_launch, bound at the first launch


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


def launch_plan(table: torch.Tensor, b: int, l: int, out: torch.Tensor
                ) -> dict:
    """How the kernel lays out a (b, l) call on these card tensors:
    ``cluster``, the blocks (1, 2, 4 or 8) of the thread-block cluster that
    split each bag; ``vec``, the values a thread reads at a time (16 bytes'
    worth, or 1 on the scalar path); ``chunks``, the blocks across D."""
    plan = (ctypes.c_int * 3)()
    LIBRARY.function("embedding_bag_plan")(
        b, l, table.shape[1], _DTYPE_CODE[table.dtype], table.data_ptr(),
        out.data_ptr(), plan)
    return {"cluster": plan[0], "vec": plan[1], "chunks": plan[2]}


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  combiner: str = "sum") -> torch.Tensor:
    """(V, D) table, (B, L) ids and mask -> (B, D) in the table's dtype.

    ids are cast to int32 and clamped into ``[0, V)`` before any row is read,
    so the featurizer's padded (and any poisoned) lanes ride through under
    mask 0; an int64 id wraps to int32 first, as ``ids.to(torch.int32)``
    does. The weight of a position is the mask in the table's dtype; the
    ``mean`` divides by ``max(sum(mask), 1)`` in the table's dtype.

    Launches the CUDA kernel for CUDA tensors (float32 and bf16 tables):
    one launch a call for int32 or int64 ids, a bool, float32 or bf16 mask
    and either combiner, counted in ``embedding_bag.launches``. Other id
    dtypes are cast to int32 first, other mask dtypes to the table's dtype
    (whose sum then gives the mean's denominator). Runs
    ``embedding_bag_ref`` for CPU tensors. An empty batch, ``L == 0`` or
    ``D == 0`` returns zeros without a launch."""
    global _launch
    _check_combiner(combiner)
    if not runtime.use_kernel(table, ids, mask):
        return embedding_bag_ref(table, ids, mask, combiner)
    dtype_code = _DTYPE_CODE.get(table.dtype)
    if table.dim() != 2 or ids.dim() != 2 or mask.shape != ids.shape:
        raise ValueError(f"embedding_bag: want a (V, D) table and (B, L) ids "
                         f"and mask, got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(mask.shape)}")
    if dtype_code is None:
        raise TypeError(f"embedding_bag: table dtype {table.dtype} not in "
                        f"{sorted(map(str, _DTYPE_CODE))}")
    if not table.is_contiguous():
        raise ValueError("embedding_bag: the table must be contiguous")
    v, d = table.shape
    b, l = ids.shape
    if b == 0 or l == 0 or d == 0:
        return torch.zeros((b, d), dtype=table.dtype, device=table.device)
    if v == 0:
        raise ValueError("embedding_bag: the table has no rows")
    mean = combiner == "mean"
    if mean and l > _MAX_MEAN_L:
        raise ValueError(f"embedding_bag: a mean over {l} positions, at "
                         f"most {_MAX_MEAN_L}")
    id_code = _ID_CODE.get(ids.dtype)
    if id_code is None:                    # an explicit conversion, not a route
        ids, id_code = ids.to(torch.int32), 0
    mask_code = _MASK_CODE.get(mask.dtype)
    if mask_code is None:
        mask = mask.to(table.dtype)
        mask_code = _MASK_CODE[table.dtype]
    ids = ids.contiguous()                 # no copy when already contiguous
    mask = mask.contiguous()
    out = table.new_empty((b, d))
    launch = _launch
    if launch is None:
        launch = _launch = LIBRARY.function("embedding_bag_launch")
    status = launch(table.data_ptr(), ids.data_ptr(), mask.data_ptr(),
                    out.data_ptr(), b, l, d, v, dtype_code, id_code, mask_code,
                    mean, runtime.raw_stream(table))
    if status:
        check(LIBRARY, status)
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
