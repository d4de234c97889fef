"""Public wrappers + host helpers for the fused late-materialization path.

Port of ``repro.kernels.fused.ops``. The host ships the compact jagged
layout: one stacked int32 arena per shared ScatterPlan, offsets, and, for a
timestamp trait, window-relative int32 deltas plus per-row int64 bases. On
the card ONE ``fused_densify`` launch (``csrc/fused_densify.cu``) rebuilds
every trait's right-aligned [B, L] lanes and decodes timestamps in-window.

dtype contract: the port keeps host dtypes. ``unpack_dense`` returns each
lane in its host dtype: float32 rides the arena bit-cast and comes back
bit-exact, other integer lanes are exact whenever their values fit int32 (the
arena codec's contract, which all sim data meets), and timestamps come back
as exact int64 from the kernel's int64 lane (the JAX device batch wraps them
to int32 because jax runs with x64 off).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.build import KernelLibrary, check

_I32_MAX = np.int64(2**31 - 1)

LIBRARY = KernelLibrary(
    Path(__file__).parent / "csrc" / "fused_densify.cu",
    {
        "fused_densify_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p], ctypes.c_int),
        "cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
)


# ---------------------------------------------------------------------------
# Host-side packing helpers (numpy; run in the prefetch thread)
# ---------------------------------------------------------------------------

def ts_delta_encode(arena: np.ndarray, offsets: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Window-relative delta encoding of an absolute int64 timestamp arena.

    Returns ``(deltas int32 [N], bases int64 [B])``: each row's first kept
    element becomes delta 0 and its absolute value the row base, so the
    device cumsum only ever carries within-window offsets. Raises if a
    within-window span exceeds int32 — the codec contract (stripes are
    bounded time windows) is broken and wrapping it would corrupt data."""
    arena = np.asarray(arena, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    lens = np.diff(offsets)
    b = len(lens)
    bases = np.zeros(b, np.int64)
    nz = lens > 0
    starts = offsets[:-1][nz]
    bases[nz] = arena[starts]
    if not len(arena):
        return np.zeros(0, np.int32), bases
    d = np.empty(len(arena), np.int64)
    d[0] = 0
    d[1:] = arena[1:] - arena[:-1]
    d[starts] = 0                      # row starts: relative to own base
    rel = arena - np.repeat(bases, lens)
    if (np.abs(d).max(initial=0) > _I32_MAX
            or np.abs(rel).max(initial=0) > _I32_MAX):
        raise ValueError(
            "timestamp window span exceeds int32: the stripe codec's "
            "bounded-window contract is broken (see delta_decode/ops.py)")
    return d.astype(np.int32), bases


def _to_i32_col(col: np.ndarray) -> np.ndarray:
    """One trait column -> its int32 arena representation (see module doc)."""
    if col.dtype == np.float64:
        col = col.astype(np.float32)
    if col.dtype == np.float32:
        return col.view(np.int32)
    return col.astype(np.int32)        # ints/bool: wrap == canonicalization


def pack_arena(values: Dict[str, np.ndarray]
               ) -> Tuple[np.ndarray, List[Tuple[str, np.dtype]]]:
    """Stack same-plan trait arenas into one (N, T) int32 arena + metas
    (trait name, original host dtype) in column order."""
    metas = [(trait, np.asarray(col).dtype) for trait, col in values.items()]
    cols = [_to_i32_col(np.asarray(col)) for col in values.values()]
    n = len(cols[0]) if cols else 0
    arena = np.empty((n, len(cols)), np.int32)
    for i, c in enumerate(cols):
        arena[:, i] = c
    return arena, metas


# ---------------------------------------------------------------------------
# Device-side ops
# ---------------------------------------------------------------------------

def _zeros(b: int, seq_len: int, t: int, ts_col: int, device
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    dense = torch.zeros((b, seq_len, t), dtype=torch.int32, device=device)
    ts = (torch.zeros((b, seq_len), dtype=torch.int64, device=device)
          if ts_col >= 0 else None)
    return dense, ts


def fused_densify_ref(arena: torch.Tensor, offsets: torch.Tensor,
                      seq_len: int, ts_bases: Optional[torch.Tensor] = None,
                      ts_col: int = -1
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of ``fused_densify`` (same contract): a gather of
    each row's L-position window, the right-align mask, and an int64 cumsum
    of the timestamp column's deltas plus the row base."""
    b = offsets.shape[0] - 1
    n, t = arena.shape
    if b == 0 or seq_len == 0 or t == 0 or n == 0:
        return _zeros(b, seq_len, t, ts_col, arena.device)
    offs = offsets.to(torch.int64)
    ends = offs[1:]
    lens = torch.clamp(ends - offs[:-1], max=seq_len)
    j = torch.arange(seq_len, device=arena.device)
    valid = j[None, :] >= (seq_len - lens)[:, None]               # (B, L)
    src = torch.clamp(ends[:, None] - seq_len + j[None, :], 0, n - 1)
    dense = torch.where(valid[..., None], arena[src], 0)          # (B, L, T)
    ts = None
    if ts_col >= 0:
        deltas = dense[..., ts_col].to(torch.int64)
        ts = torch.cumsum(deltas, dim=1) + ts_bases.to(torch.int64)[:, None]
        ts = torch.where(valid, ts, 0)
        dense[..., ts_col] = ts.to(torch.int32)                   # wraps
    return dense, ts


def fused_densify(arena: torch.Tensor, offsets: torch.Tensor, seq_len: int,
                  ts_bases: Optional[torch.Tensor] = None, ts_col: int = -1
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(N, T) int32 arena + (B+1,) int32 offsets -> ``(dense, ts)``.

    ``dense`` is (B, L, T) int32, right-aligned. When ``ts_col >= 0`` that
    column holds deltas, ``ts_bases`` is (B,) int64, and ``ts`` is the exact
    (B, L) int64 decoded timestamp lane (``dense[..., ts_col]`` holds its
    int32 wrap); else ``ts`` is None.

    Launches the CUDA kernel for CUDA tensors (counted in
    ``fused_densify.launches``) and runs ``fused_densify_ref`` for CPU
    tensors. An empty batch, ``seq_len == 0``, ``T == 0`` or an empty arena
    (all rows empty) returns zeros without a launch."""
    inputs = [arena, offsets] + ([ts_bases] if ts_bases is not None else [])
    if not runtime.use_kernel(*inputs):
        return fused_densify_ref(arena, offsets, seq_len, ts_bases, ts_col)
    b = offsets.shape[0] - 1
    n, t = arena.shape
    if arena.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError("fused_densify: arena and offsets must be int32, got "
                        f"{arena.dtype} and {offsets.dtype}")
    if not (arena.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("fused_densify: arena and offsets must be contiguous")
    if not -1 <= ts_col < t:
        raise ValueError(f"fused_densify: ts_col {ts_col} outside [-1, {t})")
    if b == 0 or seq_len == 0 or t == 0 or n == 0:
        return _zeros(b, seq_len, t, ts_col, arena.device)
    if ts_col >= 0 and (ts_bases is None or ts_bases.dtype != torch.int64
                        or ts_bases.shape != (b,)
                        or not ts_bases.is_contiguous()):
        raise TypeError("fused_densify: ts_bases must be a contiguous (B,) "
                        "int64 tensor when ts_col >= 0")
    dense = torch.empty((b, seq_len, t), dtype=torch.int32,
                        device=arena.device)
    ts = (torch.empty((b, seq_len), dtype=torch.int64, device=arena.device)
          if ts_col >= 0 else None)
    stream = torch.cuda.current_stream(arena.device).cuda_stream
    lib = LIBRARY.lib()
    status = lib.fused_densify_launch(
        arena.data_ptr(), offsets.data_ptr(),
        ts_bases.data_ptr() if ts is not None else None,
        dense.data_ptr(), ts.data_ptr() if ts is not None else None,
        b, seq_len, t, ts_col, stream)
    check(LIBRARY, status)
    fused_densify.launches += 1
    return dense, ts


fused_densify.launches = 0


def unpack_dense(dense: torch.Tensor, metas: List[Tuple[str, np.dtype]],
                 ts: Optional[torch.Tensor] = None, ts_col: int = -1
                 ) -> Dict[str, torch.Tensor]:
    """Split a (B, L, T) int32 dense block back into per-trait [B, L] lanes
    in their host dtypes (bit-exact for float32); column ``ts_col`` comes from
    the exact int64 timestamp lane ``ts``."""
    out: Dict[str, torch.Tensor] = {}
    for i, (trait, dt) in enumerate(metas):
        if i == ts_col:
            out[trait] = ts
            continue
        col = dense[:, :, i].contiguous()
        if dt in (np.float32, np.float64):
            col = col.view(torch.float32)
        out[trait] = col.to(_torch_dtype(dt))
    return out


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dt)).dtype
