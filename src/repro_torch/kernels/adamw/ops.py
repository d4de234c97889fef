"""One AdamW step over lists of leaves: a multi-tensor CUDA kernel on the
card, the per-leaf PyTorch passes on the CPU.

Not a port of a Pallas kernel: the reference's AdamW is jnp code that XLA
fuses into one loop a leaf (``repro.train.optimizer.adamw_update``).
``adamw`` launches ``csrc/adamw.cu`` for CUDA leaves, two launches a call
whatever the number of leaves (one when the caller gives the norm), and runs
``adamw_ref`` for CPU leaves. Both take the gradients as handed, a scale for
them (``grad_scale``, 1/n for a sum over n microbatches), the clip by their
global norm, and update the parameters, m and v in place.

The kernel reads its leaves from a table of rows (``LEAF``: the four
pointers, the length, the first chunk, the decay, the alignment) built on
the host, staged in page-locked memory and copied to the card without a host
sync. The caller keeps one ``LeafTable`` for each optimizer state and hands
it to every step; it is copied again only when a pointer, a length or a
decay changed: the gradients' pointers may change from step to step.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.build import KernelLibrary, check

LIBRARY = KernelLibrary(
    Path(__file__).parent / "csrc" / "adamw.cu",
    {
        "adamw_launch": (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p] + [ctypes.c_float] * 10
            + [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
        "cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
)
CHUNK = 65536          # elements a chunk (a multiple of the kernel's 1024)
NORM_BLOCKS = 1024     # the grid of both passes: one norm partial a block
LEAF = np.dtype([("p", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"),
                 ("n", "<i8"), ("chunk0", "<i8"), ("decay", "<f4"),
                 ("aligned", "<i4")])          # the kernel's struct Leaf
_launch = None         # adamw_launch, bound at the first launch


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 norm of every leaf together."""
    total = None
    for x in leaves:
        sq = torch.linalg.vector_norm(x, dtype=torch.float32).square()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_ref(params, grads, ms, vs, decay, *, lr, beta1, beta2, bc1, bc2,
              eps, clip, grad_scale=1.0, gnorm=None) -> torch.Tensor:
    """Plain PyTorch version of ``adamw`` (same contract), a few passes a
    leaf with leaf-sized temporaries, as the reference's arithmetic reads;
    the gradients are scaled and clipped in place."""
    for g in grads:
        g.mul_(grad_scale)
    gnorm = global_norm(grads) if gnorm is None else gnorm * grad_scale
    if clip > 0:
        scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))
    for p, g, m, v, wd in zip(params, grads, ms, vs, decay):
        m.mul_(beta1).add_(g, alpha=1 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
        u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        if wd:
            u.add_(p.float(), alpha=wd)
        p.sub_(u.mul_(lr).to(p.dtype))
    return gnorm


def leaf_rows(ptrs: Sequence[Sequence[int]], sizes: Sequence[int],
              decays: Sequence[float]) -> np.ndarray:
    """The kernel's leaf table: one ``LEAF`` row a leaf, from the p, g, m
    and v pointers (``ptrs[0..3]``, one list each), the lengths and the
    decays; each leaf's first chunk counts the chunks of those before it,
    and bit i of ``aligned`` says that array i starts 16-byte aligned."""
    rows = np.zeros(len(sizes), LEAF)
    for name, col in zip("pgmv", ptrs):
        rows[name] = col
    counts = -(-np.asarray(sizes, np.int64) // CHUNK)
    rows["n"] = sizes
    rows["chunk0"] = np.cumsum(counts) - counts
    rows["decay"] = decays
    bits = np.array([[1], [2], [4], [8]], np.uint64)
    rows["aligned"] = ((np.array(ptrs, np.uint64).reshape(4, -1) % 16 == 0)
                       * bits).sum(axis=0)
    return rows


class LeafTable:
    """One optimizer state's leaf table: page-locked rows, their copy on the
    card and the norm pass's partial sums, allocated at the first launch and
    again when the number of leaves changes."""

    def __init__(self):
        self.host = self.rows = self.dev = self.partials = None
        self.copied: Optional[torch.cuda.Event] = None
        self.key = None          # the rows as last copied
        self.chunks = 0

    def load(self, cols, sizes, decays, device: torch.device) -> None:
        """Make the card's copy hold these leaves' rows; a host-side
        comparison, and a copy without a host sync only when they changed."""
        key = (device, *map(tuple, cols), tuple(sizes), tuple(decays))
        if key == self.key:
            return
        if self.rows is None or len(self.rows) != len(sizes) \
                or self.dev.device != device:
            self.host = torch.empty(len(sizes) * LEAF.itemsize,
                                    dtype=torch.uint8, pin_memory=True)
            self.rows = self.host.numpy().view(LEAF)
            self.dev = torch.empty_like(self.host, device=device)
            self.partials = torch.empty(NORM_BLOCKS, dtype=torch.float64,
                                        device=device)
            self.copied = None
        if self.copied is not None:
            self.copied.synchronize()   # the last copy has left the rows
        self.rows[:] = leaf_rows(cols, sizes, decays)
        self.dev.copy_(self.host, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()
        self.key = key
        self.chunks = sum(-(-n // CHUNK) for n in sizes)
        adamw.uploads += 1


def _check(params, grads, ms, vs, decay, gnorm) -> None:
    n = len(params)
    if n == 0:
        raise ValueError("adamw: no leaves")
    if not (len(grads) == len(ms) == len(vs) == len(decay) == n):
        raise ValueError(f"adamw: {n} params, {len(grads)} grads, {len(ms)} "
                         f"m, {len(vs)} v and {len(decay)} decays")
    for i, (p, g, m, v) in enumerate(zip(params, grads, ms, vs)):
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"adamw: leaf {i} has shapes {tuple(p.shape)}, "
                             f"{tuple(g.shape)}, {tuple(m.shape)}, "
                             f"{tuple(v.shape)} (p, g, m, v)")
        if not g.dtype == m.dtype == v.dtype == torch.float32:
            raise TypeError(f"adamw: leaf {i} has g, m, v of {g.dtype}, "
                            f"{m.dtype}, {v.dtype}; want float32")
    if gnorm is not None and gnorm.numel() != 1:
        raise ValueError(f"adamw: gnorm has {gnorm.numel()} elements")


def adamw(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
          ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
          decay: Sequence[float], *, lr: float, beta1: float, beta2: float,
          bc1: float, bc2: float, eps: float, clip: float,
          grad_scale: float = 1.0, gnorm: Optional[torch.Tensor] = None,
          table: Optional[LeafTable] = None) -> torch.Tensor:
    """One AdamW step; returns the norm of the scaled gradients (a float32
    0-dim tensor on the leaves' device).

    Leaf i's gradient ``grads[i]`` is taken times ``grad_scale``, then the
    whole is clipped to global norm ``clip`` (no clip when ``clip <= 0``);
    ``ms``/``vs`` are its moments, ``decay[i]`` its weight decay (0 outside
    the decay mask), ``bc1``/``bc2`` the step's bias corrections. ``gnorm``
    is the norm of the gradients as handed, where the caller took it over
    shards that other ranks hold (default: taken here). The parameters, m
    and v are updated in place; the kernel never writes the gradients.
    ``table`` is the leaf table the caller keeps for this optimizer state
    (default: one for this call alone, copied to the card each call).

    For CUDA leaves: float32 p, g, m and v on one card, two launches (one
    with ``gnorm``) counted in ``adamw.launches``, the leaves and elements
    updated in ``adamw.leaves`` and ``adamw.elements``. A non-contiguous leaf
    is updated through a contiguous copy written back after the launch
    (counted in ``adamw.staged``). Runs ``adamw_ref`` for CPU leaves."""
    global _launch
    _check(params, grads, ms, vs, decay, gnorm)
    extra = () if gnorm is None else (gnorm,)
    if not runtime.use_kernel(*params, *grads, *ms, *vs, *extra):
        return adamw_ref(params, grads, ms, vs, decay, lr=lr, beta1=beta1,
                         beta2=beta2, bc1=bc1, bc2=bc2, eps=eps, clip=clip,
                         grad_scale=grad_scale, gnorm=gnorm)
    dev = params[0].device
    for t in (*params, *grads, *ms, *vs, *extra):
        if t.device != dev:
            raise ValueError(f"adamw: leaves on {t.device} and {dev}")
    for i, p in enumerate(params):
        if p.dtype != torch.float32:
            raise TypeError(f"adamw: leaf {i} has parameters of {p.dtype}; "
                            f"the kernel takes float32")
        for name, t in zip("pgmv", (p, grads[i], ms[i], vs[i])):
            if t.numel() and not t.data_ptr():
                raise ValueError(f"adamw: leaf {i}'s {name} holds no storage "
                                 f"of its own (a collective's result not "
                                 f"waited for?)")
    if gnorm is not None:
        gnorm = gnorm.to(torch.float32).reshape(())
        if not gnorm.data_ptr():
            raise ValueError("adamw: gnorm holds no storage of its own")

    staged = []       # (leaf array, its contiguous copy): written back
    n_staged = 0

    def flat(t: torch.Tensor, write: bool) -> torch.Tensor:
        if t.is_contiguous():
            return t
        c = t.contiguous()
        if write:
            staged.append((t, c))
        return c

    cols = [[], [], [], []]
    live = []         # the arrays the launch reads, alive until it is issued
    sizes, decays = [], []
    for p, g, m, v, wd in zip(params, grads, ms, vs, decay):
        if p.numel() == 0:
            continue
        arrays = (flat(p, True), flat(g, False), flat(m, True),
                  flat(v, True))
        n_staged += any(a is not b for a, b in zip(arrays, (p, g, m, v)))
        live.append(arrays)
        for col, a in zip(cols, arrays):
            col.append(a.data_ptr())
        sizes.append(p.numel())
        decays.append(float(wd))
    rows = len(sizes)
    tab = LeafTable() if table is None else table
    tab.load(cols, sizes, decays, dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    launch = _launch
    if launch is None:
        launch = _launch = LIBRARY.function("adamw_launch")
    status = launch(tab.dev.data_ptr(), rows, tab.chunks, CHUNK,
                    tab.partials.data_ptr(), NORM_BLOCKS,
                    None if gnorm is None else gnorm.data_ptr(),
                    grad_scale, clip, lr, beta1, 1 - beta1, beta2, 1 - beta2,
                    bc1, bc2, eps, out.data_ptr(), runtime.raw_stream(out))
    if status:
        check(LIBRARY, status)
    for t, c in staged:
        t.copy_(c)
    adamw.launches += 1 if gnorm is not None else 2
    adamw.leaves += rows
    adamw.elements += sum(sizes)
    adamw.staged += n_staged
    return out


adamw.launches = 0     # kernel launches (two a call, one with a given norm)
adamw.leaves = 0       # leaves updated by the kernel
adamw.elements = 0     # elements updated by the kernel
adamw.staged = 0       # leaves updated through a contiguous copy
adamw.uploads = 0      # leaf tables copied to the card
