"""Count what one traced step executes: FLOPs, bytes and collectives.

Replaces ``repro.roofline.hlo`` (collective-byte accounting from post-SPMD
optimized HLO text) and the ``cost_analysis()`` half of
``repro.launch.dryrun``: eager PyTorch has no compiled module to read, so
the step is run once under dispatch modes (on fake tensors in the dry run)
and every aten op it dispatches is counted.

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
    convolutions and attention; elementwise ops count none, as in XLA).
  * Bytes accessed: the sum over dispatched aten ops of their input plus
    output tensor bytes, views excluded. This is the UNFUSED analogue of
    XLA's ``bytes accessed``: every op reads its inputs from and writes its
    output to device memory, where a fused kernel would keep intermediates
    on chip, so it is an upper bound on the traffic of the same math. A
    gather (``index``, ``embedding``, ``index_select``, ``gather``) counts
    the rows it reads, which are its output, and its indices, not the whole
    table; an in-place scatter (``index_put_``, ``index_add_``, ...) counts
    its indices and values read and the rows it writes, not the whole
    destination.
  * Compulsory bytes: the traffic the step's math cannot avoid, whatever
    the program: every input read once and every output written once. An
    input that is only gathered from (a table) is charged the rows its
    gathers return, up to its size, and one that is only scattered into
    the rows written; outputs are the tensors the step returns, each
    written once, except an input the step updates in place and returns
    (a decode step's KV cache, a train step's parameters), which is
    charged what the step wrote into it: the rows of its scatters, or the
    whole tensor where any other op writes it. Unlike the count above it
    does not move when the program fuses, so it is the memory term of a
    cell's floor (``roofline.analysis.compulsory_floor``).
  * Collectives: every ``torch.ops._c10d_functional`` collective, with the
    reference's ring-algorithm cost model per rank (``n`` = group size,
    ``bytes`` = this rank's result):

      all-gather       out_bytes * (n-1)/n
      reduce-scatter   out_bytes * (n-1)          (input = n * output)
      all-reduce       2 * bytes * (n-1)/n
      all-to-all       bytes * (n-1)/n

  * A host read of a device scalar (``.item()``, ``int(t)``) returns 0
    while counting: under fake tensors there is no value to read (AdamW's
    step count is the one such read; it changes the learning rate, not what
    runs).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch
import torch.distributed.distributed_c10d as c10d
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.tree import tree_leaves

_GATHERS = {"index", "embedding", "index_select", "gather"}
_SCATTERS = {"index_put_", "_index_put_impl_", "index_add_", "scatter_",
             "scatter_add_", "index_copy_"}

_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    result_bytes: Dict[str, int]     # sum of per-rank result sizes
    link_bytes: float                # ring-model bytes over the link per rank

    def to_dict(self):
        return dataclasses.asdict(self)


def link_bytes(op: str, nbytes: int, n: int) -> float:
    """The reference's ring-model link bytes of one collective per rank."""
    n = max(n, 2)
    frac = (n - 1) / n
    if op == "all-reduce":
        return 2.0 * nbytes * frac
    if op == "all-gather":
        return nbytes * frac
    if op == "reduce-scatter":
        return float(nbytes * (n - 1))
    if op == "all-to-all":
        return nbytes * frac
    return float(nbytes)                     # collective-permute


def _tensor_bytes(tree: Any) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _storage(t: torch.Tensor) -> StorageWeakRef:
    return StorageWeakRef(t.untyped_storage())


class _Counter(TorchDispatchMode):
    """Counts bytes and collectives of every op dispatched under it, and
    the bytes each of ``inputs`` is read by (per storage, so a view of an
    input is that input)."""

    def __init__(self, inputs: Sequence[torch.Tensor] = ()):
        super().__init__()
        self.bytes = 0
        self.counts: Dict[str, int] = {}
        self.result_bytes: Dict[str, int] = {}
        self.link = 0.0
        self.sizes = {_storage(t): t.untyped_storage().nbytes()
                      for t in inputs}
        self.read: Dict[StorageWeakRef, int] = {}
        self.wrote: Dict[StorageWeakRef, int] = {}

    @staticmethod
    def _scattered(packet: str, args) -> int:
        """The bytes of the values an in-place scatter writes: (self,
        indices, values) or (self, dim, index, source)."""
        vals = (args[2] if packet in ("index_put_", "_index_put_impl_")
                else args[3:4])
        return _tensor_bytes(vals)

    def _mark_writes(self, func, packet: str, args, kwargs) -> None:
        """Add what this op writes into the step's inputs to ``wrote``."""
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            t = args[i] if i < len(args) else kwargs.get(a.name)
            if not isinstance(t, torch.Tensor):
                continue
            ref = _storage(t)
            size = self.sizes.get(ref)
            if size is None:
                continue
            add = self._scattered(packet, args) if packet in _SCATTERS \
                else size
            self.wrote[ref] = min(size, self.wrote.get(ref, 0) + add)

    def _charge(self, packet: str, args, kwargs, out) -> None:
        """Add what this op reads of the step's inputs to ``read``."""
        first = args[0] if args else None
        leaves, _ = tree_flatten((args, kwargs))
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                continue
            ref = _storage(t)
            size = self.sizes.get(ref)
            if size is None:
                continue
            if t is first and packet in _GATHERS:
                add = _tensor_bytes(out)
            elif t is first and packet in _SCATTERS:
                add = self._scattered(packet, args)
            else:
                add = size
            self.read[ref] = min(size, self.read.get(ref, 0) + add)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            return 0
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            op = _COLLECTIVES.get(name)
            if op is not None:
                group = args[-1] if isinstance(args[-1], str) else kwargs.get(
                    "group_name")
                n = c10d._get_group_size_by_name(group)
                nbytes = _tensor_bytes(out)
                self.counts[op] = self.counts.get(op, 0) + 1
                self.result_bytes[op] = self.result_bytes.get(op, 0) + nbytes
                self.link += link_bytes(op, nbytes, n)
        elif ns == "aten" and not func.is_view:
            packet = func.overloadpacket.__name__
            if self.sizes:
                self._charge(packet, args, kwargs, out)
                if func._schema.is_mutable:
                    self._mark_writes(func, packet, args, kwargs)
            if packet in _GATHERS:
                self.bytes += 2 * _tensor_bytes(out) + _tensor_bytes(
                    (args[1:], kwargs))
            elif packet in _SCATTERS:
                self.bytes += 2 * _tensor_bytes((args[1:], kwargs))
            else:
                self.bytes += (_tensor_bytes((args, kwargs))
                               + _tensor_bytes(out))
        return out


@dataclasses.dataclass
class StepCounts:
    flops: float
    bytes: float
    collectives: CollectiveStats
    compulsory_bytes: float = 0.0

    @property
    def cost(self) -> Dict[str, float]:
        """The reference's ``cost_analysis`` keys."""
        return {"flops": self.flops, "bytes accessed": self.bytes}


def count_step(fn, *args) -> StepCounts:
    """Run ``fn(*args)`` once under the counters; returns its counts (the
    caller enters ``FakeTensorMode`` around it to run on fake tensors).
    Arguments and results are walked as parameter trees
    (``repro_torch.tree``: ``nn.ParameterDict`` nodes included)."""
    inputs = tree_leaves(args)
    flops = FlopCounterMode(display=False)
    counter = _Counter([t for t in inputs if isinstance(t, torch.Tensor)])
    with flops, counter:
        out = fn(*args)
    written = 0
    for ref, t in {_storage(t): t for t in tree_leaves(out)
                   if isinstance(t, torch.Tensor)}.items():
        written += (counter.wrote.get(ref, 0) if ref in counter.sizes
                    else _tensor_bytes(t))
    return StepCounts(float(flops.get_total_flops()), float(counter.bytes),
                      CollectiveStats(counter.counts, counter.result_bytes,
                                      counter.link),
                      float(sum(counter.read.values()) + written))
