"""A mesh whose ranks are processes, one a rank, over gloo.

``ThreadedMesh``'s rank threads share one autograd engine, whose device
thread runs every rank's CUDA backward in turn: a collective inside a
backward then waits on ranks queued behind it. ``ProcessMesh`` gives each
rank a process of its own (its own CUDA context and autograd engine), so a
collective in a backward blocks only its own rank. It is the mesh for
programs with a backward: a train cell's rank-local step.

The ranks are started with ``torch.multiprocessing``'s ``spawn`` method and
rendezvous through a file store in a temporary directory. Each binds this
process's current card (all ranks share it), joins a process group and
builds its ``("data", "model")`` ``DeviceMesh``. NCCL refuses two ranks on
one device, and gloo's own CUDA path is not whole: an all-gather of CUDA
tensors over a (2, 2) mesh's groups ended the ranks' processes with
SIGSEGV on the card (torch 2.11), and staging every collective through
host memory over gloo's TCP transport took 4-25 s a train step for the
FULL cells. So the transport is chosen once, here, for every call:
``SharedCardGroup`` moves a CUDA tensor's collective through buffers on
the card that every rank maps (CUDA IPC), with gloo's CPU transport only
for its barriers, and runs a CPU tensor's collective on gloo. A
collective it lacks raises. The ranks share the card's memory and
compute, so a time taken in a rank is a rank process's time, not a
per-chip or link time.

``run(fn, *args)`` hands every rank ``fn(rank, mesh, *args)`` and returns
the ranks' results in rank order. ``fn`` is sent by its import path, so it
must live in an importable module (the children re-import ``__main__`` and
get a ``PYTHONPATH`` that holds this package's source root); ``args`` are
pickled by ``torch.multiprocessing``, so a CUDA tensor reaches the ranks
through an IPC handle (the caller keeps it alive until ``run`` returns,
which it does by holding ``args``) and a CPU tensor through shared memory.
The processes live across ``run`` calls. A rank that raises, exits or does
not answer within ``timeout`` seconds makes ``run`` raise (``TimeoutError``
for the clock); the mesh is then closed and ``__exit__`` kills and joins
every child. No child outlives the ``with`` block.

Nothing here starts a process or touches a process group when the module
is imported.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from multiprocessing.reduction import ForkingPickler
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch._C._distributed_c10d import (
    AllgatherOptions,
    AllreduceOptions,
    AllToAllOptions,
    BarrierOptions,
    BroadcastOptions,
    ReduceScatterOptions,
    _create_work_from_future,
)
from torch.futures import Future

SRC_ROOT = str(Path(__file__).resolve().parents[2])   # holds repro_torch/
POLL_S = 1.0               # how often a wait looks for a child that died


BACKEND = "cardipc"
PIECE_BYTES = 64 << 20     # a CUDA collective moves at most this a rank a round


def _done(outs):
    """A completed work holding ``outs``."""
    fut = Future()
    fut.set_result(list(outs))
    return _create_work_from_future(fut)


def _combine(op, what: str):
    """The elementwise function of reduce op ``op`` (sum, max or min)."""
    for kind, fn in ((dist.ReduceOp.SUM, torch.add),
                     (dist.ReduceOp.MAX, torch.maximum),
                     (dist.ReduceOp.MIN, torch.minimum)):
        if op == kind:
            return fn
    raise ValueError(f"{what} of CUDA tensors with {op}: only sum, max and "
                     f"min are implemented")


class SharedCardGroup(dist.ProcessGroup):
    """A process group for ranks that are processes on one card. A CUDA
    tensor's collective runs through buffers on the card that every rank
    maps (CUDA IPC): in rounds of at most ``PIECE_BYTES`` a rank, each rank
    copies its part into its own buffer, every rank waits for all (its
    stream synchronized, then a barrier over gloo's CPU transport), reads
    the others' buffers and combines them in rank order (so every rank
    gets the same sums), and waits for all again before its buffer is
    reused. A CPU tensor's collective runs on gloo. The collectives are the
    ones ``_functional_collectives`` and ``DeviceMesh`` call, with sum,
    max and min; any other raises."""

    def __init__(self, rank: int, size: int, gloo, store):
        super().__init__(rank, size)
        self._gloo, self._store = gloo, store
        self._me, self._n = rank, size
        self._bufs = None       # every rank's buffer, mapped here

    def getBackendName(self) -> str:
        return BACKEND

    @property
    def group_name(self) -> str:
        """The name c10d registered this group under (a group made by a
        backend's factory is named in c10d's map, not on the object)."""
        return dist.distributed_c10d._world.pg_names[self]

    # -- the card's transport -------------------------------------------
    def _slots(self, device, dtype):
        """Every rank's buffer as ``n`` slots of ``dtype``: [rank][slot].
        Made at this group's first CUDA collective: each rank allocates
        its buffer and posts its IPC handle in the group's store."""
        if self._bufs is None:
            from torch.multiprocessing.reductions import reduce_tensor

            own = torch.empty(self._n * PIECE_BYTES, dtype=torch.uint8,
                              device=device)
            self._store.set(f"card/{self._me}",
                            pickle.dumps(reduce_tensor(own)))
            bufs = []
            for r in range(self._n):
                if r == self._me:
                    bufs.append(own)
                else:
                    fn, args = pickle.loads(self._store.get(f"card/{r}"))
                    bufs.append(fn(*args))
            self._bufs = bufs
            self._fence(device)
        return [[b[s * PIECE_BYTES:(s + 1) * PIECE_BYTES].view(dtype)
                 for s in range(self._n)] for b in self._bufs]

    def _fence(self, device) -> None:
        """This rank's queued work done (on every stream: a tensor may
        come from a stream the caller is not on), then every rank's."""
        torch.cuda.synchronize(device)
        self._gloo.barrier(BarrierOptions()).wait()

    def _rounds(self, t: torch.Tensor, k: int):
        """(slots, [(start, length)]) covering ``k`` elements of ``t``'s
        dtype a round."""
        slots = self._slots(t.device, t.dtype)
        per = PIECE_BYTES // t.element_size()
        return slots, [(j, min(per, k - j)) for j in range(0, k, per)]

    def _card_allreduce(self, t: torch.Tensor, op) -> None:
        combine = _combine(op, "all-reduce")
        flat = t.detach().view(-1)
        slots, rounds = self._rounds(flat, flat.numel())
        for j, n in rounds:
            slots[self._me][0][:n].copy_(flat[j:j + n])
            self._fence(t.device)
            out = flat[j:j + n]
            out.copy_(slots[0][0][:n])
            for r in range(1, self._n):
                combine(out, slots[r][0][:n], out=out)
            self._fence(t.device)

    def _card_gather(self, out: torch.Tensor, t: torch.Tensor) -> None:
        src, dst = t.detach().view(-1), out.detach().view(-1)
        k = src.numel()
        slots, rounds = self._rounds(src, k)
        for j, n in rounds:
            slots[self._me][0][:n].copy_(src[j:j + n])
            self._fence(t.device)
            for r in range(self._n):
                dst[r * k + j:r * k + j + n].copy_(slots[r][0][:n])
            self._fence(t.device)

    def _card_scatter(self, out: torch.Tensor, t: torch.Tensor, op) -> None:
        """Rank r's part of every rank's ``t`` (``n`` equal parts), combined
        with ``op`` (``None``: placed side by side, an all-to-all)."""
        combine = None if op is None else _combine(op, "reduce-scatter")
        src, dst = t.detach().view(-1), out.detach().view(-1)
        k = src.numel() // self._n
        slots, rounds = self._rounds(src, k)
        me = self._me
        for j, n in rounds:
            for r in range(self._n):
                slots[me][r][:n].copy_(src[r * k + j:r * k + j + n])
            self._fence(t.device)
            if combine is None:
                for r in range(self._n):
                    dst[r * k + j:r * k + j + n].copy_(slots[r][me][:n])
            else:
                part = dst[j:j + n]
                part.copy_(slots[0][me][:n])
                for r in range(1, self._n):
                    combine(part, slots[r][me][:n], out=part)
            self._fence(t.device)

    def _card_broadcast(self, t: torch.Tensor, root: int) -> None:
        flat = t.detach().view(-1)
        slots, rounds = self._rounds(flat, flat.numel())
        for j, n in rounds:
            if self._me == root:
                slots[root][0][:n].copy_(flat[j:j + n])
            self._fence(t.device)
            if self._me != root:
                flat[j:j + n].copy_(slots[root][0][:n])
            self._fence(t.device)

    # -- the collectives: CUDA tensors on the card, CPU ones on gloo -------
    @staticmethod
    def _host(t: torch.Tensor) -> torch.Tensor:
        """``t`` itself if gloo can take it, else a contiguous copy."""
        return t if t.is_contiguous() else t.contiguous()

    @staticmethod
    def _back(outs, hosts):
        """Copy each result computed on a copy into its tensor."""
        for t, h in zip(outs, hosts):
            if h is not t:
                t.detach().copy_(h)
        return _done(outs)

    @staticmethod
    def _dense(t: torch.Tensor):
        """(a contiguous tensor to work on, the tensor to copy it back to,
        or ``None``)."""
        return (t, None) if t.is_contiguous() else (t.contiguous(), t)

    @torch.no_grad()
    def allreduce(self, tensors, opts=AllreduceOptions()):
        if tensors[0].is_cuda:
            for t in tensors:
                work, back = self._dense(t)
                self._card_allreduce(work, opts.reduceOp)
                if back is not None:
                    back.copy_(work)
            return _done(tensors)
        hosts = [self._host(t) for t in tensors]
        self._gloo.allreduce(hosts, opts).wait()
        return self._back(tensors, hosts)

    @torch.no_grad()
    def broadcast(self, tensors, opts=BroadcastOptions()):
        if tensors[0].is_cuda:
            for t in tensors:
                work, back = self._dense(t)
                self._card_broadcast(work, opts.rootRank)
                if back is not None:
                    back.copy_(work)
            return _done(tensors)
        hosts = [self._host(t) for t in tensors]
        self._gloo.broadcast(hosts, opts).wait()
        return self._back(tensors, hosts)

    @torch.no_grad()
    def all_gather_single(self, output, input, opts=AllgatherOptions()):
        if input.is_cuda:
            work, back = self._dense(output)
            self._card_gather(work, self._dense(input)[0])
            if back is not None:
                back.copy_(work)
            return _done([output])
        host = self._host(output)
        self._gloo._allgather_base(host, self._host(input), opts).wait()
        return self._back([output], [host])

    def allgather(self, outputs, inputs, opts=AllgatherOptions()):
        """The list form: each input's gathered copies into one output
        list; through ``all_gather_single`` on a tensor of them all."""
        for outs, t in zip(outputs, inputs):
            whole = t.new_empty((len(outs) * t.numel(),))
            self.all_gather_single(whole, t.reshape(-1), opts)
            for r, o in enumerate(outs):
                o.detach().copy_(whole[r * t.numel():(r + 1) * t.numel()]
                                 .view(o.shape))
        return _done([o for outs in outputs for o in outs])

    def all_gather_single_coalesced(self, outputs, inputs,
                                    opts=AllgatherOptions()):
        for out, t in zip(outputs, inputs):
            self.all_gather_single(out, t, opts)
        return _done(outputs)

    @torch.no_grad()
    def reduce_scatter_single(self, output, input,
                              opts=ReduceScatterOptions()):
        if input.is_cuda:
            work, back = self._dense(output)
            self._card_scatter(work, self._dense(input)[0], opts.reduceOp)
            if back is not None:
                back.copy_(work)
            return _done([output])
        host = self._host(output)
        self._gloo._reduce_scatter_base(host, self._host(input), opts).wait()
        return self._back([output], [host])

    def reduce_scatter_single_coalesced(self, outputs, inputs,
                                        opts=ReduceScatterOptions()):
        for out, t in zip(outputs, inputs):
            self.reduce_scatter_single(out, t, opts)
        return _done(outputs)

    @torch.no_grad()
    def all_to_all_single(self, output, input, output_split_sizes,
                          input_split_sizes, opts=AllToAllOptions()):
        if input.is_cuda:
            equal = [input.shape[0] // self._n] * self._n
            if any(list(s) not in ([], equal)
                   for s in (output_split_sizes or [],
                             input_split_sizes or [])):
                raise ValueError("all-to-all of CUDA tensors: only equal "
                                 "splits are implemented")
            work, back = self._dense(output)
            self._card_scatter(work, self._dense(input)[0], None)
            if back is not None:
                back.copy_(work)
            return _done([output])
        host = self._host(output)
        self._gloo.alltoall_base(host, self._host(input),
                                 list(output_split_sizes or []),
                                 list(input_split_sizes or []), opts).wait()
        return self._back([output], [host])

    # the names c10d's Python trampoline looks up differ between torch
    # releases (2.11 asks for the tensor-coalesced ones)
    allgather_into_tensor_coalesced = all_gather_single_coalesced
    reduce_scatter_tensor_coalesced = reduce_scatter_single_coalesced
    _allgather_base = all_gather_single
    _reduce_scatter_base = reduce_scatter_single
    alltoall_base = all_to_all_single

    def barrier(self, opts=BarrierOptions()):
        self._gloo.barrier(opts).wait()
        return _done([])


def _dumps(obj) -> bytes:
    """``obj`` pickled with ``torch.multiprocessing``'s reductions (a CUDA
    tensor as an IPC handle, a CPU one in shared memory), at the call, so
    what cannot be sent raises there and not in a queue's feeder thread."""
    return bytes(ForkingPickler.dumps(obj))


def _create_group(store, rank: int, size: int, timeout):
    """The process-group factory of ``BACKEND``: a ``SharedCardGroup`` over
    a gloo group on ``store`` (this group's prefixed store)."""
    return SharedCardGroup(
        rank, size, dist.ProcessGroupGloo(store, rank, size, timeout), store)


def _serve(rank: int, shape: tuple, device_type: str, device_index,
           timeout: float, store: str, tasks, done) -> None:
    """A rank's process: join the group, build the mesh, then run tasks
    until ``None``; every outcome goes to ``done`` as (rank, ok, value)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = math.prod(shape)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        if device_index is not None:
            torch.cuda.set_device(device_index)
        dist.Backend.register_backend(BACKEND, _create_group,
                                      devices=["cpu", "cuda"])
        dist.init_process_group(
            BACKEND, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        mesh = init_device_mesh(device_type, shape,
                                mesh_dim_names=("data", "model"))
    except BaseException as e:               # noqa: BLE001 (reported)
        done.put((rank, False, "".join(traceback.format_exception(e))))
        return
    done.put((rank, True, _dumps(None)))
    while True:
        task = tasks.get()
        if task is None:
            break
        try:
            fn, args = pickle.loads(task)
            done.put((rank, True, _dumps(fn(rank, mesh, *args))))
        except BaseException as e:           # noqa: BLE001 (reported)
            done.put((rank, False, "".join(traceback.format_exception(e))))
        fn = args = None     # the caller's tensors: release them here
    dist.destroy_process_group()


class ProcessMesh:
    """``with ProcessMesh((2, 2)) as pm: pm.run(fn, *args)``: a ``("data",
    "model")`` mesh of ``prod(shape)`` rank processes on ``device_type``
    (the module docstring)."""

    def __init__(self, shape: Sequence[int], device_type: str = "cuda",
                 timeout: float = 600.0):
        self.shape = tuple(shape)
        self.device_type, self.timeout = device_type, timeout
        self.world = math.prod(self.shape)
        self._procs: List[Any] = []
        self._tasks: List[Any] = []
        self._broken = False

    def __enter__(self) -> "ProcessMesh":
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="procmesh-")
        self._done = ctx.Queue()
        index = (torch.cuda.current_device()
                 if self.device_type == "cuda" else None)
        path = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = os.pathsep.join(
            [SRC_ROOT] + ([path] if path else []))
        try:
            for rank in range(self.world):
                tasks = ctx.Queue()
                p = ctx.Process(
                    target=_serve, name=f"rank{rank}", daemon=True,
                    args=(rank, self.shape, self.device_type, index,
                          self.timeout, os.path.join(self._dir, "store"),
                          tasks, self._done))
                p.start()
                self._tasks.append(tasks)
                self._procs.append(p)
            self._collect("join the group")
        except BaseException:
            self._broken = True
            self.__exit__(None, None, None)
            raise
        finally:
            if path is None:
                os.environ.pop("PYTHONPATH", None)
            else:
                os.environ["PYTHONPATH"] = path
        return self

    def _collect(self, what: str) -> list:
        """Every rank's answer, in rank order; the first failure, a child
        that exited, or the clock closes the mesh and raises."""
        deadline = time.monotonic() + self.timeout
        out: dict = {}
        dead: dict = {}
        while len(out) < self.world:
            left = deadline - time.monotonic()
            if left <= 0:
                self._broken = True
                raise TimeoutError(
                    f"{self.world - len(out)} rank processes did not {what} "
                    f"within {self.timeout} s")
            try:
                rank, ok, value = self._done.get(timeout=min(left, POLL_S))
            except queue.Empty:
                if dead:      # a poll after the one that found them dead
                    self._broken = True
                    raise RuntimeError(f"rank processes exited (rank: exit "
                                       f"code) {dead} before they could "
                                       f"{what}") from None
                dead = {r: p.exitcode for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in out}
                continue
            if not ok:
                self._broken = True
                raise RuntimeError(f"rank {rank} of {self.world} failed to "
                                   f"{what}:\n{value}")
            out[rank] = pickle.loads(value)
        return [out[r] for r in range(self.world)]

    def run(self, fn: Callable[..., Any], *args) -> list:
        """``fn(rank, mesh, *args)`` on every rank; the results in rank
        order. ``fn`` must be importable by module path."""
        if self._broken:
            raise RuntimeError("a rank process failed: the mesh is closed")
        # pickled here, once a rank (each CUDA tensor's IPC handle counts
        # its receiver), so what cannot be sent raises in the caller
        tasks = [_dumps((fn, args)) for _ in self._tasks]
        for q, task in zip(self._tasks, tasks):
            q.put(task)
        return self._collect(f"run {getattr(fn, '__name__', 'a task')}")

    def __exit__(self, *exc) -> None:
        if not self._broken:
            for q in self._tasks:
                q.put(None)
            deadline = time.monotonic() + self.timeout
            for p in self._procs:
                p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join()
        for q in (*self._tasks, self._done):
            q.close()
            q.cancel_join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)
