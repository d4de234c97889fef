"""A mesh whose ranks are threads of this process, over PyTorch's threaded
process group.

NCCL refuses two ranks on one device, so a card runs a multi-rank program
as ranks that share it: ``ThreadedMesh`` starts one thread a rank, each
joins PyTorch's ``threaded`` process group
(``torch.testing._internal.distributed.multi_threaded_pg``, whose
collectives meet in this process) and builds its ``DeviceMesh``; ``run``
hands every rank the same function, ``fn(rank, mesh)``, and returns the
ranks' results in rank order. Each rank runs its rank-local program as it
would in a process of its own; the threads' device work shares the card's
stream, so a time taken over them is not a per-chip time.

Forward-only programs: autograd runs a CUDA backward on one device thread
that every rank thread shares, so a backward with a collective in it would
wait on ranks queued behind it. A program with a backward (a train cell's
step) runs on ``launch.procmesh.ProcessMesh``, whose ranks are processes.

Nothing here touches a process group when the module is imported.
"""
from __future__ import annotations

import math
import queue
import threading
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist


class ThreadedMesh:
    """``with ThreadedMesh((2, 16)) as tm: tm.run(fn)``: a ``("data",
    "model")`` mesh of ``prod(shape)`` rank threads on ``device_type``. A
    rank that raises stops every rank's collectives and ``run`` raises; a
    rank that does not finish within ``timeout`` seconds makes ``run``
    raise ``TimeoutError``."""

    def __init__(self, shape: Sequence[int], device_type: str = "cuda",
                 timeout: float = 600.0):
        self.shape = tuple(shape)
        self.device_type, self.timeout = device_type, timeout
        self.world = math.prod(self.shape)
        self._tasks: List[queue.Queue] = []
        self._done: queue.Queue = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._broken = False

    def __enter__(self) -> "ThreadedMesh":
        from torch.testing._internal.distributed import multi_threaded_pg

        self._pg = multi_threaded_pg
        torch._C._distributed_c10d._set_thread_isolation_mode(True)
        self._pg._install_threaded_pg()
        store = dist.HashStore()
        device = (torch.cuda.current_device()
                  if self.device_type == "cuda" else None)
        for rank in range(self.world):
            q: queue.Queue = queue.Queue()
            t = threading.Thread(target=self._serve,
                                 args=(rank, q, store, device), daemon=True,
                                 name=f"rank{rank}")
            self._tasks.append(q)
            self._threads.append(t)
            t.start()
        try:
            self._collect("join the group")
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def _serve(self, rank: int, tasks: queue.Queue, store, device) -> None:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = None
        try:
            if device is not None:
                torch.cuda.set_device(device)
            dist.init_process_group("threaded", rank=rank,
                                    world_size=self.world, store=store)
            mesh = init_device_mesh(self.device_type, self.shape,
                                    mesh_dim_names=("data", "model"))
            self._done.put((rank, True, None))
        except BaseException as e:           # noqa: BLE001 (reported)
            self._fail(rank, e)
        while True:
            fn = tasks.get()
            if fn is None:
                break
            try:
                self._done.put((rank, True, fn(rank, mesh)))
            except BaseException as e:       # noqa: BLE001 (reported)
                self._fail(rank, e)
            del fn          # its closure may hold the caller's tensors

    def _fail(self, rank: int, e: BaseException) -> None:
        """Report first, then wake the ranks waiting in a collective (so the
        first report is the cause, not a woken rank's)."""
        self._done.put((rank, False, "".join(traceback.format_exception(e))))
        self._pg.ProcessLocalGroup.exception_handle(e)

    def _collect(self, what: str) -> list:
        out: dict = {}
        errors = []
        for _ in range(self.world):
            try:
                rank, ok, value = self._done.get(timeout=self.timeout)
            except queue.Empty:
                self._broken = True
                raise TimeoutError(f"{self.world - len(out) - len(errors)} "
                                   f"rank threads did not {what} within "
                                   f"{self.timeout} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append((rank, value))
        if errors:
            self._broken = True
            rank, tb = errors[0]
            raise RuntimeError(f"{len(errors)} of {self.world} rank threads "
                               f"failed to {what}; rank {rank}:\n{tb}")
        return [out[r] for r in range(self.world)]

    def run(self, fn: Callable[[int, Any], Any]) -> list:
        """``fn(rank, mesh)`` on every rank; the results in rank order."""
        if self._broken:
            raise RuntimeError("a rank thread failed: the mesh is closed")
        for q in self._tasks:
            q.put(fn)
        return self._collect(f"run {getattr(fn, '__name__', 'a task')}")

    def __exit__(self, *exc) -> None:
        for q in self._tasks:
            q.put(None)
        for t in self._threads:
            t.join(timeout=0 if self._broken else self.timeout)
        self._pg.ProcessLocalGroup.reset()
        self._pg._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
