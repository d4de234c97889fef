"""Production and test meshes as ``torch.distributed`` ``DeviceMesh``es.

Port of ``repro.launch.mesh``. A mesh needs a process group: the
production meshes (16x16 ``("data", "model")`` = 256 ranks a pod, 2x16x16
``("pod", "data", "model")`` = 512 ranks) stand over PyTorch's ``fake``
backend, which accepts every collective and moves nothing, so one process
can trace rank 0's program of a production cell (``launch.dryrun``). A test
mesh stands over the process group the caller initialized (gloo ranks in
the tests), or over a one-rank fake group of this process when there is
none.

Nothing here touches a process group when the module is imported.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils._python_dispatch import _disable_current_modes

POD = ((16, 16), ("data", "model"))
MULTIPOD = ((2, 16, 16), ("pod", "data", "model"))


def _ensure_group(world_size: int) -> None:
    """This process's default group: the fake backend over ``world_size``
    ranks, this process rank 0. A fake group of another size is replaced; a
    real group is kept and must have the size asked for."""
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is initialized; this mesh "
                f"needs {world_size}")
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 ranks a pod; multi-pod = 2 pods = 512 ranks, over the
    fake backend (see the module docstring). This process is rank 0."""
    shape, axes = MULTIPOD if multi_pod else POD
    _ensure_group(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_test_mesh(n_devices: int = 1, device_type: str = "cuda"
                   ) -> DeviceMesh:
    """A ``(1, n)`` ``("data", "model")`` mesh over the first ``n`` ranks
    of this process's group (at most its size). With no group initialized,
    or a fake one, this process becomes a one-rank fake group and the mesh
    is 1x1: a collective over one rank is the identity, and the cells of a
    1x1 mesh run none (``launch.steps``)."""
    if not dist.is_initialized() or dist.get_backend() == "fake":
        _ensure_group(1)
    n = min(n_devices, dist.get_world_size())
    if n == dist.get_world_size():
        return init_device_mesh(device_type, (1, n),
                                mesh_dim_names=("data", "model"))
    return DeviceMesh(device_type, [list(range(n))],
                      mesh_dim_names=("data", "model"))


def data_axes_of(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Axes used for batch/data parallelism (the pod axis is pure DP)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def all_axes_of(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axes_size(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """Ranks along ``axes`` (1 for none)."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)


def axes_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group over ``axes`` of ``mesh`` (several axes are
    flattened in mesh order; ``DeviceMesh`` caches the flattened mesh). The
    mesh's own bookkeeping runs outside any dispatch mode (fake tensors,
    counters) a traced step may be under."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    with _disable_current_modes():
        return mesh[axes]._flatten().get_group()


def subaxis_group(mesh: DeviceMesh, axis: str, inner: int):
    """The process group of the ``inner`` consecutive ranks along ``axis``
    that holds this rank (``axis`` split into ``axis_outer`` x
    ``axis_inner``; the split mesh is made once, by every rank at the same
    call, and kept on ``mesh``)."""
    if inner == axes_size(mesh, (axis,)):
        return axes_group(mesh, (axis,))
    cache = mesh.__dict__.setdefault("_subaxis_groups", {})
    key = (axis, inner)
    if key not in cache:
        names = tuple(mesh.mesh_dim_names)
        i = names.index(axis)
        with _disable_current_modes():
            shape = list(mesh.mesh.shape)
            shape[i:i + 1] = [shape[i] // inner, inner]
            split = DeviceMesh(
                mesh.device_type, mesh.mesh.reshape(shape),
                mesh_dim_names=(*names[:i], f"{axis}_outer",
                                f"{axis}_inner", *names[i + 1:]))
            cache[key] = split.get_group(f"{axis}_inner")
    return cache[key]


def axes_rank(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """This rank's row-major coordinate over ``axes``."""
    r = 0
    for a in axes:
        r = r * axes_size(mesh, (a,)) + mesh.get_local_rank(a)
    return r


def store_node_of_host(host: int, n_hosts: int, n_store_nodes: int) -> int:
    """Which store node a trainer host's DPP workers treat as *local*.

    The disaggregated immutable tier (``storage.sharded_store``) is deployed
    alongside the trainer mesh; hosts map onto store nodes round-robin so
    each node serves ``ceil(n_hosts / n_store_nodes)`` hosts and a host's
    affinity-planned work items (already node-local via the placement map)
    can be routed to the co-located node's feed partition."""
    if not 0 <= host < n_hosts:
        raise ValueError(f"host {host} out of range [0, {n_hosts})")
    return host % n_store_nodes


def replica_nodes_of_host(host: int, n_hosts: int, n_store_nodes: int,
                          replication_factor: int = 1) -> Tuple[int, ...]:
    """Ordered store-node preference chain for a trainer host.

    Head = the co-located node (``store_node_of_host``); tail = that node's
    round-robin replica successors — the SAME anti-affinity chain
    ``PlacementMap.replicas_of`` uses, so when the host's local node is down
    its DPP reads fail over to nodes that actually replicate the local
    node's primary data, instead of scattering across the tier."""
    primary = store_node_of_host(host, n_hosts, n_store_nodes)
    r = max(1, min(replication_factor, n_store_nodes))
    return tuple((primary + k) % n_store_nodes for k in range(r))
