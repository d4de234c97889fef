"""The storage-tier contract every consumer speaks (§4.2.3, DESIGN.md §11).

``core.materialize``, ``core.snapshot``, ``data.planner``, ``data.compile``
and ``dpp.affinity`` are all written against this surface, never against a
concrete store class — the in-process monolith (``ImmutableUIHStore``) and
the disaggregated multi-node client (``ShardedUIHStore``) are drop-in
interchangeable. The contract is behavioral, not just structural:

  * ``plan``/``execute_plan``/``multi_range_scan`` — batched reads are
    planned (dedupe + union-projection subsumption) and executed with the
    implementation's parallelism (shard threads / node fanout); results come
    back in original request order and the call's ``IOStats`` delta lands in
    the caller's ``out_stats``.
  * ``acquire_lease`` — pins ONE consistent generation for the holder: on the
    sharded store this is an epoch barrier (every node pins the same
    generation; a bulk load can never interleave with lease acquisition).
  * ``bulk_load`` — installs a generation atomically with respect to leases:
    a leased generation id is never reused, a superseded-but-leased
    generation is retained until its last release.
  * ``StaleGeneration`` remediation contract: scanning a generation that is
    neither live nor retained raises ``GenerationUnavailable`` (a
    ``KeyError``) so the Materializer's layered remediation works unchanged.

**Failure model** (DESIGN.md §12): the contract distinguishes exactly two
error classes on the read path, and every consumer is written against the
distinction rather than against any concrete store:

  * ``NodeUnavailable`` (an ``IOError``) — *the bytes still exist, the path
    to them is down*. Retryable: the caller's work item fails cleanly with no
    partial result, and an identical retry succeeds once a replica answers or
    the node returns. The DPP pool's self-healing (requeue + respawn)
    is the designated handler.
  * ``GenerationUnavailable`` (a ``KeyError``) — *the data is gone* (the
    generation was GC'd everywhere). NOT retryable: the Materializer's
    StaleGeneration remediation must re-resolve against a live generation.

**Degraded-mode contract** (replicated tier, r-way): a store with replicas
serves reads from any live replica — failover is invisible to the caller
(same bytes, same ``StaleGeneration`` semantics, leases keep pinning on the
survivors). Only when EVERY replica of a user's chain is unreachable does the
read raise ``NodeUnavailable`` — still the retryable class, so training
degrades to the pool's self-healing path (requeue, bounded retries, surfaced
abandonment) and is byte-identical to a fault-free run once a replica
returns within the retry budget. Degradation is never silent: the store
counts ``degraded_scans`` and the pool surfaces abandonment.
"""
from __future__ import annotations

from typing import (
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    runtime_checkable,
)

from repro_torch.core import events as ev
from repro_torch.storage.immutable_store import IOStats, ScanPlan, ScanRequest
from repro_torch.storage.sharding import PlacementMap


class NodeUnavailable(IOError):
    """A store node (or, with replication, every replica in a user's chain)
    is unreachable. Transient and retryable: the caller's work item fails
    cleanly (no partial result is returned) and a retry after a replica or
    the node returns succeeds — unlike ``GenerationUnavailable``, which means
    the *data* is gone and remediation must re-resolve."""


@runtime_checkable
class LeaseProtocol(Protocol):
    """A refcounted pin on one immutable generation (context-manager
    friendly; ``release`` is idempotent)."""

    generation: int

    def release(self) -> None: ...

    def __enter__(self) -> "LeaseProtocol": ...

    def __exit__(self, *exc) -> None: ...


@runtime_checkable
class StoreProtocol(Protocol):
    """The immutable-tier surface (monolith and sharded client both satisfy
    it). Attributes are part of the contract: consumers read ``schema`` for
    trait resolution, ``generation`` for staleness decisions, ``n_shards``
    for symmetric data placement, and ``stats`` for I/O accounting."""

    schema: ev.TraitSchema
    n_shards: int
    generation: int
    stats: IOStats

    # -- write path ----------------------------------------------------------
    def bulk_load(self, tables, generation: int) -> None: ...

    # -- read path -----------------------------------------------------------
    def scan(self, req: ScanRequest) -> ev.EventBatch: ...

    def plan(self, reqs: Sequence[ScanRequest]) -> ScanPlan: ...

    def execute_plan(
        self, plan: ScanPlan, out_stats: Optional[IOStats] = None
    ) -> List[ev.EventBatch]: ...

    def multi_range_scan(
        self,
        reqs: Sequence[ScanRequest],
        out_stats: Optional[IOStats] = None,
    ) -> List[ev.EventBatch]: ...

    def estimate_scan(self, req: ScanRequest) -> Tuple[int, int]: ...

    # -- generations + leases ------------------------------------------------
    def acquire_lease(
        self, generation: Optional[int] = None
    ) -> LeaseProtocol: ...

    def has_generation(self, generation: int) -> bool: ...

    def leased_generations(self) -> Dict[int, int]: ...

    def retained_generations(self) -> List[int]: ...

    # -- placement + introspection -------------------------------------------
    def live_placement(self) -> Optional[PlacementMap]: ...

    def watermark(self, user_id: int, group: str = "core",
                  generation: int = -1) -> int: ...

    def stored_events(self, user_id: int, group: str) -> int: ...

    def stored_bytes(self) -> int: ...

    def close(self) -> None: ...
