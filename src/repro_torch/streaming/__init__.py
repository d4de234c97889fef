"""Real-time streaming training subsystem (paper §3.2): the "O" in O2O.

Closes the loop from event arrival to gradient on top of the batch data
plane — micro-batching ``StreamingSource``, batch→stream ``BackfillCoordinator``
with an exactly-once request_id watermark, and the ``StreamingSession`` that
wires them into ``DPPWorkerPool``/``RebatchingClient``/``DevicePrefetcher``
with generation-lease release and event→gradient freshness metrics. The
storage-side halves of the protocol live in
``repro_torch.storage.immutable_store`` (generation leases) and
``repro_torch.core.materialize`` (stale-generation remediation).
"""
from repro_torch.streaming.backfill import BackfillCoordinator, BackfillStats, ReplayFilter
from repro_torch.streaming.session import FreshnessStats, StreamingSession
from repro_torch.streaming.source import MicroBatchConfig, SourceStats, StreamingSource

__all__ = [
    "BackfillCoordinator",
    "BackfillStats",
    "ReplayFilter",
    "FreshnessStats",
    "MicroBatchConfig",
    "SourceStats",
    "StreamingSession",
    "StreamingSource",
]
