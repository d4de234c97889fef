"""Low-latency serving tier: snapshot-consistent top-k retrieval over the
live versioned store (DESIGN.md §14).

The inference half of the paper's O2O-consistency story: the same
immutable/mutable tiers, generation leases and late materialization that
training rides also answer live requests — coalesced into micro-batches,
materialized under a transient lease, encoded by the two-tower user tower,
and scored against a refreshable item-tower candidate index.
"""
from repro_torch.serve.cache import EmbedCacheStats, UserEmbeddingCache
from repro_torch.serve.coalescer import (
    CoalesceStats,
    PendingRequest,
    RequestCoalescer,
)
from repro_torch.serve.index import CandidateIndex, IndexStats
from repro_torch.serve.server import (
    RetrievalResult,
    RetrievalServer,
    ServeConfig,
    ServeStats,
)

__all__ = [
    "CandidateIndex",
    "CoalesceStats",
    "EmbedCacheStats",
    "IndexStats",
    "PendingRequest",
    "RequestCoalescer",
    "RetrievalResult",
    "RetrievalServer",
    "ServeConfig",
    "ServeStats",
    "UserEmbeddingCache",
]
