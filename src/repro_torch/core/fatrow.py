"""Fat Row problem formalization (paper §2).

Analytic cost model used by ``benchmarks/fig2_cost_wall.py`` to reproduce the
storage/IO-wall estimation (Figure 2) and the "Fat Row Wall" definition of §5.2
(wall = sequence length where data-service : GPU-power ratio exceeds 0.75).

The measured counterpart (actual bytes through our stores) lives in
``benchmarks/table1_system_efficiency.py``; this module is the closed-form
K-fold amplification model.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WorkloadModel:
    """Per-user-day workload constants (order-of-magnitude production-like).

    The GPU term models a production DLRM: compute is dominated by the dense
    interaction stack (``gpu_flops_fixed`` per example) with only a weak
    per-event term (embedding pooling / lightweight sequence encoders), while
    the DATA payload is strictly linear in sequence length — this asymmetry is
    exactly why a storage/IO wall appears as sequences scale (paper §2.2)."""

    requests_per_user_day: float = 24.0        # K: ranking requests / user / day
    bytes_per_event: float = 24.0              # encoded UIH bytes per event
    nonseq_bytes_per_example: float = 8_192.0  # labels + scalar/dense features
    replay_factor: float = 3.0                 # each example trained this often
    gpu_flops_fixed: float = 5.0e9             # dense stack, per example
    gpu_flops_per_token: float = 2.0e4         # per UIH event (pool/encode)
    gpu_cost_per_flop: float = 5.6e-14         # relative cost units
    storage_cost_per_byte_day: float = 2.0e-9
    io_cost_per_byte: float = 1.0e-9
    lookup_cache_hit: float = 0.8              # immutable-store block cache


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    storage: float
    write_io: float
    read_io: float
    gpu: float

    @property
    def data_services(self) -> float:
        return self.storage + self.write_io + self.read_io

    @property
    def ratio(self) -> float:
        return self.data_services / max(self.gpu, 1e-30)


def _gpu_cost(seq_len: int, m: WorkloadModel) -> float:
    flops = m.gpu_flops_fixed + seq_len * m.gpu_flops_per_token
    return m.requests_per_user_day * m.replay_factor * flops * m.gpu_cost_per_flop


def fat_row_cost(seq_len: int, m: WorkloadModel = WorkloadModel()) -> CostBreakdown:
    """Fat Row: every one of the K daily requests materializes the full
    sequence -> K-fold duplication of the (seq_len * bytes_per_event) payload."""
    k = m.requests_per_user_day
    seq_bytes = seq_len * m.bytes_per_event
    example_bytes = seq_bytes + m.nonseq_bytes_per_example
    written = k * example_bytes                       # per user-day
    stored = written                                  # retained 1 day-equivalent
    read = written * m.replay_factor
    return CostBreakdown(
        storage=stored * m.storage_cost_per_byte_day,
        write_io=written * m.io_cost_per_byte,
        read_io=read * m.io_cost_per_byte,
        gpu=_gpu_cost(seq_len, m),
    )


def vlm_cost(
    seq_len: int,
    m: WorkloadModel = WorkloadModel(),
    mutable_fraction: float = 0.02,
    version_metadata_bytes: float = 40.0,
    lookup_efficiency: float = 3.4,   # single-level store read throughput per
                                      # host resource vs the primary store (§5.1)
) -> CostBreakdown:
    """Versioned late materialization: sequences stored once (normalized tier),
    examples carry only the mutable slice + O(1) version metadata; training
    re-reads the canonical copy through the read-optimized immutable store."""
    k = m.requests_per_user_day
    seq_bytes = seq_len * m.bytes_per_event
    mutable_bytes = mutable_fraction * seq_bytes
    example_bytes = mutable_bytes + version_metadata_bytes + m.nonseq_bytes_per_example
    written = k * example_bytes + seq_bytes           # canonical copy written once
    stored = written
    primary_read = k * example_bytes * m.replay_factor
    # sequence lookups hit the immutable tier: block cache absorbs most of the
    # (streaming-dominated) traffic, the single-level layout serves misses
    # `lookup_efficiency`x cheaper per byte in host resources
    lookup_read = (k * seq_bytes * m.replay_factor
                   * (1.0 - m.lookup_cache_hit) / lookup_efficiency)
    return CostBreakdown(
        storage=stored * m.storage_cost_per_byte_day,
        write_io=written * m.io_cost_per_byte,
        read_io=(primary_read + lookup_read) * m.io_cost_per_byte,
        gpu=_gpu_cost(seq_len, m),
    )


def fat_row_wall(
    threshold: float = 0.75,
    m: WorkloadModel = WorkloadModel(),
    max_len: int = 1 << 20,
) -> int:
    """Smallest sequence length where Fat Row data-services/GPU ratio > threshold."""
    lo, hi = 1, max_len
    if fat_row_cost(hi, m).ratio <= threshold:
        return hi
    while lo < hi:
        mid = (lo + hi) // 2
        if fat_row_cost(mid, m).ratio > threshold:
            hi = mid
        else:
            lo = mid + 1
    return lo
