"""Declarative read path (paper §2.3, §4.2): ``DatasetSpec`` → ``Feed``.

Port of ``repro.data``: ``spec`` and ``planner`` are copies of the reference
modules; ``compile.open_feed`` builds the port's device-prefetch stage and
``DeviceMaterializer`` (CUDA ``fused_densify``) for batch sources, and the
``StreamingSession`` (host densify) for ``StreamSource``.
"""
from repro_torch.core.materialize import TenantShareStats
from repro_torch.data.compile import compile_worker_plan, open_feed
from repro_torch.data.feed import Feed, FeedStats
from repro_torch.data.planner import MultiTenantPlanner
from repro_torch.data.spec import (
    DatasetSpec,
    SimSource,
    StreamSource,
    WarehouseSource,
    resume_fingerprint,
)

__all__ = [
    "DatasetSpec",
    "Feed",
    "FeedStats",
    "MultiTenantPlanner",
    "SimSource",
    "StreamSource",
    "TenantShareStats",
    "WarehouseSource",
    "compile_worker_plan",
    "open_feed",
    "resume_fingerprint",
]
