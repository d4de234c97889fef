"""Unified telemetry for the data plane (DESIGN.md §13).

    from repro_torch.obs import Telemetry
    tel = Telemetry(sample_every=8)
    spec = DatasetSpec(..., telemetry=tel)
    ...
    tel.write_run_dir("runs/my-run")
    # python -m repro.obs.report runs/my-run
"""
from repro_torch.obs.events import Event, EventLog
from repro_torch.obs.registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                                MetricsRegistry, publish_dataclass)
from repro_torch.obs.spans import (HOST_STAGES, STAGES, BatchSpan, ItemSpan,
                             SpanTracker, critical_path, current_span)
from repro_torch.obs.telemetry import DEFAULT_SAMPLE_EVERY, Telemetry

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "publish_dataclass",
    "DEFAULT_BUCKETS", "Event", "EventLog", "ItemSpan", "BatchSpan",
    "SpanTracker", "current_span", "critical_path", "STAGES", "HOST_STAGES",
    "Telemetry", "DEFAULT_SAMPLE_EVERY",
]
