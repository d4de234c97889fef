"""The per-run telemetry facade: one object carrying the registry, event
log and span tracker through the whole data plane (DESIGN.md §13).

Construct one ``Telemetry`` per run, hand it to ``DatasetSpec(telemetry=...)``
and/or ``TrainerConfig(telemetry=...)``, and ``open_feed`` threads it through
the store, pool, client, session, prefetcher and feed.  Everything is
optional and additive: with ``telemetry=None`` (the default) every hook in
the data plane degrades to a single attribute-is-None check.

``write_run_dir(path)`` dumps the run's artifacts:

    metrics.json    registry snapshot (series, histogram buckets, p50/95/99)
    metrics.prom    Prometheus text exposition of the same registry
    events.jsonl    control-plane event timeline (one record per line)
    spans.jsonl     completed sampled batch spans (one batch per line)
    timeline.jsonl  thread phase spans, oldest first (one phase per line:
                    name, thread, t0_ns, t1_ns, cpu_ns, id, device_ms)
    summary.json    span lifecycle counts + critical-path attribution

Every span and stage stamps with ``obs.clock.now_ns()``, the epoch base of a
``torch.profiler`` trace, so a run's host spans line up with the device
intervals of a trace of the same process.

``python -m repro_torch.obs.report <run_dir>`` renders them for humans, and
``python -m repro_torch.obs.timeline <run_dir>`` summarizes the timeline.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

from repro_torch.obs.events import EventLog
from repro_torch.obs.registry import DEFAULT_BUCKETS, MetricsRegistry, publish_dataclass
from repro_torch.obs.spans import SpanTracker

DEFAULT_SAMPLE_EVERY = 8


class Telemetry:
    """Registry + event log + span tracker for one run."""

    def __init__(self, *, sample_every: int = DEFAULT_SAMPLE_EVERY,
                 span_capacity: int = 2048, event_capacity: int = 4096) -> None:
        self.registry = MetricsRegistry()
        self.events = EventLog(capacity=event_capacity)
        self.spans = SpanTracker(sample_every=sample_every,
                                 capacity=span_capacity,
                                 registry=self.registry)

    def publish_stats(self, obj: Any, prefix: str,
                      gauge_fields: Sequence[str] = (),
                      **labels: Any) -> None:
        """Publish a legacy ``*Stats`` dataclass snapshot into the registry
        (see :func:`repro_torch.obs.registry.publish_dataclass` for the naming
        rule)."""
        publish_dataclass(self.registry, obj, prefix=prefix,
                          labels=labels, gauge_fields=gauge_fields)

    def critical_path(self, *, starved_host_s: float = 0.0,
                      starved_h2d_s: float = 0.0,
                      starved_time_s: float = 0.0) -> Dict[str, Any]:
        return self.spans.critical_path(starved_host_s=starved_host_s,
                                        starved_h2d_s=starved_h2d_s,
                                        starved_time_s=starved_time_s)

    def summary(self) -> Dict[str, Any]:
        starved = {
            "starved_time_s": _counter_value(
                self.registry, "repro_client_starved_time_s_total"),
            "starved_host_s": _counter_value(
                self.registry, "repro_client_starved_host_s_total"),
            "starved_h2d_s": _counter_value(
                self.registry, "repro_client_starved_h2d_s_total"),
        }
        return {
            "spans": self.spans.lifecycle_counts(),
            "events": self.events.counts(),
            "critical_path": self.spans.critical_path(
                starved_host_s=starved["starved_host_s"],
                starved_h2d_s=starved["starved_h2d_s"],
                starved_time_s=starved["starved_time_s"]),
        }

    def write_run_dir(self, path) -> Path:
        out = Path(path)
        out.mkdir(parents=True, exist_ok=True)
        (out / "metrics.json").write_text(
            json.dumps(self.registry.to_dict(), indent=1, default=str))
        (out / "metrics.prom").write_text(self.registry.prometheus_text())
        self.events.write_jsonl(out / "events.jsonl")
        self.spans.write_jsonl(out / "spans.jsonl")
        self.spans.write_timeline(out / "timeline.jsonl")
        (out / "summary.json").write_text(
            json.dumps(self.summary(), indent=1, default=str))
        return out


def _counter_value(registry: MetricsRegistry, name: str) -> float:
    """Sum of one counter family across all label sets (0.0 if absent)."""
    for fam in registry.families():
        if fam.name == name:
            return sum(child.value for _, child in fam.series())
    return 0.0
