"""O2O consistency + future-leakage auditing (paper §2.1, §3.3).

These checks back the paper's correctness argument:
  * no event with timestamp > T_request may appear in a training-time UIH
    (future-leakage prevention by temporal predicate);
  * the reconstructed UIH must equal the inference-time UIH exactly
    (checksum-validated in production; exact column compare here).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core import events as ev
from repro_torch.core.materialize import Materializer
from repro_torch.core.projection import TenantProjection
from repro_torch.core.versioning import TrainingExample


def future_leakage_count(uih: ev.EventBatch, request_ts: int) -> int:
    if not uih or "timestamp" not in uih or ev.batch_len(uih) == 0:
        return 0
    return int(np.count_nonzero(uih["timestamp"] > request_ts))


def batches_equal(a: ev.EventBatch, b: ev.EventBatch) -> bool:
    if set(a.keys()) != set(b.keys()):
        return False
    return all(np.array_equal(a[k], b[k]) for k in a)


def project_reference(
    reference: ev.EventBatch,
    projection: Optional[TenantProjection],
    schema: ev.TraitSchema,
) -> ev.EventBatch:
    """Apply a tenant projection to a ground-truth UIH (for comparisons)."""
    if projection is None:
        return reference
    traits = [t for t in projection.all_traits(schema) if t in reference]
    out = ev.project_traits(reference, traits)
    n = ev.batch_len(out)
    if n > projection.seq_len:
        out = ev.slice_batch(out, n - projection.seq_len, n)
    return out


@dataclasses.dataclass
class AuditReport:
    examples: int = 0
    o2o_mismatches: int = 0
    leaked_examples: int = 0
    leaked_events: int = 0

    @property
    def clean(self) -> bool:
        return self.o2o_mismatches == 0 and self.leaked_events == 0


def audit(
    examples: Sequence[TrainingExample],
    references: Sequence[ev.EventBatch],
    materializer: Materializer,
    schema: ev.TraitSchema,
    projection: Optional[TenantProjection] = None,
    batched: bool = False,
) -> AuditReport:
    """Compare training-time materialization against inference-time ground truth.

    ``references[i]`` must be the complete UIH the ranking model saw for
    ``examples[i]`` at T_request (captured via ``BaseSnapshotter.inference_uih``).
    With ``batched=True`` the planned ``materialize_batch`` path is audited
    instead of per-example ``materialize`` — both must stay O2O-clean."""
    report = AuditReport()
    if batched:
        outputs = materializer.materialize_batch(examples, projection)
    else:
        outputs = (materializer.materialize(e, projection) for e in examples)
    for (exm, ref), got in zip(zip(examples, references), outputs):
        _check_one(report, exm, ref, got, projection, schema)
    return report


def _check_one(report, exm, ref, got, projection, schema) -> None:
    want = project_reference(ref, projection, schema)
    report.examples += 1
    if not batches_equal(got, want):
        report.o2o_mismatches += 1
    leaks = future_leakage_count(got, exm.request_ts)
    if leaks:
        report.leaked_examples += 1
        report.leaked_events += leaks


def audit_streaming(
    micro_batches: Iterable[Sequence[TrainingExample]],
    references_by_id: Dict[int, ev.EventBatch],
    materializer: Materializer,
    schema: ev.TraitSchema,
    projection: Optional[TenantProjection] = None,
    ack: Optional[Callable[[Sequence[TrainingExample]], None]] = None,
) -> AuditReport:
    """Streaming-mode audit (§3.2): materialize micro-batches AS THEY ARRIVE —
    compaction may publish new generations between (or during) micro-batches,
    which is exactly the condition the bifurcated protocol must survive.

    ``micro_batches`` is typically ``StreamingSource.micro_batches()`` running
    against a live stream; ``references_by_id`` maps ``request_id`` to the
    inference-time ground truth (stream consumption interleaves users, so
    positional pairing is not available); ``ack`` (e.g. ``StreamingSource.ack``)
    releases the examples' generation leases after each audited micro-batch —
    the audit then also exercises lease GC under churn."""
    report = AuditReport()
    for mb in micro_batches:
        outputs = materializer.materialize_batch(list(mb), projection)
        for exm, got in zip(mb, outputs):
            _check_one(report, exm, references_by_id[exm.request_id], got,
                       projection, schema)
        if ack is not None:
            ack(mb)
    return report
