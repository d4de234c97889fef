"""Render a telemetry run directory for humans.

    python -m repro_torch.obs.report <run_dir> [--top-k N]

Reads the artifacts written by ``Telemetry.write_run_dir`` (metrics.json,
events.jsonl, spans.jsonl) and prints:

  * the per-stage time breakdown (total/mean/p50/p95 per pipeline stage),
  * starvation attribution — what fraction of the trainer's measured
    starvation wall-time each upstream stage is responsible for,
  * the control-plane event timeline (breaker flips, failovers, worker
    restarts, generation flips, ...),
  * the top-k slowest sampled batches with their stage splits.

Everything is pure-stdlib and file-driven so it works on any run dir,
including ones produced on another machine.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.obs.spans import HOST_STAGES, critical_path

STAGE_ORDER = ("scan", "featurize", "place", "h2d", "train")


def load_run_dir(run_dir) -> Dict[str, Any]:
    root = Path(run_dir)
    if not root.is_dir():
        raise FileNotFoundError(f"not a run directory: {root}")
    metrics: Dict[str, Any] = {}
    mpath = root / "metrics.json"
    if mpath.exists():
        metrics = json.loads(mpath.read_text())
    events = _read_jsonl(root / "events.jsonl")
    spans = _read_jsonl(root / "spans.jsonl")
    summary: Dict[str, Any] = {}
    spath = root / "summary.json"
    if spath.exists():
        summary = json.loads(spath.read_text())
    return {"metrics": metrics, "events": events, "spans": spans,
            "summary": summary}


def _read_jsonl(path: Path) -> List[Dict[str, Any]]:
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out


def _counter_total(metrics: Dict[str, Any], name: str) -> float:
    fam = metrics.get(name)
    if not fam:
        return 0.0
    return sum(s.get("value", 0.0) for s in fam.get("series", []))


def _span_stage_records(spans: List[Dict[str, Any]]) -> Dict[str, List[float]]:
    """stage -> list of per-record durations (item-level for host stages,
    batch-level for h2d/train)."""
    recs: Dict[str, List[float]] = {}
    for bs in spans:
        for item in bs.get("items", []):
            for name, (t0, t1) in item.get("stages", {}).items():
                recs.setdefault(name, []).append(t1 - t0)
        for name, (t0, t1) in bs.get("stages", {}).items():
            recs.setdefault(name, []).append(t1 - t0)
    return recs


def _quantile(xs: List[float], q: float) -> float:
    ordered = sorted(xs)
    idx = min(len(ordered) - 1, max(0, int(q * len(ordered))))
    return ordered[idx]


def render_stage_breakdown(spans: List[Dict[str, Any]]) -> str:
    recs = _span_stage_records(spans)
    if not recs:
        return "== per-stage breakdown ==\n(no sampled spans)"
    total_all = sum(sum(v) for v in recs.values()) or 1.0
    lines = ["== per-stage breakdown ==",
             f"{'stage':<10} {'count':>7} {'total_s':>9} {'mean_ms':>9} "
             f"{'p50_ms':>8} {'p95_ms':>8} {'share':>7}"]
    ordered = [s for s in STAGE_ORDER if s in recs]
    ordered += [s for s in sorted(recs) if s not in STAGE_ORDER]
    for name in ordered:
        xs = recs[name]
        tot = sum(xs)
        lines.append(
            f"{name:<10} {len(xs):>7} {tot:>9.3f} "
            f"{1e3 * tot / len(xs):>9.3f} {1e3 * _quantile(xs, 0.5):>8.3f} "
            f"{1e3 * _quantile(xs, 0.95):>8.3f} {100 * tot / total_all:>6.1f}%")
    return "\n".join(lines)


def render_attribution(metrics: Dict[str, Any],
                       spans: List[Dict[str, Any]]) -> str:
    recs = _span_stage_records(spans)
    stage_totals = {name: sum(xs) for name, xs in recs.items()}
    starved_time_s = _counter_total(metrics, "repro_client_starved_time_s_total")
    starved_host_s = _counter_total(metrics, "repro_client_starved_host_s_total")
    starved_h2d_s = _counter_total(metrics, "repro_client_starved_h2d_s_total")
    cp = critical_path(stage_totals, starved_host_s=starved_host_s,
                       starved_h2d_s=starved_h2d_s,
                       starved_time_s=starved_time_s)
    lines = ["== starvation attribution =="]
    if starved_time_s <= 0:
        lines.append("measured starvation: 0.000s — trainer never starved; "
                     "attributed: 100.0% (nothing to attribute)")
        return "\n".join(lines)
    lines.append(f"measured starvation: {starved_time_s:.3f}s; "
                 f"attributed: {100 * cp['attributed_frac']:.1f}%")
    att = cp["attribution_s"]
    for name in sorted(att, key=att.get, reverse=True):
        lines.append(f"  {name:<10} {att[name]:>9.3f}s "
                     f"({100 * att[name] / starved_time_s:>5.1f}% of starvation)")
    if cp["dominant_stage"]:
        lines.append(f"dominant stage: {cp['dominant_stage']}")
    return "\n".join(lines)


def render_timeline(events: List[Dict[str, Any]], limit: int = 200) -> str:
    lines = ["== event timeline =="]
    if not events:
        lines.append("(no events)")
        return "\n".join(lines)
    t0 = min(ev["t_mono"] for ev in events)
    shown = events if len(events) <= limit else events[-limit:]
    if shown is not events:
        lines.append(f"(showing last {limit} of {len(events)} events)")
    for ev in shown:
        fields = {k: v for k, v in ev.items()
                  if k not in ("seq", "t_mono", "t_wall", "kind")}
        body = " ".join(f"{k}={v}" for k, v in fields.items())
        lines.append(f"+{ev['t_mono'] - t0:>8.3f}s {ev['kind']:<20} {body}")
    counts: Dict[str, int] = {}
    for ev in events:
        counts[ev["kind"]] = counts.get(ev["kind"], 0) + 1
    tally = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    lines.append(f"event counts: {tally}")
    return "\n".join(lines)


def render_slowest(spans: List[Dict[str, Any]], top_k: int = 5) -> str:
    lines = [f"== top-{top_k} slowest batches =="]
    ranked = [bs for bs in spans if bs.get("latency_s") is not None]
    ranked.sort(key=lambda bs: bs["latency_s"], reverse=True)
    if not ranked:
        lines.append("(no delivered sampled batches)")
        return "\n".join(lines)
    for bs in ranked[:top_k]:
        stage_ms = {}
        for item in bs.get("items", []):
            for name, (t0, t1) in item.get("stages", {}).items():
                stage_ms[name] = stage_ms.get(name, 0.0) + 1e3 * (t1 - t0)
        for name, (t0, t1) in bs.get("stages", {}).items():
            stage_ms[name] = stage_ms.get(name, 0.0) + 1e3 * (t1 - t0)
        split = ", ".join(f"{k} {stage_ms[k]:.2f}ms"
                          for k in STAGE_ORDER if k in stage_ms)
        lines.append(f"batch {bs['emit_seq']:>5}  rows={bs.get('rows', '?'):>4}  "
                     f"latency={1e3 * bs['latency_s']:.2f}ms  ({split})")
    return "\n".join(lines)


def _hist_quantile(series: List[Dict[str, Any]], q: float) -> Optional[float]:
    """Interpolated quantile over the SUMMED bucket vectors of a histogram
    family's series (same semantics as ``Histogram.quantile`` without a
    window), so multi-server runs report one combined figure."""
    buckets: List[float] = []
    counts: List[int] = []
    for s in series:
        if not s.get("counts"):
            continue
        if not buckets:
            buckets, counts = list(s["buckets"]), list(s["counts"])
        elif list(s["buckets"]) == buckets:
            counts = [a + b for a, b in zip(counts, s["counts"])]
    total = sum(counts)
    if not total:
        return None
    target = max(0.0, min(1.0, q)) * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i] if i < len(buckets) else buckets[-1]
            return lo + (hi - lo) * ((target - cum) / c)
        cum += c
    return buckets[-1]


def render_serve(metrics: Dict[str, Any],
                 events: List[Dict[str, Any]]) -> Optional[str]:
    """Serving-tier section (DESIGN.md §14): request-latency p50/p99 from the
    ``repro_serve_request_seconds`` histogram, embedding-cache hit rate from
    the ``repro_serve_embed_cache_*`` counters, and the last sampled top-k
    answer. Returns ``None`` when the run served no requests."""
    fam = metrics.get("repro_serve_request_seconds") or {}
    series = fam.get("series", [])
    n = sum(s.get("count", 0) for s in series)
    requests = _counter_total(metrics, "repro_serve_requests_total")
    if not n and not requests:
        return None
    lines = ["== serving tier =="]
    p50, p99 = _hist_quantile(series, 0.5), _hist_quantile(series, 0.99)
    if p50 is not None:
        lines.append(f"requests: {int(requests or n)}  "
                     f"latency p50={1e3 * p50:.3f}ms p99={1e3 * p99:.3f}ms")
    lookups = _counter_total(metrics, "repro_serve_embed_cache_lookups_total")
    hits = _counter_total(metrics, "repro_serve_embed_cache_hits_total")
    if lookups:
        inv = (_counter_total(
                   metrics, "repro_serve_embed_cache_invalidated_generation_total")
               + _counter_total(
                   metrics, "repro_serve_embed_cache_invalidated_freshness_total"))
        lines.append(f"embedding cache: {int(hits)}/{int(lookups)} hits "
                     f"({100 * hits / lookups:.1f}%), "
                     f"{int(inv)} invalidations")
    cold = _counter_total(metrics, "repro_serve_cold_requests_total")
    batches = _counter_total(metrics, "repro_serve_batches_total")
    if batches:
        lines.append(f"micro-batches: {int(batches)} "
                     f"({int(cold)} cold-path requests)")
    samples = [e for e in events if e.get("kind") == "serve_topk_sample"]
    if samples:
        s = samples[-1]
        lines.append(f"sampled top-{s.get('k')} (user {s.get('user')}, "
                     f"gen {s.get('generation')}, "
                     f"index v{s.get('index_version')}): {s.get('items')}")
    return "\n".join(lines)


def render_report(run_dir, top_k: int = 5) -> str:
    data = load_run_dir(run_dir)
    sections = [
        f"telemetry report: {Path(run_dir).resolve()}",
        render_stage_breakdown(data["spans"]),
        render_attribution(data["metrics"], data["spans"]),
        render_timeline(data["events"]),
        render_slowest(data["spans"], top_k=top_k),
    ]
    serve = render_serve(data["metrics"], data["events"])
    if serve:
        sections.append(serve)
    summary = data.get("summary") or {}
    span_counts = summary.get("spans")
    if span_counts:
        sections.append("== span lifecycle ==\n" + " ".join(
            f"{k}={v}" for k, v in span_counts.items()))
    return "\n\n".join(sections)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a telemetry run directory (see DESIGN.md §13).")
    p.add_argument("run_dir", help="directory written by Telemetry.write_run_dir")
    p.add_argument("--top-k", type=int, default=5,
                   help="slowest batches to list (default 5)")
    args = p.parse_args(argv)
    print(render_report(args.run_dir, top_k=args.top_k))
    return 0


if __name__ == "__main__":
    sys.exit(main())
