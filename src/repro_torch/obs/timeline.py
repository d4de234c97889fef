"""Reading a run's thread phases (``timeline.jsonl``, ``SpanTracker.timeline``).

``summary`` totals the phases by thread and name: how many, and the mean
wall ms, thread CPU ms and device ms of each. The rest is the arithmetic
that sets the phases against the device intervals of a trace of the same
window, all in epoch nanoseconds (``obs.clock.now_ns``, the base of
``torch.profiler``'s ``start_ns``):

    idle_share(phases, device, window, names, thread)
        % of the window in which the device ran nothing while ``thread``
        was inside one of ``names`` (the trainer in ``train.grads`` or
        ``train.optimizer``: idle time spent dispatching)
    cpu_share(phases, names, thread)
        % of ``thread``'s wall time in ``names`` that it had the CPU
    device_ms_per_id(phases, prefix, keys)
        mean device ms an id (a step, a batch's ``emit_seq``) over the
        phases named ``prefix*``, summed over ``keys``

    python -m repro_torch.obs.timeline <run_dir>   # the summary, as text
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Phase = Dict
Intervals = List[Tuple[int, int]]


def load(path) -> List[Phase]:
    """The phases of a run directory's (or a file's) ``timeline.jsonl``."""
    p = Path(path)
    if p.is_dir():
        p = p / "timeline.jsonl"
    return [json.loads(line) for line in p.read_text().splitlines() if line]


def merged(pairs: Iterable[Sequence[int]]) -> Intervals:
    """Sorted, disjoint intervals covering ``pairs``, each ``(start, end)``
    and any further fields (a trace's kernel name) ignored."""
    out: List[List[int]] = []
    for p in sorted(pairs):
        a, b = p[0], p[1]
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_ns(xs: Intervals, ys: Intervals) -> int:
    """Nanoseconds in both of two sorted, disjoint interval lists."""
    i = j = tot = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            tot += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_intervals(device: Iterable[Sequence[int]], lo: int,
                   hi: int) -> Intervals:
    """The parts of ``[lo, hi)`` in which no device interval runs."""
    out, cursor = [], lo
    for a, b in merged(device):
        if b <= cursor:
            continue
        if a >= hi:
            break
        if a > cursor:
            out.append((cursor, a))
        cursor = b
    if cursor < hi:
        out.append((cursor, hi))
    return out


def _spans(phases: Sequence[Phase], names, thread: Optional[str]):
    return [p for p in phases if p["name"] in names
            and (thread is None or p["thread"] == thread)]


def idle_share(phases: Sequence[Phase], device, window: Tuple[int, int],
               names, thread: Optional[str] = None) -> float:
    lo, hi = window
    inside = merged((p["t0_ns"], p["t1_ns"])
                    for p in _spans(phases, names, thread))
    return 100.0 * overlap_ns(idle_intervals(device, lo, hi),
                              inside) / (hi - lo)


def cpu_share(phases: Sequence[Phase], names,
              thread: Optional[str] = None) -> Optional[float]:
    ps = _spans(phases, names, thread)
    wall = sum(p["t1_ns"] - p["t0_ns"] for p in ps)
    return 100.0 * sum(p["cpu_ns"] for p in ps) / wall if wall else None


def device_ms_per_id(phases: Sequence[Phase], prefix: str,
                     keys: Sequence[str]) -> Optional[float]:
    by: Dict = {}
    for p in phases:
        if p["name"].startswith(prefix):
            dev = p.get("device_ms") or {}
            by[p["id"]] = by.get(p["id"], 0.0) + sum(dev.get(k, 0.0)
                                                     for k in keys)
    return sum(by.values()) / len(by) if by else None


def summary(phases: Sequence[Phase]) -> Dict[str, Dict[str, Dict]]:
    """{thread: {name: {"n", "wall_ms", "cpu_ms", "device_ms": {key}}}},
    the times as means over the phase's ``n`` spans."""
    out: Dict[str, Dict[str, Dict]] = {}
    for p in phases:
        d = out.setdefault(p["thread"], {}).setdefault(
            p["name"], {"n": 0, "wall_ms": 0.0, "cpu_ms": 0.0,
                        "device_ms": {}})
        d["n"] += 1
        d["wall_ms"] += (p["t1_ns"] - p["t0_ns"]) / 1e6
        d["cpu_ms"] += p["cpu_ns"] / 1e6
        for k, v in (p.get("device_ms") or {}).items():
            d["device_ms"][k] = d["device_ms"].get(k, 0.0) + v
    for names in out.values():
        for d in names.values():
            n = d["n"]
            d["wall_ms"] /= n
            d["cpu_ms"] /= n
            d["device_ms"] = {k: v / n for k, v in d["device_ms"].items()}
    return out


def render(phases: Sequence[Phase]) -> str:
    lines = [f"{'thread':<16} {'phase':<18} {'n':>7} {'wall ms':>10} "
             f"{'cpu ms':>10}  device ms"]
    for thread, names in sorted(summary(phases).items()):
        for name, d in sorted(names.items()):
            dev = " ".join(f"{k}={v:.3f}"
                           for k, v in sorted(d["device_ms"].items()))
            lines.append(f"{thread:<16} {name:<18} {d['n']:>7} "
                         f"{d['wall_ms']:>10.3f} {d['cpu_ms']:>10.3f}  {dev}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.timeline <run_dir>",
              file=sys.stderr)
        return 2
    print(render(load(argv[0])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
