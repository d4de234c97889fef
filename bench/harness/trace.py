"""Readings of a ``torch.profiler`` trace of the measured window.

The device is busy where any kernel, copy or fill runs on any stream: the
union of those intervals, so work on a side stream that overlaps compute
counts once. An idle gap is a stretch of the window outside that union; it
is named by what the host was doing at its middle (the benchmark's own
marks of each step) and by the device operation that ends it.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

Interval = Tuple[int, int, str]      # start ns, end ns, name


def device_intervals(prof) -> List[Interval]:
    """Every device activity of the trace, in wall-clock nanoseconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for e in results.events():
            if e.device_type() != cuda:
                continue
            start = e.start_ns() if hasattr(e, "start_ns") else (
                e.start_us() * 1000)
            dur = e.duration_ns() if hasattr(e, "duration_ns") else (
                e.duration_us() * 1000)
            out.append((int(start), int(start + dur), e.name()))
    return sorted(out)


def union(intervals: List[Interval]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b, _ in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_ns(intervals: List[Interval], lo: int, hi: int) -> int:
    """Nanoseconds of ``[lo, hi]`` in which the device ran anything."""
    return sum(max(0, min(b, hi) - max(a, lo))
               for a, b in union(intervals))


def top_ops(intervals: List[Interval], n: int = 10):
    tot: Dict[str, int] = collections.Counter()
    for a, b, name in intervals:
        tot[name] += b - a
    return [[name[:120], ns / 1e9] for name, ns in tot.most_common(n)]


def idle_gaps(intervals: List[Interval], lo: int, hi: int,
              phases: List[Tuple[int, int, str]], n: int = 10):
    """The ``n`` longest idle stretches of ``[lo, hi]``, each named
    ``"<host phase> / before <next device op>"``, in seconds."""
    spans = union(intervals)
    starts = {}
    for a, _, name in intervals:
        starts.setdefault(a, name)
    gaps = []
    cursor = lo
    for a, b in spans + [(hi, hi)]:
        if a > cursor:
            gaps.append((a - cursor, cursor, a, starts.get(a, "window end")))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    gaps.sort(reverse=True)
    out = []
    for dur, a, b, nxt in gaps[:n]:
        mid = (a + b) // 2
        what = next((name for p0, p1, name in phases if p0 <= mid < p1),
                    "between steps")
        out.append([f"{what} / before {nxt[:80]}", dur / 1e9])
    return out
