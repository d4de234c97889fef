"""Process-wide metrics registry: labeled counters, gauges, histograms.

The registry is the convergence point for the repo's ~14 ``*Stats``
dataclasses (DESIGN.md §13).  Legacy stats objects stay the source of truth
on their hot paths — workers mutate plain dataclass fields with zero
registry involvement — and a thin adapter (:func:`publish_dataclass`)
publishes point-in-time snapshots into labeled registry series at snapshot
or merge boundaries (``Feed.snapshot``, store ``stats`` reads, run-dir
dumps).  Direct instrumentation (histograms on the hedging RTT path, the
train-step timer, per-stage span durations) observes into the registry
directly; those paths are one uncontended lock acquire per sample.

Design points:

  * **Families + label sets.**  ``registry.counter(name, labels=("node",))``
    returns a family; ``family.labels(node=3)`` returns the per-series child
    (get-or-create under the family lock, then cached — steady-state lookups
    are a dict hit).  Families with no labels expose the child API directly
    (``family.inc()``), so unlabeled call sites stay one-liners.
  * **Mergeable.**  ``MetricsRegistry.merge_from`` folds another registry
    (e.g. a per-worker or per-node one) into this one by (name, labelset):
    counters add, gauges take the latest write, histograms add bucket
    vectors.  Histogram buckets are fixed at family creation so merges are
    exact.
  * **LatencyTracker-compatible histograms.**  ``Histogram`` optionally
    keeps a bounded sample window (``window=N``) and then serves
    ``quantile(q)`` with the exact same semantics as the legacy
    ``repro_torch.storage.failover.LatencyTracker`` — ``None`` below
    ``min_samples``, index-method quantile over the sorted window — so the
    sharded store's hedge-deadline logic migrates onto a registry metric
    without behavioral drift.  Without a window, ``quantile`` interpolates
    within fixed buckets (good enough for p50/p95/p99 reporting).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import threading
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

# Exponential-ish second buckets: 10us .. 60s. Fixed so histograms merge
# exactly across workers/nodes/processes.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    """Monotone counter. ``inc`` for live increments, ``set_total`` for
    adapter publishing of a cumulative legacy-stats field (monotone max, so
    republishing an older snapshot can never move the series backwards)."""

    kind = "counter"
    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def set_total(self, value: float) -> None:
        with self._lock:
            if value > self._value:
                self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def merge_from(self, other: "Counter") -> None:
        self.inc(other.value)

    def to_dict(self) -> Dict[str, Any]:
        return {"value": self._value}


class Gauge:
    """Last-write-wins instantaneous value (queue depths, live workers)."""

    kind = "gauge"
    __slots__ = ("_value", "_lock")

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def merge_from(self, other: "Gauge") -> None:
        # Cross-worker gauges are additive (e.g. per-worker queue depths).
        self.inc(other.value)

    def to_dict(self) -> Dict[str, Any]:
        return {"value": self._value}


class Histogram:
    """Fixed-bucket histogram with optional exact-quantile sample window."""

    kind = "histogram"
    __slots__ = ("buckets", "min_samples", "_counts", "_sum", "_count",
                 "_min", "_max", "_window", "_lock")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 window: int = 0, min_samples: int = 1) -> None:
        self.buckets = tuple(sorted(buckets))
        self.min_samples = min_samples
        self._counts = [0] * (len(self.buckets) + 1)  # +1 overflow bucket
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")
        self._window: Optional[Deque[float]] = (
            collections.deque(maxlen=window) if window else None)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            if self._window is not None:
                self._window.append(value)

    # LatencyTracker-compatible surface -----------------------------------
    record = observe

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """q-quantile; ``None`` below ``min_samples`` (a cold histogram must
        not drive hedging decisions). Exact over the sample window when one
        is kept, else interpolated within the fixed buckets."""
        with self._lock:
            if self._count < max(self.min_samples, 1):
                return None
            if self._window:
                ordered = sorted(self._window)
                idx = min(len(ordered) - 1, max(0, int(q * len(ordered))))
                return ordered[idx]
            counts = list(self._counts)
            total = self._count
            lo_all, hi_all = self._min, self._max
        # Bucket interpolation: find the bucket holding the q-th sample and
        # interpolate linearly inside it.
        target = max(0.0, min(1.0, q)) * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.buckets[i - 1] if i > 0 else min(lo_all, self.buckets[0])
                hi = self.buckets[i] if i < len(self.buckets) else max(hi_all, self.buckets[-1])
                frac = (target - cum) / c
                return lo + (hi - lo) * frac
            cum += c
        return hi_all

    def observed_at_least(self, seconds: float) -> int:
        """How many window samples are >= ``seconds`` (introspection)."""
        with self._lock:
            if self._window is None:
                idx = bisect.bisect_left(self.buckets, seconds)
                return sum(self._counts[idx:])
            ordered = sorted(self._window)
        return len(ordered) - bisect.bisect_left(ordered, seconds)

    def merge_from(self, other: "Histogram") -> None:
        if other.buckets != self.buckets:
            raise ValueError("cannot merge histograms with different buckets")
        with other._lock:
            counts = list(other._counts)
            osum, ocount = other._sum, other._count
            omin, omax = other._min, other._max
            owindow = list(other._window) if other._window is not None else []
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += osum
            self._count += ocount
            self._min = min(self._min, omin)
            self._max = max(self._max, omax)
            if self._window is not None:
                self._window.extend(owindow)

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "buckets": list(self.buckets),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "p50": None, "p95": None, "p99": None,
            } | {f"p{int(q * 100)}": self.__quantile_unlocked(q)
                 for q in (0.5, 0.95, 0.99)}

    def __quantile_unlocked(self, q: float) -> Optional[float]:
        # to_dict holds the lock; quantile() re-acquires, so compute from a
        # window copy / bucket walk without locking again.
        if self._count < 1:
            return None
        if self._window:
            ordered = sorted(self._window)
            idx = min(len(ordered) - 1, max(0, int(q * len(ordered))))
            return ordered[idx]
        target = max(0.0, min(1.0, q)) * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.buckets[i - 1] if i > 0 else min(self._min, self.buckets[0])
                hi = self.buckets[i] if i < len(self.buckets) else max(self._max, self.buckets[-1])
                return lo + (hi - lo) * ((target - cum) / c)
            cum += c
        return self._max


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """A named metric plus its per-labelset children."""

    def __init__(self, name: str, kind: str, help: str,
                 label_names: Tuple[str, ...], **child_kw: Any) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = label_names
        self._child_kw = child_kw
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._lock = threading.Lock()

    def _make_child(self) -> Any:
        return _KINDS[self.kind](**self._child_kw)

    def labels(self, **labels: Any):
        try:
            key = tuple(str(labels[n]) for n in self.label_names)
        except KeyError as e:
            raise ValueError(
                f"metric {self.name!r} requires labels {self.label_names}, "
                f"got {tuple(labels)}") from e
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"metric {self.name!r} requires labels {self.label_names}, "
                f"got {tuple(labels)}")
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child()
                    self._children[key] = child
        return child

    @property
    def default(self):
        """The single child of an unlabeled family."""
        return self.labels()

    def series(self) -> List[Tuple[Dict[str, str], Any]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.label_names, key)), child)
                for key, child in items]

    # Unlabeled convenience passthrough ------------------------------------
    def inc(self, n: float = 1.0) -> None:
        self.default.inc(n)

    def set(self, value: float) -> None:
        self.default.set(value)

    def set_total(self, value: float) -> None:
        self.default.set_total(value)

    def observe(self, value: float) -> None:
        self.default.observe(value)

    record = observe

    def quantile(self, q: float) -> Optional[float]:
        return self.default.quantile(q)

    @property
    def value(self) -> float:
        return self.default.value

    @property
    def count(self) -> int:
        return self.default.count


class MetricsRegistry:
    """Get-or-create metric families keyed by name; export + merge."""

    def __init__(self) -> None:
        self._families: Dict[str, Family] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, kind: str, help: str,
                labels: Sequence[str], **child_kw: Any) -> Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = Family(name, kind, help, tuple(labels), **child_kw)
                    self._families[name] = fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, not {kind}")
        if fam.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{fam.label_names}, not {tuple(labels)}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Family:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Family:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  window: int = 0, min_samples: int = 1) -> Family:
        return self._family(name, "histogram", help, labels,
                            buckets=buckets, window=window,
                            min_samples=min_samples)

    def families(self) -> List[Family]:
        with self._lock:
            return list(self._families.values())

    def merge_from(self, other: "MetricsRegistry") -> None:
        for fam in other.families():
            mine = self._family(fam.name, fam.kind, fam.help,
                                fam.label_names, **fam._child_kw)
            for labels, child in fam.series():
                mine.labels(**labels).merge_from(child)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for fam in self.families():
            out[fam.name] = {
                "type": fam.kind,
                "help": fam.help,
                "label_names": list(fam.label_names),
                "series": [{"labels": labels, **child.to_dict()}
                           for labels, child in fam.series()],
            }
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (counters get the conventional
        ``_total``-suffixed sample names only if already named that way)."""
        lines: List[str] = []
        for fam in sorted(self.families(), key=lambda f: f.name):
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labels, child in fam.series():
                base = _fmt_labels(labels)
                if fam.kind == "histogram":
                    cum = 0
                    snap = child.to_dict()
                    for ub, c in zip(snap["buckets"], snap["counts"]):
                        cum += c
                        lines.append(
                            f"{fam.name}_bucket{_fmt_labels(labels, le=ub)} {cum}")
                    cum += snap["counts"][-1]
                    lines.append(
                        f"{fam.name}_bucket{_fmt_labels(labels, le='+Inf')} {cum}")
                    lines.append(f"{fam.name}_sum{base} {snap['sum']}")
                    lines.append(f"{fam.name}_count{base} {snap['count']}")
                else:
                    lines.append(f"{fam.name}{base} {child.value}")
        return "\n".join(lines) + "\n"


def _fmt_labels(labels: Dict[str, str], **extra: Any) -> str:
    items = {**labels, **{k: str(v) for k, v in extra.items()}}
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items.items())
    return "{" + body + "}"


def publish_dataclass(registry: MetricsRegistry, obj: Any, *, prefix: str,
                      labels: Optional[Dict[str, Any]] = None,
                      gauge_fields: Sequence[str] = ()) -> None:
    """Adapter: publish every numeric field of a legacy ``*Stats`` dataclass
    into the registry under the naming rule

        ``repro_<prefix>_<field>_total``   (counters — the default)
        ``repro_<prefix>_<field>``         (fields listed in gauge_fields)

    Counter publishing uses ``set_total`` (monotone max), so republishing an
    older snapshot never regresses a series.  Non-numeric fields (nested
    stats, dicts, bools) are skipped — nested stats publish under their own
    prefix at their own call sites."""
    labels = dict(labels or {})
    label_names = tuple(sorted(labels))
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name, None)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        if f.name in gauge_fields:
            registry.gauge(f"repro_{prefix}_{f.name}",
                           labels=label_names).labels(**labels).set(v)
        else:
            registry.counter(f"repro_{prefix}_{f.name}_total",
                             labels=label_names).labels(**labels).set_total(v)
