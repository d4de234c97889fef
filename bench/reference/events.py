"""The benchmark's traffic generator: user events and ranking requests.

A frozen copy of the port's synthetic UIH stream (``SyntheticEventStream``
in ``core/events.py``) and of the request schedule of ``ProductionSim``
(``core/simulation.py:issue_requests``): the same draws from the same seeds,
so the same seed gives the same events and requests. Two changes that keep
every output: the Zipf item draw searches a CDF built once (what
``Generator.choice(p=...)`` does inside, without rebuilding the CDF on each
call), and a user's day is drawn once and kept.

Plain NumPy; imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

MS_PER_DAY = 86_400_000
TRAITS = ("timestamp", "item_id", "action_type", "surface", "watch_time_ms",
          "like", "comment", "share", "category", "creator_id")
DTYPES = {"timestamp": np.int64, "item_id": np.int64, "action_type": np.int32,
          "surface": np.int32, "watch_time_ms": np.int32, "like": np.int8,
          "comment": np.int8, "share": np.int8, "category": np.int32,
          "creator_id": np.int64}

Events = Dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class StreamParams:
    n_users: int
    n_items: int
    days: int
    events_per_user_day_mean: float
    seed: int
    n_creators: int = 5_000
    n_categories: int = 64
    n_action_types: int = 8
    n_surfaces: int = 4
    like_rate: float = 0.06
    comment_rate: float = 0.015
    share_rate: float = 0.008


def _empty() -> Events:
    return {k: np.zeros(0, DTYPES[k]) for k in TRAITS}


class EventStream:
    """Each user's events of each day; timestamps in ms, sorted."""

    def __init__(self, p: StreamParams):
        self.cfg = p
        rng = np.random.default_rng(p.seed)
        ranks = np.arange(1, p.n_items + 1, dtype=np.float64)
        w = 1.0 / ranks**1.1
        item_p = w / w.sum()
        self._item_cdf = item_p.cumsum()
        self._item_cdf /= self._item_cdf[-1]
        self._item_creator = rng.integers(0, p.n_creators, size=p.n_items)
        self._item_category = rng.integers(0, p.n_categories, size=p.n_items)
        self._days: Dict[Tuple[int, int], Events] = {}

    def day_events(self, user_id: int, day: int) -> Events:
        key = (user_id, day)
        out = self._days.get(key)
        if out is None:
            out = self._days[key] = self._draw_day(user_id, day)
        return out

    def _draw_day(self, user_id: int, day: int) -> Events:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, user_id, day))
        n = int(rng.poisson(cfg.events_per_user_day_mean))
        if n == 0:
            return _empty()
        n_sessions = max(1, int(rng.integers(1, 5)))
        starts = np.sort(rng.integers(0, MS_PER_DAY - 3_600_000,
                                      size=n_sessions))
        sess = rng.integers(0, n_sessions, size=n)
        ts = day * MS_PER_DAY + starts[sess] + rng.integers(0, 3_600_000,
                                                            size=n)
        ts = np.sort(ts).astype(np.int64)
        items = self._item_cdf.searchsorted(rng.random(n), side="right"
                                            ).astype(np.int64)
        out = {
            "timestamp": ts,
            "item_id": items,
            "action_type": rng.integers(0, cfg.n_action_types,
                                        size=n).astype(np.int32),
            "surface": rng.integers(0, cfg.n_surfaces, size=n).astype(np.int32),
            "watch_time_ms": np.maximum(
                0, (rng.gamma(2.0, 8_000.0, size=n)).astype(np.int32)),
            "like": (rng.random(n) < cfg.like_rate).astype(np.int8),
            "comment": (rng.random(n) < cfg.comment_rate).astype(np.int8),
            "share": (rng.random(n) < cfg.share_rate).astype(np.int8),
            "category": self._item_category[items].astype(np.int32),
            "creator_id": self._item_creator[items].astype(np.int64),
        }
        for v in out.values():
            v.setflags(write=False)     # kept and handed out: read-only
        return out

    def history_until(self, user_id: int, t: int, start_day: int = 0
                      ) -> Events:
        """Every event of ``user_id`` with ``timestamp <= t``, sorted
        (stable in the day's order)."""
        last_day = min(self.cfg.days - 1, t // MS_PER_DAY)
        days = [self.day_events(user_id, d)
                for d in range(start_day, last_day + 1)]
        days = [d for d in days if len(d["timestamp"])]
        if not days:
            return _empty()
        cat = {k: np.concatenate([d[k] for d in days]) for k in TRAITS}
        order = np.argsort(cat["timestamp"], kind="stable")
        cat = {k: v[order] for k, v in cat.items()}
        hi = int(np.searchsorted(cat["timestamp"], t, side="right"))
        return {k: v[:hi] for k, v in cat.items()}

    def window(self, user_id: int, lo: int, hi: int) -> Events:
        """Events with ``lo <= timestamp <= hi``."""
        hist = self.history_until(user_id, hi, start_day=max(0, lo)
                                  // MS_PER_DAY)
        ts = hist["timestamp"]
        a = int(np.searchsorted(ts, lo, side="left"))
        b = int(np.searchsorted(ts, hi, side="right"))
        return {k: v[a:b] for k, v in hist.items()}


@dataclasses.dataclass(frozen=True)
class Request:
    user_id: int
    request_ts: int
    cand_item_id: int
    click: float


def day_requests(rng: np.random.Generator, day: int, n_users: int,
                 n_items: int, per_user_day: int) -> List[Request]:
    """The ranking requests of ``day``: sessions of requests inside an hour
    per user, all users interleaved in time order, each with a uniform
    candidate and a click drawn at a 10% rate (in that order from ``rng``)."""
    pairs = []
    for uid in range(n_users):
        n = per_user_day
        n_sessions = max(1, min(2, n // 2))
        starts = rng.integers(day * MS_PER_DAY + 1_000_000,
                              (day + 1) * MS_PER_DAY - 3_600_000,
                              size=n_sessions)
        per = int(np.ceil(n / n_sessions))
        times = []
        for st in starts:
            times.extend(int(st) + int(o)
                         for o in np.sort(rng.integers(0, 3_500_000,
                                                       size=per)))
        pairs.extend((t, uid) for t in times[:n])
    pairs.sort()
    out = []
    for t, uid in pairs:
        cand = int(rng.integers(0, n_items))
        click = float(rng.random() < 0.1)
        out.append(Request(uid, t, cand, click))
    return out
