"""Shared benchmark plumbing: result records, a timer that waits for the
card, and the standard traffic sim.

Port of ``benchmarks/common.py``. The reference's timed lambdas end in
``.block_until_ready()``; here ``timeit`` synchronizes ``device`` after each
call when it is a CUDA device, so a time is the work's and not the
enqueue's."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import events as ev
from repro_torch.core.simulation import ProductionSim, SimConfig


@dataclasses.dataclass
class BenchResult:
    name: str
    us_per_call: float
    derived: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def csv(self) -> str:
        derived = ";".join(f"{k}={v}" for k, v in self.derived.items())
        return f"{self.name},{self.us_per_call:.2f},{derived}"


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for ``device``'s queued work (a no-op off CUDA)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn: Callable[[], Any], repeats: int = 3,
           device: Optional[torch.device] = None) -> float:
    """Median wall time in microseconds, each call followed by
    ``synchronize(device)``."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2]


def standard_sim(mode: str, users: int = 24, days: int = 6,
                 req_per_day: int = 6, events_mean: float = 60.0,
                 seed: int = 42, label_fn=None) -> ProductionSim:
    cfg = SimConfig(
        stream=ev.StreamConfig(
            n_users=users, n_items=5_000, days=days + 1,
            events_per_user_day_mean=events_mean, seed=seed,
        ),
        stripe_len=32,
        requests_per_user_day=req_per_day,
        lookback_ms=days * ev.MS_PER_DAY,
        n_shards=8,
        mode=mode,
        seed=seed,
    )
    sim = ProductionSim(cfg)
    if label_fn is not None:
        sim.label_fn = label_fn
    sim.run_days(days, capture_reference=False)
    return sim
