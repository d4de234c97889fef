"""Seeded deterministic retry backoff (shared by store failover + DPP heal).

Chaos runs in this repo are *reproducible*: the fault schedule is a seeded
plan (``repro.testing.faults``), and the output is asserted byte-identical to
a fault-free run. Retry timing must not reintroduce nondeterminism, so jitter
is not drawn from a global RNG — ``delay(attempt, token)`` is a pure function
of ``(seed, attempt, token)``. Two retry streams (e.g. two store node groups,
or two DPP work items) decorrelate by ``token`` while each stream's schedule
stays bitwise stable across runs.

The shape is classic capped exponential backoff with *decrease-only* jitter:
``raw = min(base * multiplier**attempt, max)`` and the jittered delay lands in
``[raw * (1 - jitter), raw]`` — jitter desynchronizes retriers without ever
exceeding the cap.
"""
from __future__ import annotations

import time

_M64 = 0xFFFFFFFFFFFFFFFF


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a well-mixed 64-bit hash of ``x``."""
    x &= _M64
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


class Backoff:
    """Deterministic capped exponential backoff with seeded jitter."""

    def __init__(self, base_s: float = 0.002, multiplier: float = 2.0,
                 max_s: float = 0.25, jitter: float = 0.5, seed: int = 0):
        if base_s < 0 or max_s < 0:
            raise ValueError("backoff delays must be >= 0")
        if multiplier < 1.0:
            raise ValueError(f"multiplier must be >= 1, got {multiplier}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.base_s = base_s
        self.multiplier = multiplier
        self.max_s = max_s
        self.jitter = jitter
        self.seed = seed

    def delay(self, attempt: int, token: int = 0) -> float:
        """Delay before retry number ``attempt`` (0-based) of the retry
        stream identified by ``token``. Pure: same (seed, attempt, token)
        always yields the same float."""
        raw = min(self.base_s * self.multiplier ** max(attempt, 0), self.max_s)
        if self.jitter == 0.0 or raw == 0.0:
            return raw
        h = _mix64(_mix64(self.seed * 0x9E3779B97F4A7C15 ^ token) + attempt)
        u = h / float(1 << 64)          # uniform in [0, 1)
        return raw * (1.0 - self.jitter * u)

    def sleep(self, attempt: int, token: int = 0) -> float:
        d = self.delay(attempt, token)
        if d > 0:
            time.sleep(d)
        return d

    def __repr__(self) -> str:
        return (f"Backoff(base_s={self.base_s}, multiplier={self.multiplier},"
                f" max_s={self.max_s}, jitter={self.jitter}, seed={self.seed})")
