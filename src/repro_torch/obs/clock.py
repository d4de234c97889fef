"""The one clock every span of the port stamps with.

``now_ns()`` is ``time.perf_counter_ns()`` (monotone, fine-grained) shifted
once per process onto the epoch base of ``time.time_ns()``, the base that
``torch.profiler``'s events report through ``start_ns()``. So a host span
of any thread can be set against the device intervals of a profiler trace
of the same process. Stages that keep float seconds use ``now_ns() / 1e9``.
"""
from __future__ import annotations

import time

_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def now_ns() -> int:
    """Nanoseconds since the epoch, advanced by the performance counter."""
    return time.perf_counter_ns() + _OFFSET_NS

