"""The 90th percentile of the intervals between consecutive step ends in
the window (host clock), the first from the window's start; each interval
holds the wait for the step's batch. Reported where a step lasts 250 ms or
more, so that the host clock's half a millisecond does not matter; needs
ten steps or more."""
import statistics


def read(r):
    ends = [r.window_start] + list(r.step_ends)
    gaps = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
    if len(gaps) < 10:
        return None
    return statistics.quantiles(gaps, n=10, method="inclusive")[8]
