"""Microseconds the DPP workers spent on an example in the window: the
growth of their probe, lookup and featurize time (``WorkerStats``, merged
over the workers; wall time in worker threads) over the growth of the
examples they processed."""


def read(r):
    if r.feed is None or r.feed["dpp_examples"] <= 0:
        return None
    return 1e6 * r.feed["dpp_busy_s"] / r.feed["dpp_examples"]
