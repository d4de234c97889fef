"""Milliseconds of the handover per delivered batch: the growth of
``ClientStats.h2d_time_s`` (the transfer thread's copy and device densify,
waited on its side-stream event) over the delivered batches."""


def read(r):
    if r.feed is None or r.feed["batches"] <= 0:
        return None
    return 1e3 * r.feed["h2d_s"] / r.feed["batches"]
