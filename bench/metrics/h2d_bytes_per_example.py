"""Bytes the handover shipped to the card per example delivered in the
window: the growth of ``ClientStats.h2d_bytes`` over the delivered rows."""


def read(r):
    if r.feed is None or r.feed["batches"] <= 0:
        return None
    return r.feed["h2d_bytes"] / (r.feed["batches"] * r.batch)
