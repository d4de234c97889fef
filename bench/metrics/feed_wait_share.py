"""The share of the window the trainer waited for a batch: the growth of
``ClientStats.starved_time_s`` (the trainer's waits in the feed's ``get``,
with ``Trainer.fit``'s timed-out polls folded in) over the window."""


def read(r):
    if r.feed is None:
        return None
    return 100.0 * r.feed["starved_s"] / r.window_s
