"""The share of the traced window in which nothing ran on the card: one
minus the union of every kernel, copy and fill interval on every stream
(``harness.trace``) over the window."""


def read(r):
    t = r.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
