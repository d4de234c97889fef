"""Examples whose step completed in the window, over the window's seconds
(host clock): all the work over all the time."""


def read(r):
    return r.examples / r.window_s if r.examples else None
