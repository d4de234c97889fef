"""``fused_densify``'s share of its roofline: the least time a launch
could take (the bytes it must move, ``reference.densify_bytes``, at the
HBM's 3.35 TB/s) over its device time a launch in the trace."""


def read(r):
    d = r.densify
    if not d or d["device_s"] <= 0:
        return None
    return 100.0 * d["least_s"] / d["device_s"]
