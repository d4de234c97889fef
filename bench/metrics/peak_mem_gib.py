"""``torch.cuda.max_memory_allocated()`` over the whole run up to the
window's close, set-up included, in GiB."""


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None
