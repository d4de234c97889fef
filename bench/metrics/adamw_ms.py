"""Milliseconds from a window step's gradients to its end (AdamW over
every leaf and the loss's readback): CUDA events, mean over the steps."""
import statistics


def read(r):
    return statistics.mean(r.adamw_ms) if r.adamw_ms else None
