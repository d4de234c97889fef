"""Milliseconds of a window step's forward and backward passes over its
microbatches: CUDA events around ``Trainer._grads``, mean over the steps."""
import statistics


def read(r):
    return statistics.mean(r.grad_ms) if r.grad_ms else None
