"""Atomic keep-k checkpoints in the reference's on-disk format."""
