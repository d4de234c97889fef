"""The device an entry point runs on.

The port's examples and benchmarks take ``--device``: ``cuda`` unless the
caller asks for ``cpu``, as the tests do. Asked for ``cuda`` without a card,
they stop with an error; nothing falls back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``name`` as a ``torch.device``; a bare ``cuda`` names the current
    card. Raises ``RuntimeError`` for a CUDA device when
    ``torch.cuda.is_available()`` is False."""
    device = torch.device(name)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: torch.cuda.is_available() is False (no CUDA "
            f"card or a CPU-only torch build); pass --device cpu to run on "
            f"the CPU")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
