"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors ``repro`` module for module. Imports torch and numpy, never jax and
never ``repro``: the host data plane (``core``, ``storage``, ``obs``, ``dpp``,
``data.spec``/``data.planner``) is a copy with its import paths renamed, so
payload bytes stay identical; the device half is rewritten in PyTorch with
hand-written CUDA kernels under ``kernels/*/csrc``.
"""
