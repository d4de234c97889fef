"""Hand-written CUDA kernels (Hopper, sm_90a): for the materialization hot
path ``fused`` (``fused_densify``), ``embedding_bag``, ``jagged``
(``jagged_to_padded``) and ``delta_decode``, one for each Pallas kernel of
the reference; ``adamw``, the optimizer step, which the reference left
to XLA's fusion; and ``grouped_gemm``, a dropless MoE layer's experts over
rows whose counts only the card knows (the reference runs a batched product
over a fixed capacity).

Each kernel directory holds ``csrc/<name>.cu`` (CUDA C++ with a plain C entry
point), and ``ops.py`` (the PyTorch wrapper: launches the kernel for a CUDA
tensor, runs the plain PyTorch version for a CPU tensor, counts launches).
``build.py`` compiles the sources with ``nvcc`` into ``build/`` at first use
and loads them with ``ctypes``; nothing is compiled or imported at module
import time, so the package imports on a machine without CUDA.
"""
