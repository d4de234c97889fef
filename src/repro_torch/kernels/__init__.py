"""Hand-written CUDA kernels for the materialization hot path (Hopper, sm_90a).

Each kernel directory holds ``csrc/<name>.cu`` (CUDA C++ with a plain C entry
point), and ``ops.py`` (the PyTorch wrapper: launches the kernel for a CUDA
tensor, runs the plain PyTorch version for a CPU tensor, counts launches).
``build.py`` compiles the sources with ``nvcc`` into ``build/`` at first use
and loads them with ``ctypes``; nothing is compiled or imported at module
import time, so the package imports on a machine without CUDA.
"""
