"""Build and bind the port's CUDA kernels: ``nvcc`` into ``build/``, ``ctypes``.

Each ``.cu`` source under ``kernels/*/csrc`` exposes a plain C interface, so
it compiles in seconds without PyTorch's headers and is loaded with
``ctypes``. The shared library is named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import time: a wrapper calls ``KernelLibrary.lib()`` (or
``function()``) the first time it launches, and that call runs ``nvcc`` if
the library is missing.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

CFunc = Tuple[Sequence[type], Optional[type]]   # (argtypes, restype)


def find_nvcc() -> str:
    """``nvcc`` from PATH, else the toolkit's default location; raises when
    neither exists (there is no prebuilt fallback)."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


class KernelLibrary:
    """One CUDA source compiled to one shared library with C entry points."""

    def __init__(self, source: Path, functions: Dict[str, CFunc]):
        self.source = Path(source)
        self.functions = functions
        self.build_log = ""      # nvcc's output (ptxas register/smem report)
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.PyDLL] = None

    @functools.cached_property
    def path(self) -> Path:
        """The library's file, named by a hash of the source and flags."""
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.source.stem}-{digest[:12]}.so"

    def _build(self) -> None:
        """Run ``nvcc`` unless the library exists; raises with nvcc's output
        if it fails. The output lands under a temporary name and is renamed
        into place, so a concurrent process never loads a partial file."""
        if self.path.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.build_log = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source} "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, self.path)

    def lib(self) -> ctypes.PyDLL:
        """The loaded library, its C functions bound with their argtypes,
        built first if needed. Once loaded, a call reads a plain attribute
        and takes no lock; the lock guards the first build and load only."""
        lib = self._lib
        if lib is None:
            lib = self._load()
        return lib

    def _load(self) -> ctypes.PyDLL:
        with self._lock:
            if self._lib is None:
                self._build()
                # PyDLL: a call keeps the GIL. A launch takes microseconds,
                # while a released GIL may go to a busy thread for a whole
                # switch interval (5 ms) before the launching thread gets
                # it back.
                lib = ctypes.PyDLL(str(self.path))
                for name, (argtypes, restype) in self.functions.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = restype
                self._lib = lib
            return self._lib

    def function(self, name: str):
        """The bound C function ``name`` (a ``ctypes`` function pointer with
        its argtypes set): a wrapper keeps it in a module-level handle after
        its first launch and calls it directly from then on."""
        return getattr(self.lib(), name)


def check(lib: KernelLibrary, status: int) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if status != 0:
        msg = lib.lib().cuda_error_string(status).decode()
        raise RuntimeError(f"{lib.source.stem} launch failed: "
                           f"cudaError {status} ({msg})")
