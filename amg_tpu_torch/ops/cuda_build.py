"""Build and load the port's hand-written CUDA sources.

Each ``amg_tpu_torch/csrc/<name>.cu`` is compiled on first use by ``nvcc``
for Hopper (``sm_90a``) into ``amg_tpu_torch/build/lib<name>.so``, a shared
library with a plain C interface that the kernel module binds with
ctypes (no PyTorch headers: the build takes seconds, not minutes).  The
library is rebuilt only when it is older than its source, and each
process builds into its own temporary file first, so concurrent
processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

from .. import tracing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``),
    else the first one on ``PATH``."""
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           f"from {CSRC} on first use and need the CUDA "
                           "toolkit")
    return found


class CudaLibrary:
    """One ``csrc/*.cu`` source, its shared library and its ctypes binding.

    ``bind(dll)`` declares ``argtypes``/``restype`` of the library's
    entries; it runs once, when the library is first loaded.
    """

    def __init__(self, source_name: str, bind):
        stem = os.path.splitext(source_name)[0]
        self.source = os.path.join(CSRC, source_name)
        self.so = os.path.join(BUILD, f"lib{stem}.so")
        self._bind = bind
        self._dll = None
        self._lock = threading.Lock()

    def build(self) -> str:
        """Compile the source unless the library is newer than it.
        Returns the library path."""
        if os.path.exists(self.so) and \
                os.path.getmtime(self.so) >= os.path.getmtime(self.source):
            return self.so
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{self.so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
        with tracing.span("amg.kernels.build"):
            proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, self.so)
        return self.so

    def load(self) -> ctypes.CDLL:
        """The bound library, built and loaded on the first call."""
        with self._lock:
            if self._dll is None:
                dll = ctypes.CDLL(self.build())
                self._bind(dll)
                self._dll = dll
        return self._dll
