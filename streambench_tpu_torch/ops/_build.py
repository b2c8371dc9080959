"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source for ``sm_90a`` into a shared library with a
plain C entry point, at first use, into the build directory
(``utils.build``); ``ctypes`` loads it.  Nothing here runs at import: the
CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

from streambench_tpu_torch.utils.build import build_library

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
COUNT_CELLS_SRC = os.path.join(_CSRC, "count_cells.cu")
_lock = threading.Lock()
_count_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """``nvcc`` from PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda)")


def _nvcc(src: str):
    def command(out: str) -> list[str]:
        return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-Xptxas=-v", "-shared",
                "-Xcompiler", "-fPIC",
                "-o", out, src]
    return command


def count_cells_lib() -> ctypes.CDLL:
    """The count kernel's library, built on first call; raises when it
    cannot be built."""
    global _count_lib
    with _lock:
        if _count_lib is None:
            lib = ctypes.CDLL(build_library(
                "count_cells", [COUNT_CELLS_SRC], _nvcc(COUNT_CELLS_SRC)))
            p = ctypes.c_void_p
            lib.sb_count_cells.restype = ctypes.c_int
            lib.sb_count_cells.argtypes = [p, p, p, p, ctypes.c_int64,
                                           ctypes.c_int64, ctypes.c_int64, p]
            _count_lib = lib
        return _count_lib
