"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source for ``sm_90a`` into a shared library with a
plain C entry point, at first use, into the build directory
(``utils.build``); ``ctypes`` loads it.  Nothing here runs at import: the
CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import threading

from streambench_tpu_torch.utils.build import build_library

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")


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


class _Library:
    """One kernel library: ``csrc/<name>.cu`` built by ``nvcc`` on the
    first call, loaded with ``ctypes`` and its entry points typed by
    ``bind``; raises when it cannot be built.  One lock per library, so
    the nvcc runs can go at once."""

    def __init__(self, name: str, bind):
        self.name = name
        self.src = os.path.join(_CSRC, name + ".cu")
        self.lib: ctypes.CDLL | None = None
        self._bind = bind
        self._lock = threading.Lock()

    def __call__(self) -> ctypes.CDLL:
        if self.lib is not None:        # built: no lock on the launch path
            return self.lib
        with self._lock:
            if self.lib is None:
                lib = ctypes.CDLL(build_library(self.name, [self.src],
                                                _nvcc(self.src)))
                self._bind(lib)
                self.lib = lib
            return self.lib


_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def _bind_count(lib: ctypes.CDLL) -> None:
    lib.sb_count_cells.restype = ctypes.c_int
    # counts, campaign, slot, mask, plan (ops/count.py:_PlanArgs), stream
    lib.sb_count_cells.argtypes = [_p] * 6
    lib.sb_device_limits.restype = ctypes.c_int
    lib.sb_device_limits.argtypes = [ctypes.c_int, _p, _p]
    lib.sb_empty_launch.restype = ctypes.c_int
    lib.sb_empty_launch.argtypes = [_p]


def _bind_decode(lib: ctypes.CDLL) -> None:
    lib.sb_decode_rows.restype = ctypes.c_int
    # buf, cap, starts, lens, rows, keys, meta, table, probes, base_hi,
    # base_lo, campaign, is_view, rel, valid, plan (ops/decode.py:
    # _PlanArgs), stream
    lib.sb_decode_rows.argtypes = [_p, _i64, _p, _p, _i64, _p, _p, _i32,
                                   _i32, _i32, _i32, _p, _p, _p, _p, _p, _p]


def _bind_cms(lib: ctypes.CDLL) -> None:
    # each: ..., D, widths, B, plan (ops/cmsrows.py:launch_plan), stream
    lib.sb_cms_update.restype = ctypes.c_int
    # table, total, keys, weights, mask; blocks, threads, rows a thread,
    # hot table
    lib.sb_cms_update.argtypes = [_p, _p, _p, _p, _p, _i32, _i64, _i64,
                                  _i32, _i32, _i32, _i32, _p]
    lib.sb_cms_query.restype = ctypes.c_int
    # table, keys, out; blocks, threads
    lib.sb_cms_query.argtypes = [_p, _p, _p, _i32, _i64, _i64, _i32, _i32,
                                 _p]
    lib.sb_cms_refresh_small.restype = ctypes.c_int
    # fat, small, keys, mask; Wd, Ws; blocks, threads
    lib.sb_cms_refresh_small.argtypes = [_p, _p, _p, _p, _i32, _i64, _i64,
                                         _i64, _i32, _i32, _p]
    lib.sb_cms_cols.restype = ctypes.c_int
    # keys, cols; blocks, threads
    lib.sb_cms_cols.argtypes = [_p, _p, _i32, _i64, _i64, _i32, _i32, _p]
    lib.sb_cms_update_query.restype = ctypes.c_int
    # table, total, keys, weights, mask, small (NULL: fixed), out; D, Wd,
    # Ws, B; the update's blocks, threads, rows a thread, hot table
    lib.sb_cms_update_query.argtypes = [_p] * 7 + [_i32, _i64, _i64, _i64,
                                                   _i32, _i32, _i32, _i32,
                                                   _p]


#: the count kernel K1, the decode kernel K2, the count-min kernel K3
count_cells_lib = _Library("count_cells", _bind_count)
decode_rows_lib = _Library("decode_rows", _bind_decode)
cms_rows_lib = _Library("cms_rows", _bind_cms)
COUNT_CELLS_SRC = count_cells_lib.src
DECODE_ROWS_SRC = decode_rows_lib.src
CMS_ROWS_SRC = cms_rows_lib.src


def launch(what: str, entry, index: int, *args) -> None:
    """``entry(*args, stream)``, one kernel launch on CUDA device
    ``index``'s current PyTorch stream (made the current device for the
    call); raises when the entry point returns a CUDA error."""
    import torch

    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        rc = entry(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
