"""ctypes binding for the native host runtime, built at first use.

The C++ sources here (JSON event encoder, event formatter, in-process
Redis store) are copies of the JAX package's; the store adds
``sbr_window_digest`` (``io.fakeredis``' ``window_digest``).  ``load()`` compiles them
with ``g++`` into the port's build directory (``utils.build``) the first
time it is called and returns the library handle, or None when no
toolchain is available; callers then fall back to the numpy/Python paths,
as the reference does.  ``build()`` is the strict form: it raises instead.
The ABI is plain C and every buffer is a numpy array passed by pointer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from streambench_tpu_torch.utils.build import BuildError, build_library

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_HERE, s)
            for s in ("encoder.cpp", "gen.cpp", "store.cpp")]
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i64 = ctypes.c_int64
    c_p = ctypes.c_void_p
    lib.sb_encoder_new.restype = c_p
    lib.sb_encoder_new.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(c_i64), ctypes.c_int32, c_i64, c_i64]
    lib.sb_encoder_free.argtypes = [c_p]
    lib.sb_encoder_base_time.restype = c_i64
    lib.sb_encoder_base_time.argtypes = [c_p]
    lib.sb_encoder_set_base_time.argtypes = [c_p, c_i64]
    lib.sb_encoder_set_intern_ids.argtypes = [c_p, ctypes.c_int32]
    lib.sb_encoder_set_hash_ids.argtypes = [c_p, ctypes.c_int32]
    lib.sb_encoder_n_users.restype = c_i64
    lib.sb_encoder_n_users.argtypes = [c_p]
    lib.sb_encoder_n_pages.restype = c_i64
    lib.sb_encoder_n_pages.argtypes = [c_p]
    lib.sb_encoder_users_bytes.restype = c_i64
    lib.sb_encoder_users_bytes.argtypes = [c_p]
    lib.sb_encoder_pages_bytes.restype = c_i64
    lib.sb_encoder_pages_bytes.argtypes = [c_p]
    lib.sb_encoder_dump_users.argtypes = [
        c_p, ctypes.c_char_p, ctypes.POINTER(c_i64)]
    lib.sb_encoder_dump_pages.argtypes = [
        c_p, ctypes.c_char_p, ctypes.POINTER(c_i64)]
    lib.sb_intern_user.restype = ctypes.c_int32
    lib.sb_intern_user.argtypes = [c_p, ctypes.c_char_p, c_i64]
    lib.sb_intern_page.restype = ctypes.c_int32
    lib.sb_intern_page.argtypes = [c_p, ctypes.c_char_p, c_i64]
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.sb_encode_json.restype = c_i64
    lib.sb_encode_json.argtypes = [
        c_p, ctypes.c_char_p, ctypes.POINTER(c_i64), ctypes.c_int32,
        i32p, i32p, i32p, i32p, i32p, i32p,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.sb_encode_block.restype = c_i64
    lib.sb_encode_block.argtypes = [
        c_p, ctypes.c_char_p, c_i64, c_i64, c_i64,
        i32p, i32p, i32p, i32p, i32p, i32p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(c_i64)]
    lib.sb_probe_block.restype = c_i64
    lib.sb_probe_block.argtypes = [
        ctypes.c_char_p, c_i64, c_i64, ctypes.c_int32,
        i32p, i32p, ctypes.POINTER(c_i64),
        ctypes.POINTER(ctypes.c_uint8)]
    c_i32 = ctypes.c_int32
    lib.sb_format_events.restype = c_i64
    lib.sb_format_events.argtypes = [
        ctypes.c_char_p, c_i32, c_i32,          # users
        ctypes.c_char_p, c_i32, c_i32,          # pages
        ctypes.c_char_p, c_i32, c_i32,          # ads
        ctypes.c_char_p, i32p, c_i32,           # ad types
        ctypes.c_char_p, i32p, c_i32,           # event types
        ctypes.POINTER(c_i64), c_i64,           # timestamps
        ctypes.POINTER(ctypes.c_uint64), c_i32,  # rng state, with_skew
        ctypes.c_char_p, c_i64]                 # out, cap
    lib.sb_format_events_cap.restype = c_i64
    lib.sb_format_events_cap.argtypes = [
        c_i32, c_i32, c_i32, i32p, c_i32, i32p, c_i32]
    i64p = ctypes.POINTER(c_i64)
    lib.sbr_new.restype = c_p
    lib.sbr_new.argtypes = []
    lib.sbr_free.argtypes = [c_p]
    lib.sbr_cmd.restype = c_i64
    lib.sbr_cmd.argtypes = [
        c_p, c_i32, ctypes.POINTER(ctypes.c_char_p), i64p,
        ctypes.c_char_p, c_i64]
    lib.sbr_write_windows.restype = c_i64
    lib.sbr_write_windows.argtypes = [
        c_p, c_i64, ctypes.c_char_p, i64p, ctypes.c_char_p, i64p,
        i64p, ctypes.c_char_p, c_i64, c_i32]
    lib.sbr_write_windows_idx.restype = c_i64
    lib.sbr_write_windows_idx.argtypes = [
        c_p, c_i64, ctypes.c_char_p, i64p, c_i64, i32p, i64p, i64p,
        ctypes.c_char_p, c_i64, c_i32]
    lib.sbr_window_digest.restype = c_i64
    lib.sbr_window_digest.argtypes = [c_p, i64p]
    return lib


def _gxx(out: str) -> list[str]:
    return ["g++", "-O3", "-std=c++20", "-fPIC", "-Wall", "-Wextra",
            "-shared", "-o", out, *_SOURCES]


def build() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on any failure."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _configure(ctypes.CDLL(
                build_library("sbnative", _SOURCES, _gxx)))
        return _lib


def load() -> ctypes.CDLL | None:
    """The library, or None when it cannot be built here (no compiler);
    a failed build is not retried."""
    global _tried
    if _lib is None and not _tried:
        try:
            build()
        except (OSError, BuildError, subprocess.SubprocessError):
            pass
        _tried = True
    return _lib
