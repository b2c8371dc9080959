"""Build-at-first-use for the port's shared libraries (host C++ and CUDA).

Libraries are compiled into ``build/streambench_tpu_torch/`` beside the
package (a directory ``.gitignore`` lists), never next to the sources, and
are named by a hash of their sources and compile command, so an edited
source builds a fresh library instead of loading a stale one.

Safe under concurrent first use (pytest-xdist workers, several engines):
one process builds behind an exclusive file lock, into a temporary name
that ``os.replace`` publishes atomically; the others wait on the lock and
then find the finished library.

Each compiler run is reported to the listeners of ``add_build_listener``
(``obs.occupancy.CompileWatcher`` counts them): the port's only compile
at first use, so a warmed run must report none.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import time
from typing import Callable, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "streambench_tpu_torch")
# ``fn(name, seconds)`` called after every successful compiler run;
# process-wide, as the builds are
_build_listeners: set = set()


def add_build_listener(fn) -> None:
    _build_listeners.add(fn)


def remove_build_listener(fn) -> None:
    _build_listeners.discard(fn)


class BuildError(RuntimeError):
    """A compiler run failed; the message carries its output."""


def build_library(name: str, sources: Sequence[str],
                  command: Callable[[str], list[str]],
                  timeout_s: float = 900.0) -> str:
    """Return the path of ``lib<name>-<hash>.so``, compiling it if absent.

    ``command(out_path)`` gives the compiler argv that writes the library
    to ``out_path``; the compiler's output is kept beside the library as
    ``<library>.log``.  Raises ``BuildError`` when the compiler fails and
    ``OSError`` when it cannot be started."""
    digest = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    digest.update("\0".join(command("OUT")).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):     # another process built it meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            t0 = time.perf_counter()
            proc = subprocess.run(command(tmp), capture_output=True,
                                  text=True, timeout=timeout_s)
            if proc.returncode != 0:
                raise BuildError(
                    f"building {name} failed (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            with open(out + ".log", "w") as log:
                log.write(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    for fn in list(_build_listeners):
        fn(name, time.perf_counter() - t0)
    return out
