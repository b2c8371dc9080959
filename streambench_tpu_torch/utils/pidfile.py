"""Recycled-pid-safe pidfiles in the ``<pid> <starttime>`` format.

A pidfile records the kernel start time (``/proc/<pid>/stat`` field 22)
next to the pid, so liveness checks and STOP paths can tell a recycled
pid (same number, different process) from the process they actually
started, and never signal a stranger.  The port's harness
(``streambench_tpu_torch.harness``) keeps its services' pidfiles in this
format; a role that must not run twice takes its slot with
``acquire_pidfile`` and gives it back with ``release_pidfile``.
"""

from __future__ import annotations

import os


def proc_starttime(pid: int) -> str | None:
    """Kernel start time of ``pid`` (/proc stat field 22), or None
    when the process doesn't exist.  Parsed from after the LAST ')' —
    comm may contain parens and spaces."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[19]
    except (OSError, IndexError):
        return None


def read_pidfile(path: str) -> "tuple[int, str | None] | None":
    """``(pid, starttime_or_None)`` from a pidfile, or None when the
    file is missing/unparseable."""
    try:
        with open(path) as f:
            parts = f.read().split()
    except OSError:
        return None
    if not parts:
        return None
    try:
        pid = int(parts[0])
    except ValueError:
        return None
    return pid, (parts[1] if len(parts) > 1 else None)


def pidfile_alive(path: str) -> int | None:
    """The live pid a pidfile names, or None.  A starttime mismatch is
    a RECYCLED pid — a different process entirely — and reports dead;
    a pre-starttime pidfile (no second field) falls back to a bare
    existence check."""
    rec = read_pidfile(path)
    if rec is None:
        return None
    pid, started = rec
    now_started = proc_starttime(pid)
    if now_started is None:
        return None
    if started is not None and now_started != started:
        return None
    return pid


def acquire_pidfile(path: str, pid: int | None = None) -> int | None:
    """Write ``<pid> <starttime>`` to ``path``; returns the pid, or
    None (refusal) when the file already names a live process — two
    replicas must never share a slot.  A stale file (dead or recycled
    pid) is overwritten."""
    if pidfile_alive(path) is not None:
        return None
    pid = os.getpid() if pid is None else int(pid)
    started = proc_starttime(pid)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{pid} {started}" if started else str(pid))
    os.replace(tmp, path)
    return pid


def release_pidfile(path: str) -> None:
    """Remove the pidfile IF it still names this process (a successor
    that already took the slot keeps its file)."""
    rec = read_pidfile(path)
    if rec is not None and rec[0] != os.getpid():
        return
    try:
        os.remove(path)
    except OSError:
        pass
