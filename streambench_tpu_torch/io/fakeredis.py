"""Hermetic in-process Redis: a data store plus a real RESP socket server.

The reference needs a live ``redis-server`` for every run
(``stream-bench.sh:180-187`` downloads and compiles one).  For hermetic tests
and single-process benchmark runs we provide the same command surface two
ways:

- ``FakeRedisStore`` — the data structures + command dispatch, callable
  in-process (zero-copy path used by the engine when configured with
  ``redis.host: ":inprocess:"``);
- ``FakeRedisServer`` — a threaded TCP server speaking RESP2 on a real
  socket, so ``RespClient`` and the wire protocol are exercised for real in
  tests (the same embedded-cluster trick the reference uses with Apex
  ``LocalMode``, ``ApplicationWithDCWithoutDeserializerTest.java:19-45``).

Only the commands the benchmark uses are implemented; unknown commands
return a RESP error, like real Redis.
"""

from __future__ import annotations

import ctypes
import socketserver
import threading
from typing import Any

from streambench_tpu_torch.io.resp import _Reader, RespError


def _s(v: Any) -> str:
    return v.decode("utf-8") if isinstance(v, bytes) else str(v)


_M64 = (1 << 64) - 1


def _fnv1a64(s: str) -> int:
    h = 0xcbf29ce484222325
    for c in s.encode("utf-8"):
        h = ((h ^ c) * 0x100000001b3) & _M64
    return h


def _mix64(z: int) -> int:
    z = ((z ^ (z >> 30)) * 0xbf58476d1ce4e5b9) & _M64
    z = ((z ^ (z >> 27)) * 0x94d049bb133111eb) & _M64
    return z ^ (z >> 31)


def window_digest_of(rows) -> dict:
    """``{"windows", "seen", "digest"}`` of ``(campaign, window_ts,
    seen_count)`` rows: their number, the total of their counts and an
    order-independent 64-bit digest (the sum of one mixed hash a row,
    FNV-1a and splitmix64's finalizer, as ``native/store.cpp`` computes
    it).  Two stores with the same windows and counts have the same
    digest; a window moved, added, dropped or miscounted changes it."""
    n = seen = digest = 0
    ts_hash: dict = {}      # a window start recurs across campaigns
    for campaign, ts, count in rows:
        count = int(count)
        n += 1
        seen += count
        h = ts_hash.get(ts)
        if h is None:
            h = ts_hash[ts] = _fnv1a64(str(ts))
        digest = (digest + _mix64(_fnv1a64(campaign) ^ _mix64(
            h ^ _mix64(count & _M64)))) & _M64
    return {"windows": n, "seen": seen, "digest": f"{digest:016x}"}


class FakeRedisStore:
    """Dict-backed implementation of the YSB Redis command surface."""

    def __init__(self) -> None:
        self._strings: dict[str, str] = {}
        self._hashes: dict[str, dict[str, str]] = {}
        self._sets: dict[str, set[str]] = {}
        self._lists: dict[str, list[str]] = {}
        self._lock = threading.RLock()

    # ---- command handlers (names match Redis commands) ----
    def ping(self) -> str:
        return "PONG"

    def flushall(self) -> str:
        with self._lock:
            self._strings.clear()
            self._hashes.clear()
            self._sets.clear()
            self._lists.clear()
        return "OK"

    def set(self, key: str, value: str) -> str:
        with self._lock:
            self._check_type(key, self._strings)
            self._strings[key] = value
        return "OK"

    def get(self, key: str) -> str | None:
        with self._lock:
            self._check_type(key, self._strings)
            return self._strings.get(key)

    def sadd(self, key: str, *members: str) -> int:
        with self._lock:
            self._check_type(key, self._sets)
            s = self._sets.setdefault(key, set())
            n = len(s)
            s.update(members)
            return len(s) - n

    def smembers(self, key: str) -> list[str]:
        with self._lock:
            self._check_type(key, self._sets)
            return sorted(self._sets.get(key, set()))

    def hset(self, key: str, field: str, value: str, *more: str) -> int:
        """HSET with the (Redis >= 4.0) multi-field form: additional
        field/value pairs in ``more``."""
        if len(more) % 2:
            raise RespError("ERR wrong number of arguments for 'hset'")
        with self._lock:
            self._check_type(key, self._hashes)
            h = self._hashes.setdefault(key, {})
            new = 0 if field in h else 1
            h[field] = value
            for i in range(0, len(more), 2):
                if more[i] not in h:
                    new += 1
                h[more[i]] = more[i + 1]
            return new

    def hget(self, key: str, field: str) -> str | None:
        with self._lock:
            self._check_type(key, self._hashes)
            return self._hashes.get(key, {}).get(field)

    def hdel(self, key: str, *fields: str) -> int:
        with self._lock:
            self._check_type(key, self._hashes)
            h = self._hashes.get(key, {})
            removed = 0
            for f in fields:
                if f in h:
                    del h[f]
                    removed += 1
            if not h and key in self._hashes:
                del self._hashes[key]
            return removed

    def hgetall(self, key: str) -> list[str]:
        with self._lock:
            self._check_type(key, self._hashes)
            out: list[str] = []
            for k, v in self._hashes.get(key, {}).items():
                out.extend((k, v))
            return out

    def hincrby(self, key: str, field: str, amount: str) -> int:
        with self._lock:
            self._check_type(key, self._hashes)
            h = self._hashes.setdefault(key, {})
            cur = h.get(field, "0")
            try:
                nxt = int(cur) + int(amount)
            except ValueError:
                raise RespError("ERR hash value is not an integer")
            h[field] = str(nxt)
            return nxt

    def lpush(self, key: str, *values: str) -> int:
        with self._lock:
            self._check_type(key, self._lists)
            lst = self._lists.setdefault(key, [])
            for v in values:
                lst.insert(0, v)
            return len(lst)

    def llen(self, key: str) -> int:
        with self._lock:
            self._check_type(key, self._lists)
            return len(self._lists.get(key, []))

    def lrange(self, key: str, start: str, stop: str) -> list[str]:
        with self._lock:
            self._check_type(key, self._lists)
            lst = self._lists.get(key, [])
            i, j = int(start), int(stop)
            n = len(lst)
            if i < 0:
                i += n
            if j < 0:
                j += n
            # Redis LRANGE stop is inclusive; clamp like Redis does.
            i = max(i, 0)
            j = min(j, n - 1)
            if i > j:
                return []
            return lst[i : j + 1]

    # ---- plumbing ----
    def window_digest(self) -> dict:
        """``window_digest_of`` every canonical window row in the store:
        each hash field (campaign, window ts) whose value names a hash
        holding an integer ``seen_count``."""
        with self._lock:
            rows = []
            for key, h in self._hashes.items():
                for field, val in h.items():
                    if field == "windows":
                        continue
                    seen = self._hashes.get(val, {}).get("seen_count")
                    try:
                        rows.append((key, field, int(seen)))
                    except (TypeError, ValueError):
                        continue
        return window_digest_of(rows)

    def _check_type(self, key: str, owner: dict) -> None:
        holders = (self._strings, self._hashes, self._sets, self._lists)
        for h in holders:
            if h is not owner and key in h:
                raise RespError(
                    "WRONGTYPE Operation against a key holding the wrong "
                    "kind of value"
                )

    def dispatch(self, args: list[Any]) -> Any:
        if not args:
            raise RespError("ERR empty command")
        name = _s(args[0]).lower()
        handler = getattr(self, name, None)
        if handler is None or name.startswith("_"):
            raise RespError(f"ERR unknown command '{_s(args[0])}'")
        try:
            return handler(*[_s(a) for a in args[1:]])
        except TypeError as e:
            raise RespError(f"ERR wrong number of arguments: {e}")


def _parse_resp(buf: bytes, pos: int = 0):
    """Parse ONE RESP2 reply from ``buf[pos:]`` -> (value, next_pos).

    Deliberately NOT ``resp._Reader``: the in-process store needs str
    values (``_Reader`` yields bulk strings as bytes, matching the socket
    client's contract) and errors as VALUES so pipeline callers can keep
    them in-list instead of aborting (``RespClient.pipeline_execute``
    semantics); a byte-for-byte reuse would need a transform layer larger
    than this parser.  Covers the same RESP2 shapes _Reader does,
    including nil bulk ($-1) and null array (*-1).
    """
    kind = buf[pos:pos + 1]
    end = buf.index(b"\r\n", pos)
    head = buf[pos + 1:end]
    pos = end + 2
    if kind == b"+":
        return head.decode(), pos
    if kind == b"-":
        return RespError(head.decode()), pos
    if kind == b":":
        return int(head), pos
    if kind == b"$":
        n = int(head)
        if n < 0:
            return None, pos
        val = buf[pos:pos + n].decode("utf-8")
        return val, pos + n + 2
    if kind == b"*":
        n = int(head)
        if n < 0:
            return None, pos
        out = []
        for _ in range(n):
            v, pos = _parse_resp(buf, pos)
            out.append(v)
        return out, pos
    raise ValueError(f"bad RESP reply at {pos}: {buf[pos:pos+16]!r}")


class NativeRedisStore(FakeRedisStore):
    """The same store, implemented in C (native/store.cpp).

    Same command surface and RESP reply shapes as the Python
    implementation (differential-tested), plus ``write_windows_bulk`` —
    the canonical window writeback executed natively at ~100 ns/row,
    which removes the largest remaining host cost in the catchup
    pipeline.  Subclasses ``FakeRedisStore`` so every isinstance check,
    adapter, and the RESP TCP server work unchanged; the Python dict
    state of the base class is simply never used.
    """

    def __init__(self, lib) -> None:
        # deliberately NOT calling super().__init__: state lives in C
        self._lib = lib
        self._h = lib.sbr_new()
        self._buf = ctypes.create_string_buffer(1 << 16)
        # The reply buffer is shared across calls; the TCP server runs
        # one handler thread per client, so command execution + reply
        # extraction must be atomic (the C store has its own mutex, but
        # that doesn't protect this Python-side buffer).
        self._cmd_lock = threading.Lock()

    def __del__(self):  # pragma: no cover - teardown order
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_h", None)
        if lib is not None and h:
            lib.sbr_free(h)
            self._h = None

    def _cmd(self, *args):
        argv = (ctypes.c_char_p * len(args))()
        lens = (ctypes.c_int64 * len(args))()
        keep = []  # keep encoded bytes alive for the call
        for i, a in enumerate(args):
            b = (a if isinstance(a, bytes)
                 else str(a).encode("utf-8"))
            keep.append(b)
            argv[i] = b
            lens[i] = len(b)
        with self._cmd_lock:
            while True:
                n = self._lib.sbr_cmd(self._h, len(args), argv, lens,
                                      self._buf, len(self._buf))
                if n >= 0:
                    break
                # reply larger than the buffer: grow and re-issue (safe:
                # only read-only commands have unbounded replies).  Loop,
                # not a single retry — another thread's write can grow
                # the same structure between the two calls.
                self._buf = ctypes.create_string_buffer(-n + 256)
            # string_at copies the n reply bytes; ``.raw[:n]`` would copy
            # the whole buffer, which one large reply (SMEMBERS of 1e6
            # campaigns) grows to tens of MB for every later command
            reply = ctypes.string_at(self._buf, n)
        val, _ = _parse_resp(reply)
        if isinstance(val, RespError):
            raise val
        return val

    # ---- command surface (mirrors the Python impl) ----
    def ping(self):
        return self._cmd("PING")

    def flushall(self):
        return self._cmd("FLUSHALL")

    def set(self, key, value):
        return self._cmd("SET", key, value)

    def get(self, key):
        return self._cmd("GET", key)

    def sadd(self, key, *members):
        return self._cmd("SADD", key, *members)

    def smembers(self, key):
        return self._cmd("SMEMBERS", key)

    def hset(self, key, field, value, *more):
        return self._cmd("HSET", key, field, value, *more)

    def hget(self, key, field):
        return self._cmd("HGET", key, field)

    def hdel(self, key, *fields):
        return self._cmd("HDEL", key, *fields)

    def hgetall(self, key):
        return self._cmd("HGETALL", key)

    def hincrby(self, key, field, amount):
        return self._cmd("HINCRBY", key, field, amount)

    def lpush(self, key, *values):
        return self._cmd("LPUSH", key, *values)

    def llen(self, key):
        return self._cmd("LLEN", key)

    def lrange(self, key, start, stop):
        return self._cmd("LRANGE", key, start, stop)

    def dispatch(self, args: list[Any]) -> Any:
        if not args:
            raise RespError("ERR empty command")
        return self._cmd(*args)

    # ---- native bulk writeback (redis_schema.write_windows_pipelined) --
    def window_digest(self) -> dict:
        out = (ctypes.c_int64 * 3)()
        with self._cmd_lock:
            self._lib.sbr_window_digest(self._h, out)
        return {"windows": int(out[0]), "seen": int(out[1]),
                "digest": f"{out[2] & 0xFFFFFFFFFFFFFFFF:016x}"}

    def write_windows_bulk(self, rows, stamp: str, absolute: bool) -> int:
        """Canonical-schema writeback of ``(campaign, wts, count)`` rows
        in one native call; observable state identical to issuing the
        HGET/HSET/LPUSH/HINCRBY sequence per row."""
        n = len(rows)
        if n == 0:
            return 0
        camp_off = (ctypes.c_int64 * (n + 1))()
        ts_off = (ctypes.c_int64 * (n + 1))()
        counts = (ctypes.c_int64 * n)()
        camps = []
        tss = []
        co = to = 0
        for i, (c, w, cnt) in enumerate(rows):
            cb = c.encode()
            wb = w.encode() if isinstance(w, str) else str(w).encode()
            camps.append(cb)
            tss.append(wb)
            camp_off[i] = co
            ts_off[i] = to
            co += len(cb)
            to += len(wb)
            counts[i] = cnt
        camp_off[n] = co
        ts_off[n] = to
        sb = stamp.encode()
        rc = self._lib.sbr_write_windows(
            self._h, n, b"".join(camps), camp_off, b"".join(tss), ts_off,
            counts, sb, len(sb), 1 if absolute else 0)
        if rc < 0:
            raise RespError("WRONGTYPE Operation against a key holding "
                            "the wrong kind of value")
        return int(rc)

    def write_windows_arrays(self, names_blob: bytes, names_off,
                             ci, ts, counts, stamp: str,
                             absolute: bool) -> int:
        """Index-form bulk writeback: campaign table once (blob +
        int64 offsets, len C+1), rows as numpy int32 ``ci`` / int64
        ``ts``/``counts`` arrays — the engine flush path, zero per-row
        Python work."""
        import ctypes as _c

        import numpy as _np

        n = int(ci.shape[0])
        if n == 0:
            return 0
        ci = _np.ascontiguousarray(ci, _np.int32)
        ts = _np.ascontiguousarray(ts, _np.int64)
        counts = _np.ascontiguousarray(counts, _np.int64)
        sb = stamp.encode()
        rc = self._lib.sbr_write_windows_idx(
            self._h, n, names_blob,
            names_off.ctypes.data_as(_c.POINTER(_c.c_int64)),
            int(names_off.shape[0]) - 1,
            ci.ctypes.data_as(_c.POINTER(_c.c_int32)),
            ts.ctypes.data_as(_c.POINTER(_c.c_int64)),
            counts.ctypes.data_as(_c.POINTER(_c.c_int64)),
            sb, len(sb), 1 if absolute else 0)
        if rc == -2:
            raise ValueError("campaign index out of range")
        if rc < 0:
            raise RespError("WRONGTYPE Operation against a key holding "
                            "the wrong kind of value")
        return int(rc)


def make_store() -> FakeRedisStore:
    """The native C store when the library is available, else the
    pure-Python one — same observable behavior either way."""
    from streambench_tpu_torch import native

    lib = native.load()
    if lib is not None:
        return NativeRedisStore(lib)
    return FakeRedisStore()


def _encode_reply(v: Any) -> bytes:
    if v is None:
        return b"$-1\r\n"
    if isinstance(v, int):
        return b":%d\r\n" % v
    if isinstance(v, str):
        if v in ("OK", "PONG"):
            return b"+%s\r\n" % v.encode()
        b = v.encode("utf-8")
        return b"$%d\r\n%s\r\n" % (len(b), b)
    if isinstance(v, (list, tuple)):
        return b"*%d\r\n" % len(v) + b"".join(_encode_reply(x) for x in v)
    raise TypeError(f"cannot encode reply: {v!r}")


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        reader = _Reader(self.request.recv)
        store: FakeRedisStore = self.server.store  # type: ignore[attr-defined]
        while True:
            try:
                cmd = reader.read_reply()
            except (ConnectionError, OSError):
                return
            try:
                reply = _encode_reply(store.dispatch(cmd))
            except RespError as e:
                reply = b"-%s\r\n" % str(e).encode("utf-8")
            try:
                self.request.sendall(reply)
            except OSError:
                return


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class FakeRedisServer:
    """RESP2 socket server around a ``FakeRedisStore``.

    Use as a context manager; ``port`` is OS-assigned so tests never collide.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 store: FakeRedisStore | None = None):
        self.store = store if store is not None else make_store()
        self._server = _Server((host, port), _Handler)
        self._server.store = self.store  # type: ignore[attr-defined]
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True, name="fake-redis",
        )

    def start(self) -> "FakeRedisServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "FakeRedisServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv: list[str] | None = None) -> int:
    """Run the server as a standalone process — the harness's
    ``redis-server`` stand-in (``start_if_needed redis-server``,
    ``stream-bench.sh:180-187``).  Exits cleanly on SIGTERM/SIGINT."""
    import argparse
    import signal

    p = argparse.ArgumentParser(prog="streambench-redis")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6379)
    args = p.parse_args(argv)
    srv = FakeRedisServer(args.host, args.port).start()
    print(f"ready {srv.host}:{srv.port}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
