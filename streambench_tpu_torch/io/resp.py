"""Pure-Python Redis (RESP2) client.

The reference talks to Redis through Jedis (Java), sedis (Scala) and
redis-clojure; this environment has no Redis client library, so the framework
carries its own minimal RESP2 implementation.  It covers exactly the command
surface the benchmark uses (see the canonical schema users:
``AdvertisingSpark.scala:184-208`` writer, ``data/src/setup/core.clj:130-149``
reader, ``AdvertisingTopologyNative.java:521-532`` latency dump,
``RedisHelper.java:64-78`` seeding) plus pipelining, which is the host-side
throughput lever the JVM engines got from connection pools.

The client is deliberately transport-only: schema knowledge lives in
``streambench_tpu_torch.io.redis_schema``.
"""

from __future__ import annotations

import socket
from typing import Any, Iterable


class RespError(RuntimeError):
    """A Redis server-side error reply (RESP ``-ERR ...``)."""


def encode_command(*args: Any) -> bytes:
    """Encode one command as a RESP array of bulk strings."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, bytes):
            b = a
        elif isinstance(a, str):
            b = a.encode("utf-8")
        elif isinstance(a, (int, float)):
            b = repr(a).encode("ascii") if isinstance(a, float) else b"%d" % a
        else:
            raise TypeError(f"unsupported RESP argument type: {type(a)!r}")
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


class _Reader:
    """Buffered RESP reply parser over a byte stream."""

    def __init__(self, recv):
        self._recv = recv
        self._buf = b""

    def _fill(self) -> None:
        chunk = self._recv(65536)
        if not chunk:
            raise ConnectionError("connection closed by Redis server")
        self._buf += chunk

    def read_line(self) -> bytes:
        while True:
            i = self._buf.find(b"\r\n")
            if i >= 0:
                line, self._buf = self._buf[:i], self._buf[i + 2 :]
                return line
            self._fill()

    def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            self._fill()
        data, self._buf = self._buf[:n], self._buf[n + 2 :]
        return data

    def read_reply(self) -> Any:
        line = self.read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode("utf-8")
        if kind == b"-":
            raise RespError(rest.decode("utf-8"))
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            return self.read_exact(n)
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self.read_reply() for _ in range(n)]
        raise RespError(f"unknown RESP reply type: {line!r}")


def _text(v: Any) -> Any:
    """Decode bulk-string replies to str (Jedis-like convenience)."""
    if isinstance(v, bytes):
        return v.decode("utf-8")
    if isinstance(v, list):
        return [_text(x) for x in v]
    return v


class RespClient:
    """A blocking RESP2 client with explicit pipelining.

    ``execute`` is one round-trip; ``pipeline`` batches commands and reads
    all replies at once — the flusher uses this so one window flush is one
    round trip no matter how many dirty windows there are (the reference's
    per-window round trips at ``AdvertisingSpark.scala:189-205`` are its
    writeback bottleneck; pipelining is our first free win).
    """

    def __init__(self, host: str = "localhost", port: int = 6379,
                 timeout_s: float | None = 30.0):
        self._addr = (host, port)
        self._timeout_s = timeout_s
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader = _Reader(self._sock.recv)

    def reconnect(self) -> None:
        """Drop the socket and dial again (sink-outage recovery: after a
        half-open connection or a server restart the old socket can hang
        every command until its timeout; a fresh dial fails fast or
        works).  Any buffered partial reply dies with the old reader —
        reusing it would desynchronize the RESP stream."""
        self.close()
        self._sock = socket.create_connection(self._addr,
                                              timeout=self._timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader = _Reader(self._sock.recv)

    # -- single command ------------------------------------------------
    def execute(self, *args: Any) -> Any:
        self._sock.sendall(encode_command(*args))
        return _text(self._reader.read_reply())

    # -- pipelining ----------------------------------------------------
    def pipeline_execute(self, commands: Iterable[tuple]) -> list[Any]:
        cmds = list(commands)
        if not cmds:
            return []
        self._sock.sendall(b"".join(encode_command(*c) for c in cmds))
        replies = []
        for _ in cmds:
            try:
                replies.append(_text(self._reader.read_reply()))
            except RespError as e:
                replies.append(e)
        return replies

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "RespClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- convenience wrappers (the YSB command surface) ---------------
    def ping(self) -> str:
        return self.execute("PING")

    def flushall(self) -> str:
        return self.execute("FLUSHALL")

    def set(self, key: str, value: str) -> str:
        return self.execute("SET", key, value)

    def get(self, key: str) -> str | None:
        return self.execute("GET", key)

    def sadd(self, key: str, *members: str) -> int:
        return self.execute("SADD", key, *members)

    def smembers(self, key: str) -> list[str]:
        return self.execute("SMEMBERS", key)

    def hset(self, key: str, field: str, value: Any) -> int:
        return self.execute("HSET", key, field, value)

    def hget(self, key: str, field: str) -> str | None:
        return self.execute("HGET", key, field)

    def hgetall(self, key: str) -> dict[str, str]:
        flat = self.execute("HGETALL", key)
        return dict(zip(flat[0::2], flat[1::2]))

    def hincrby(self, key: str, field: str, amount: int) -> int:
        return self.execute("HINCRBY", key, field, amount)

    def lpush(self, key: str, *values: str) -> int:
        return self.execute("LPUSH", key, *values)

    def llen(self, key: str) -> int:
        return self.execute("LLEN", key)

    def lrange(self, key: str, start: int, stop: int) -> list[str]:
        return self.execute("LRANGE", key, start, stop)
