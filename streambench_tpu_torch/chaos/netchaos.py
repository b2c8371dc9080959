"""Seeded network chaos for the pub/sub query plane.

The port's copy of ``streambench_tpu/chaos/netchaos.py`` (host code, no
torch): the same proxy drawing the same faults from one plan.

:class:`ChaosPubSub` is a TCP proxy that sits between pub/sub clients
(queries, the reach router) and a ``dimensions.pubsub`` server,
injecting the plan's scheduled message faults into BOTH directions of
the JSON-lines transport:

- ``drop``  — the message vanishes (also every message inside a
  ``partition_windows`` index window: a full partition);
- ``delay`` — the message (and, realistically, everything queued
  behind it on that connection) is held ``net_delay_ms``;
- ``dup``   — the message is forwarded twice — the duplicated-reply /
  retried-request case the server-side request-id dedup and the
  client's id-matched receive loop must absorb;
- ``torn``  — the frame is damaged in flight: the line's tail is
  NUL-smashed with the newline kept, so the receiver sees exactly one
  undecodable line (the message is lost WITHOUT desyncing the framing
  — a receiver that drops garbage lines resyncs on the next message).

Faults are drawn from the shared :class:`FaultInjector`'s GLOBAL
message index (``net_fault()``), so one seeded plan spans every proxied
replica in a fleet and supervised restarts continue the plan rather
than replaying it.  A proxy built without an injector (or over an empty
plan) is a byte-exact pass-through — pinned by the tier-1 test.

Scope: the JSON-lines transport only (``PubSubClient``).  The
WebSocket transport frames messages in binary and would need
frame-aware splitting; every fleet component routes through
JSON lines, so the proxy meets the chaos layer where the traffic is.
"""

from __future__ import annotations

import socket
import threading
import time

#: how much of a torn line survives (the rest is NUL-smashed)
_TORN_KEEP = 0.5


class ChaosPubSub:
    """Fault-injecting TCP proxy in front of one pub/sub endpoint.

    ``upstream`` is ``(host, port)`` of the real server; the proxy
    listens on ``host:port`` (port 0 = ephemeral) and ``address`` is
    what clients should dial.  One proxy per replica endpoint; share
    one injector across the fleet so the plan's message index is
    global.
    """

    def __init__(self, upstream: tuple, injector=None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 name: str = ""):
        self.upstream = (str(upstream[0]), int(upstream[1]))
        self.injector = injector
        self.name = name
        self.stats = {"msgs": 0, "dropped": 0, "delayed": 0,
                      "dupped": 0, "torn": 0, "conns": 0}
        self._lock = threading.Lock()
        self._conns: set = set()
        self._closed = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(32)
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name=f"chaos-pubsub{name}")

    @property
    def address(self) -> tuple:
        return self._srv.getsockname()[:2]

    def start(self) -> "ChaosPubSub":
        self._thread.start()
        return self

    # -- wiring --------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                client, _ = self._srv.accept()
            except OSError:
                return
            try:
                up = socket.create_connection(self.upstream,
                                              timeout=10.0)
                up.settimeout(None)
            except OSError:
                client.close()
                continue
            with self._lock:
                if self._closed:
                    client.close()
                    up.close()
                    return
                self._conns.update((client, up))
                self.stats["conns"] += 1
            for src, dst in ((client, up), (up, client)):
                threading.Thread(target=self._pump, args=(src, dst),
                                 daemon=True,
                                 name=f"chaos-pump{self.name}").start()

    def _pump(self, src: socket.socket, dst: socket.socket) -> None:
        """One direction: split the byte stream into newline-framed
        messages and forward each through the fault draw.  A partial
        line at EOF is discarded (the peer died mid-frame)."""
        buf = b""
        try:
            while True:
                try:
                    chunk = src.recv(65536)
                except OSError:
                    break
                if not chunk:
                    break
                buf += chunk
                while True:
                    line, sep, rest = buf.partition(b"\n")
                    if not sep:
                        break
                    buf = rest
                    if not self._forward(line + b"\n", dst):
                        return
        finally:
            self._drop_conn(src)
            self._drop_conn(dst)

    def _forward(self, data: bytes, dst: socket.socket) -> bool:
        self.stats["msgs"] += 1
        kind = (self.injector.net_fault()
                if self.injector is not None else None)
        if kind == "drop":
            self.stats["dropped"] += 1
            return True
        if kind == "delay":
            self.stats["delayed"] += 1
            time.sleep(self.injector.net_delay_s)
        elif kind == "torn":
            self.stats["torn"] += 1
            keep = max(int((len(data) - 1) * _TORN_KEEP), 1)
            data = (data[:keep]
                    + b"\x00" * (len(data) - keep - 1) + b"\n")
        try:
            dst.sendall(data)
            if kind == "dup":
                self.stats["dupped"] += 1
                dst.sendall(data)
        except OSError:
            return False
        return True

    def _drop_conn(self, sock: socket.socket) -> None:
        with self._lock:
            self._conns.discard(sock)
        try:
            sock.close()
        except OSError:
            pass

    def drop_conns(self) -> int:
        """Sever every live proxied connection WITHOUT closing the
        listener — the wire-level view of a replica dying: established
        clients see EOF/reset and must re-dial, and whether the re-dial
        lands depends on whether anything answers upstream.  Returns
        the number of sockets severed."""
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for s in conns:
            try:
                s.close()
            except OSError:
                pass
        return len(conns)

    # -- lifecycle -----------------------------------------------------
    def summary(self) -> dict:
        out = dict(self.stats)
        out["upstream"] = "%s:%d" % self.upstream
        return out

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for s in conns:
            try:
                s.close()
            except OSError:
                pass
