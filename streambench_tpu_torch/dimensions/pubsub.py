"""Pub/sub query channel: WebSocket endpoint + JSON-lines fallback.

The Apex reference exposes live aggregate queries through a gateway
pub/sub endpoint (``ws://<gateway>/pubsub``, built by
``ConfigUtil.java:22-34``, wired as PubSubWebSocketAppData query/result
operators, ``ApplicationDimensionComputation.java:236-259``).  One TCP
server here speaks BOTH transports on the same port, sniffed from the
first bytes of each connection:

- a ``GET /pubsub ...`` HTTP request upgrades to a real RFC 6455
  WebSocket (handshake + masked client frames + ping/pong/close), the
  reference's wire protocol;
- anything else is treated as newline-delimited JSON over the raw
  socket (the hermetic/test transport — no handshake round trip).

The message contract is the gateway pub/sub protocol on either
transport:

- client -> server: ``{"type": "subscribe", "topic": T}`` (repeatable),
  ``{"type": "unsubscribe", "topic": T}``,
  ``{"type": "publish", "topic": T, "data": ...}``
- server -> subscriber: ``{"type": "data", "topic": T, "data": ...}``

Slow consumers are disconnected rather than allowed to backpressure the
engine (send buffers are bounded) — queries must never stall aggregation.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import socketserver
import struct
import threading
import time
from collections import deque

_WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

#: request() keeps at most this many in-flight send stamps per client
#: (latency_split pops them; an abandoned query must not grow memory)
MAX_INFLIGHT_STAMPS = 4096


class _LatencySplitMixin:
    """Client-side half of the query-path decomposition:
    ``request()`` stamps each outgoing query's send time; when the
    answer carries the server-side ``server`` block (the reach server
    includes it under ``jax.obs.query``), ``latency_split`` divides the
    measured round trip into server-vs-network halves — the piece no
    server-side histogram can see."""

    def _note_request(self, msg: dict) -> None:
        stamps = getattr(self, "_inflight", None)
        if stamps is None:
            stamps = self._inflight = {}
        qid = msg.get("id")
        if qid is None:
            return
        while len(stamps) >= MAX_INFLIGHT_STAMPS:
            stamps.pop(next(iter(stamps)))
        stamps[qid] = time.monotonic()

    def latency_split(self, data: dict) -> "dict | None":
        """Split one answered query's round trip.  ``data`` is the
        payload ``recv()`` returned (the ``"data"`` member of the data
        message).  Returns ``{"rtt_ms", "server_ms", "network_ms"}``
        when the reply carries the server decomposition, ``{"rtt_ms"}``
        when it does not (query obs off server-side), or None when the
        answer's id was never stamped by ``request()``."""
        stamps = getattr(self, "_inflight", None)
        t0 = stamps.pop(data.get("id"), None) if stamps else None
        if t0 is None:
            return None
        rtt_ms = (time.monotonic() - t0) * 1000.0
        out = {"rtt_ms": round(rtt_ms, 3)}
        server = data.get("server")
        if isinstance(server, dict) and isinstance(
                server.get("total_ms"), (int, float)):
            out["server_ms"] = server["total_ms"]
            out["network_ms"] = round(
                max(rtt_ms - server["total_ms"], 0.0), 3)
        return out


def query_uri(host: str, port: int) -> str:
    """The reference's query endpoint shape (``ConfigUtil.java:22-34``)."""
    return f"ws://{host}:{port}/pubsub"


def _ws_accept(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1(key.encode() + _WS_GUID).digest()).decode()


def ws_encode(payload: bytes, opcode: int = 0x1, mask: bool = False,
              fin: bool = True) -> bytes:
    """One frame (FIN by default).  Servers send unmasked; clients MUST
    mask (RFC 6455 §5.1)."""
    head = bytes([(0x80 if fin else 0x00) | opcode])
    n = len(payload)
    mbit = 0x80 if mask else 0
    if n < 126:
        head += bytes([mbit | n])
    elif n < (1 << 16):
        head += bytes([mbit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([mbit | 127]) + struct.pack(">Q", n)
    if mask:
        mk = os.urandom(4)
        return head + mk + bytes(b ^ mk[i % 4]
                                 for i, b in enumerate(payload))
    return head + payload


def ws_read_frame(rfile) -> tuple[int, bytes] | None:
    """Read one frame from a BLOCKING file-like -> (opcode, payload);
    None on EOF, including mid-frame (the peer is gone either way).
    (Client/test path; the server reads frames through ``_SockStream``,
    whose buffer survives socket timeouts.)"""
    h = rfile.read(2)
    if len(h) < 2:
        return None
    opcode = h[0] & 0x0F
    masked = bool(h[1] & 0x80)
    n = h[1] & 0x7F
    if n == 126:
        ext = rfile.read(2)
        if len(ext) < 2:
            return None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = rfile.read(8)
        if len(ext) < 8:
            return None
        n = struct.unpack(">Q", ext)[0]
    mk = None
    if masked:
        mk = rfile.read(4)
        if len(mk) < 4:
            return None
    payload = rfile.read(n)
    if len(payload) < n:
        return None
    if mk:
        payload = bytes(b ^ mk[i % 4] for i, b in enumerate(payload))
    return opcode, payload


# Per-message bounds: query messages are small JSON; anything larger is
# a malformed or hostile client and the connection closes rather than
# letting it grow server memory (frame lengths are client-controlled
# 64-bit values, and fragmented messages could otherwise accumulate
# without limit).
MAX_FRAME_BYTES = 4 << 20
MAX_LINE_BYTES = 64 << 10

#: per-connection reply-queue bounds.  A consumer that falls this far
#: behind — by message count (small-payload storms) or by queued bytes
#: (fat aggregate streams) — is dropped, same policy as the old
#: synchronous send-timeout, but the DECISION no longer costs the
#: producer anything: send() enqueues and the per-connection writer
#: thread eats the socket stall.
REPLY_QUEUE_MAX = 1024
REPLY_QUEUE_MAX_BYTES = 2 << 20

#: per-connection request-id dedup window: a duplicated
#: query-verb message (net_dup, or a client retry racing its own
#: predecessor) is answered at most once per id within this many most
#: recent ids — bounded so a hostile/id-less client can't grow memory
QUERY_DEDUP_MAX = 1024


class _SockStream:
    """recv-based reader whose buffer SURVIVES socket timeouts.

    ``BufferedReader.read`` can discard already-received bytes when the
    underlying recv times out mid-request — for a framed protocol that
    desyncs the stream (a later read would parse payload bytes as a
    frame header).  Here a timeout just leaves the accumulated bytes in
    place; the caller decides whether an EMPTY-buffer timeout means
    "idle, keep listening" (frame/message boundary) or keeps waiting
    (mid-frame: the rest is in flight).
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = bytearray()
        self._eof = False

    def _fill(self) -> bool:
        """One recv into the buffer; False on EOF.  Propagates timeout."""
        if self._eof:
            return False
        chunk = self._sock.recv(65536)
        if not chunk:
            self._eof = True
            return False
        self._buf += chunk
        return True

    def readline(self) -> bytes:
        """One newline-terminated line; idle timeouts keep waiting.
        Returns b'' on EOF with an empty buffer, and b'' (dropping the
        buffer) when a "line" exceeds MAX_LINE_BYTES — callers treat
        that as a dead peer and close."""
        while b"\n" not in self._buf:
            if len(self._buf) > MAX_LINE_BYTES:
                self._buf.clear()
                self._eof = True
                return b""
            try:
                if not self._fill():
                    break
            except (TimeoutError, socket.timeout):
                continue
        i = self._buf.find(b"\n")
        end = len(self._buf) if i < 0 else i + 1
        out = bytes(self._buf[:end])
        del self._buf[:end]
        return out

    def read_exact(self, n: int, idle_raises: bool = False
                   ) -> bytes | None:
        """Exactly ``n`` bytes, or None on EOF mid-request.

        ``idle_raises``: a timeout while the buffer is EMPTY propagates
        (the caller's idle tick, only safe at a frame boundary); once
        any byte is buffered the frame is committed and timeouts keep
        waiting for the rest.
        """
        while len(self._buf) < n:
            try:
                if not self._fill():
                    return None
            except (TimeoutError, socket.timeout):
                if idle_raises and not self._buf:
                    raise
                continue
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


def read_ws_frame_stream(stream: _SockStream
                         ) -> tuple[int, bytes, bool] | None:
    """Server-side frame read over ``_SockStream``: idle timeouts at the
    frame boundary propagate; mid-frame the stream waits for the rest.
    Returns ``(opcode, payload, fin)`` or None on EOF (clean or
    mid-frame: either way the peer is gone)."""
    h = stream.read_exact(2, idle_raises=True)
    if h is None:
        return None
    fin = bool(h[0] & 0x80)
    opcode = h[0] & 0x0F
    masked = bool(h[1] & 0x80)
    n = h[1] & 0x7F
    if n == 126:
        ext = stream.read_exact(2)
        if ext is None:
            return None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = stream.read_exact(8)
        if ext is None:
            return None
        n = struct.unpack(">Q", ext)[0]
    if n > MAX_FRAME_BYTES:  # hostile/corrupt length: drop the peer
        return None
    mk = stream.read_exact(4) if masked else None
    if masked and mk is None:
        return None
    payload = stream.read_exact(n)
    if payload is None:
        return None
    if mk:
        payload = bytes(b ^ mk[i % 4] for i, b in enumerate(payload))
    return opcode, payload, fin


class _Handler(socketserver.StreamRequestHandler):
    # One shared socket timeout bounds BOTH reads (the subscribe loop
    # retries on timeout) and writes (a send that can't complete within it
    # marks the subscriber dead) — queries must never stall aggregation.
    timeout_s = 1.0

    def _ws_handshake(self, stream: _SockStream) -> bool:
        """Complete the RFC 6455 upgrade (request line already read)."""
        headers: dict[str, str] = {}
        while True:
            line = stream.readline()
            if not line or line in (b"\r\n", b"\n"):
                break
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        key = headers.get("sec-websocket-key")
        if (key is None
                or "websocket" not in headers.get("upgrade", "").lower()):
            self.connection.sendall(
                b"HTTP/1.1 400 Bad Request\r\n\r\n")
            return False
        self.connection.sendall(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Accept: " + _ws_accept(key).encode()
            + b"\r\n\r\n")
        return True

    def _messages(self, stream: _SockStream):
        """Yield decoded JSON messages from either transport."""
        try:
            yield from self._messages_inner(stream)
        except OSError:
            return  # reset/aborted connection (port scans, dead peers)

    def _messages_inner(self, stream: _SockStream):
        first = stream.readline()  # idle-tolerant: waits for a client
        if not first:
            return
        if first.startswith(b"GET "):
            if not self._ws_handshake(stream):
                return
            self.ws = True
            fragments = b""  # FIN=0 fragments awaiting continuation
            fragmented = False
            while True:
                try:
                    frame = read_ws_frame_stream(stream)
                except (TimeoutError, socket.timeout):
                    continue  # idle subscriber: keep listening
                except OSError:
                    return
                if frame is None:
                    return
                opcode, payload, fin = frame
                if opcode == 0x8:  # close
                    self.send_raw(ws_encode(payload, opcode=0x8))
                    return
                if opcode == 0x9:  # ping -> pong
                    self.send_raw(ws_encode(payload, opcode=0xA))
                    continue
                if opcode in (0x1, 0x2) and not fin:
                    fragments, fragmented = payload, True
                    continue
                if opcode == 0x0:  # continuation
                    if not fragmented:
                        continue  # stray continuation: drop
                    fragments += payload
                    if len(fragments) > MAX_FRAME_BYTES:
                        return  # unbounded reassembly: drop the peer
                    if not fin:
                        continue
                    payload, fragments, fragmented = fragments, b"", False
                elif opcode not in (0x1, 0x2):
                    continue
                try:
                    yield json.loads(payload)
                except json.JSONDecodeError:
                    continue
            return
        # JSON-lines transport; `first` is already a message line
        raw = first
        while True:
            if raw.strip():
                try:
                    yield json.loads(raw)
                except json.JSONDecodeError:
                    pass
            try:
                raw = stream.readline()
            except OSError:
                return
            if not raw:
                return  # client closed

    def handle(self) -> None:
        server: PubSubServer = self.server.pubsub  # type: ignore[attr-defined]
        self.connection.settimeout(self.timeout_s)
        self.ws = False
        self._wlock = threading.Lock()
        # Per-connection reply queue: send() ENQUEUES and a
        # lazily-started writer thread drains, so a slow client socket
        # blocks only its own writer — never the reach worker's reply
        # loop over a whole batch (the shed-reply-under-cv-lock
        # bug, one layer down: the old path serialized every reply
        # through a bounded-but-BLOCKING sendall on the caller).
        self._rq: deque = deque()
        self._rq_bytes = 0
        self._rq_cv = threading.Condition()
        self._rq_dead = False
        self._rq_thread: threading.Thread | None = None
        # request-id dedup window: ids this connection has
        # already routed to a query verb; duplicates are dropped so
        # net_dup / client retries stay exactly-once-answered
        self._seen_ids: deque = deque()
        self._seen_idset: set = set()
        my_topics: set[str] = set()
        try:
            for msg in self._messages(_SockStream(self.connection)):
                if not isinstance(msg, dict):
                    continue  # '5' / '[1,2]' are valid JSON, not messages
                kind = msg.get("type")
                qfn = server._query_handler(kind)
                if qfn is not None:
                    # registered query verb (e.g. "reach"): the handler
                    # enqueues and replies LATER from its worker thread
                    # — send() serializes under _wlock, so replies can
                    # interleave with pub/sub traffic safely.  The
                    # topic defaults to the verb name; the reply rides
                    # the normal data-message shape.
                    qid = msg.get("id")
                    if isinstance(qid, (str, int)):
                        if qid in self._seen_idset:
                            continue   # duplicate delivery: answered once
                        self._seen_idset.add(qid)
                        self._seen_ids.append(qid)
                        if len(self._seen_ids) > QUERY_DEDUP_MAX:
                            self._seen_idset.discard(
                                self._seen_ids.popleft())
                    self._answer_query(server, qfn, msg,
                                       str(msg.get("topic") or kind))
                    continue
                topic = str(msg.get("topic", ""))
                if not topic:
                    continue
                if kind == "subscribe":
                    my_topics.add(topic)
                    server._subscribe(topic, self)
                elif kind == "unsubscribe":
                    my_topics.discard(topic)
                    server._unsubscribe(topic, self)
                elif kind == "publish":
                    # gateway parity: clients may publish into a topic
                    server.publish(topic, msg.get("data"))
        finally:
            with self._rq_cv:
                self._rq_dead = True
                self._rq_cv.notify()
            for t in my_topics:
                server._unsubscribe(t, self)

    def _answer_query(self, server: "PubSubServer", qfn, msg: dict,
                      topic: str) -> None:
        """Route one query-verb message; the handler's reply callback
        writes a standard data message back on THIS connection (from
        whatever thread answers).  Handler errors are contained — a bad
        query must never tear down the pub/sub connection."""

        def reply(data) -> None:
            payload = (json.dumps({"type": "data", "topic": topic,
                                   "data": data},
                                  separators=(",", ":")) + "\n").encode()
            self.send(payload)

        try:
            qfn(msg, reply)
        except Exception:
            try:
                reply({"error": "query_failed"})
            except Exception:
                pass

    def send_raw(self, data: bytes) -> bool:
        # serialize writers: the reply-writer thread drains the queue
        # while the handler thread answers pings — interleaved sendall
        # calls would corrupt websocket framing mid-frame
        with self._wlock:
            try:
                self.connection.sendall(data)
                return True
            except (TimeoutError, socket.timeout, OSError):
                return False

    def _drain_replies(self) -> None:
        """Per-connection writer: drains the reply queue in order.  A
        send that fails (timeout = the client's TCP window stayed full
        past timeout_s, or a dead socket) marks the connection dead and
        drops the backlog — exactly the old synchronous policy, minus
        the producer-side stall."""
        while True:
            with self._rq_cv:
                while not self._rq and not self._rq_dead:
                    self._rq_cv.wait(timeout=1.0)
                if self._rq_dead and not self._rq:
                    return
                data = self._rq.popleft()
                self._rq_bytes -= len(data)
            if not self.send_raw(data):
                with self._rq_cv:
                    self._rq_dead = True
                    self._rq.clear()
                    self._rq_bytes = 0
                return

    def send(self, payload: bytes) -> bool:
        """Enqueue one pub/sub message for this connection's writer
        thread (started lazily at the first send).  NEVER blocks the
        caller on the client's socket: a queue past REPLY_QUEUE_MAX
        marks the consumer dead instead (publish() then drops it from
        the topic).  ``payload`` is the JSON line; websocket subscribers
        get it as one text frame.  Returns False once the connection is
        known dead — an enqueued message may still be lost to a later
        socket failure, the same at-most-once delivery the synchronous
        path had."""
        data = ws_encode(payload.rstrip(b"\n")) if self.ws else payload
        with self._rq_cv:
            if self._rq_dead:
                return False
            if (len(self._rq) >= REPLY_QUEUE_MAX
                    or self._rq_bytes + len(data)
                    > REPLY_QUEUE_MAX_BYTES):
                self._rq_dead = True
                self._rq.clear()
                self._rq_bytes = 0
                self._rq_cv.notify()
                return False
            self._rq.append(data)
            self._rq_bytes += len(data)
            if self._rq_thread is None:
                self._rq_thread = threading.Thread(
                    target=self._drain_replies, daemon=True,
                    name="pubsub-reply-writer")
                self._rq_thread.start()
            self._rq_cv.notify()
        return True


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class PubSubServer:
    """Threaded topic pub/sub over TCP JSON lines."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = _Server((host, port), _Handler)
        self._srv.pubsub = self  # type: ignore[attr-defined]
        self._subs: dict[str, set[_Handler]] = {}
        # query verbs (e.g. "reach"): message type -> fn(msg, reply);
        # the gateway's request/response half next to topic pub/sub.
        # "ping" is built in: it answers with this server's
        # wall clock so peers can estimate the cross-process clock
        # offset (obs/clock.py midpoint method) over the same socket
        # they query through; register_query may override it.
        self._queries: dict[str, object] = {"ping": self._handle_ping}
        self._lock = threading.Lock()
        self._started = False
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)

    @property
    def address(self) -> tuple[str, int]:
        return self._srv.server_address[:2]

    def start(self) -> "PubSubServer":
        self._thread.start()
        self._started = True
        return self

    @staticmethod
    def _handle_ping(msg: dict, reply) -> None:
        """Built-in clock-probe verb: one wall-clock read, echoed with
        the caller's id.  The reply rides the normal data-message shape
        on the asking connection, so the round trip measures exactly
        the path a real query's reply takes."""
        from streambench_tpu_torch.utils.ids import now_ms

        reply({"t": now_ms(), "id": msg.get("id")})

    def register_query(self, kind: str, fn) -> None:
        """Register a query verb: messages with ``type == kind`` are
        routed to ``fn(msg, reply)`` instead of the pub/sub arms.
        Reserved types (subscribe/unsubscribe/publish/data) refuse."""
        if kind in ("subscribe", "unsubscribe", "publish", "data"):
            raise ValueError(f"query verb {kind!r} shadows the pub/sub "
                             "protocol")
        with self._lock:
            self._queries[str(kind)] = fn

    def _query_handler(self, kind):
        # lock-free read: dict.get is atomic under the GIL and "ping"
        # is always registered, so taking the lock here would tax every
        # pub/sub message for the rare register_query mutation
        return self._queries.get(kind)

    def _subscribe(self, topic: str, h: _Handler) -> None:
        with self._lock:
            self._subs.setdefault(topic, set()).add(h)

    def _unsubscribe(self, topic: str, h: _Handler) -> None:
        with self._lock:
            self._subs.get(topic, set()).discard(h)

    def subscriber_count(self, topic: str) -> int:
        with self._lock:
            return len(self._subs.get(topic, ()))

    def publish(self, topic: str, data) -> int:
        """Fan a payload out to current subscribers; returns receivers.
        Dead/slow connections are dropped from the topic."""
        payload = (json.dumps({"type": "data", "topic": topic,
                               "data": data},
                              separators=(",", ":")) + "\n").encode()
        with self._lock:
            subs = list(self._subs.get(topic, ()))
        sent = 0
        for h in subs:
            if h.send(payload):
                sent += 1
            else:
                self._unsubscribe(topic, h)
        return sent

    def close(self) -> None:
        # shutdown() blocks on an ack from the serve_forever loop; if
        # start() never ran there is no loop to ack and close() would
        # hang forever (a known gotcha).  server_close() alone
        # releases the listening socket either way.
        if self._started:
            self._srv.shutdown()
        self._srv.server_close()


class WebSocketClient(_LatencySplitMixin):
    """Minimal RFC 6455 client for the ``ws://<host>:<port>/pubsub``
    endpoint (tests + CLI queries over the reference's wire protocol).
    Client frames are masked, as the RFC requires."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0,
                 path: str = "/pubsub"):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._file = self._sock.makefile("rwb")
        key = base64.b64encode(os.urandom(16)).decode()
        self._file.write(
            (f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
             f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
             f"Sec-WebSocket-Key: {key}\r\n"
             f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        self._file.flush()
        status = self._file.readline()
        if b"101" not in status:
            raise ConnectionError(f"websocket upgrade refused: {status!r}")
        expect = _ws_accept(key)
        accept = None
        while True:
            line = self._file.readline()
            if not line or line in (b"\r\n", b"\n"):
                break
            name, _, value = line.decode("latin-1").partition(":")
            if name.strip().lower() == "sec-websocket-accept":
                accept = value.strip()
        if accept != expect:
            raise ConnectionError(
                f"bad Sec-WebSocket-Accept: {accept!r} != {expect!r}")
        self._pending: list[dict] = []  # data frames that raced a pong

    def subscribe(self, topic: str) -> None:
        self._send({"type": "subscribe", "topic": topic})

    def unsubscribe(self, topic: str) -> None:
        self._send({"type": "unsubscribe", "topic": topic})

    def publish(self, topic: str, data) -> None:
        self._send({"type": "publish", "topic": topic, "data": data})

    def request(self, msg: dict) -> None:
        """Send a query-verb message (e.g. ``{"type": "reach",
        "campaigns": [...], "op": "union"}``); the answer arrives as a
        normal data message via ``recv()``.  The send time is stamped
        per id so ``latency_split`` can divide the round trip."""
        self._note_request(msg)
        self._send(msg)

    def _send(self, msg: dict) -> None:
        self._file.write(ws_encode(json.dumps(msg).encode(), mask=True))
        self._file.flush()

    def ping(self, payload: bytes = b"hb") -> bytes:
        """Round-trip a ping; returns the pong payload.  Data frames
        that race the pong are queued for the next ``recv()``, not
        dropped."""
        self._file.write(ws_encode(payload, opcode=0x9, mask=True))
        self._file.flush()
        while True:
            opcode, data = self._expect_frame()
            if opcode == 0xA:
                return data
            if opcode in (0x1, 0x2):
                self._pending.append(json.loads(data))
            elif opcode == 0x8:
                raise ConnectionError("server sent close")

    def _expect_frame(self) -> tuple[int, bytes]:
        frame = ws_read_frame(self._file)
        if frame is None:
            raise ConnectionError("pub/sub server closed the connection")
        return frame

    def recv(self) -> dict:
        if self._pending:
            return self._pending.pop(0)
        while True:
            opcode, data = self._expect_frame()
            if opcode in (0x1, 0x2):
                return json.loads(data)
            if opcode == 0x8:
                raise ConnectionError("server sent close")
            # ignore unsolicited pongs/pings here

    def close(self) -> None:
        try:
            self._file.write(ws_encode(b"", opcode=0x8, mask=True))
            self._file.flush()
        except OSError:
            pass
        try:
            self._file.close()
        finally:
            self._sock.close()


#: bounded buffers on the client's synchronous request path: pending
#: out-of-turn messages kept for recv(), and abandoned retry ids whose
#: late replies must be discarded rather than surfaced
CLIENT_PENDING_MAX = 1024
CLIENT_STALE_IDS_MAX = 4096


class PubSubClient(_LatencySplitMixin):
    """Blocking JSON-lines client (tests + CLI queries).

    Reads go through an internal recv buffer rather than the makefile
    reader: ``BufferedReader.readline`` silently DISCARDS a partial
    line when the socket times out mid-read, which desyncs the framing
    exactly when the timeout/retry path needs it intact.
    Here a timeout leaves the partial line buffered; the next read
    resumes where it stopped.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._timeout_s = timeout_s
        self._file = self._sock.makefile("wb")
        self._rbuf = bytearray()
        self._pending: list = []        # out-of-turn messages for recv()
        self._stale_ids: dict = {}      # abandoned retry ids (ordered)
        self._auto_id = 0

    def subscribe(self, topic: str) -> None:
        self._send({"type": "subscribe", "topic": topic})

    def unsubscribe(self, topic: str) -> None:
        self._send({"type": "unsubscribe", "topic": topic})

    def request(self, msg: dict, *, timeout_s: float | None = None,
                retries: int = 0):
        """Send a query-verb message.

        Legacy mode (``timeout_s=None``): fire-and-forget — the answer
        arrives as a normal data message via ``recv()``, and a dropped
        reply blocks that recv forever.  Returns None.

        Synchronous mode (``timeout_s`` set): waits for the
        id-matched reply and returns its DATA payload.  Each timed-out
        attempt retries with a FRESH derived id (``<id>~r<n>``) — the
        server answers each id at most once (request-id dedup), so a
        retry racing its predecessor's late reply stays exactly-once-
        answered: the first reply wins and the other ids' replies are
        discarded.  Raises TimeoutError when every attempt times out.
        The send time is stamped per id either way so ``latency_split``
        can divide the round trip.
        """
        if timeout_s is None:
            self._note_request(msg)
            self._send(msg)
            return None
        base = msg.get("id")
        if base is None:
            self._auto_id += 1
            base = f"q{self._auto_id}"
        attempt_ids = []
        for attempt in range(max(int(retries), 0) + 1):
            qid = base if attempt == 0 else f"{base}~r{attempt}"
            attempt_ids.append(qid)
            m = dict(msg)
            m["id"] = qid
            self._note_request(m)
            self._send(m)
            deadline = time.monotonic() + timeout_s
            try:
                data = self._recv_reply(qid, deadline)
            except (TimeoutError, socket.timeout):
                # abandoned attempt: a late reply to this id must be
                # dropped, not surfaced as someone else's answer
                self._mark_stale(qid)
                continue
            for other in attempt_ids[:-1]:
                self._mark_stale(other)
            return data
        raise TimeoutError(
            f"pub/sub request timed out after {len(attempt_ids)} "
            f"attempt(s) ({timeout_s}s each)")

    def _mark_stale(self, qid) -> None:
        self._stale_ids[qid] = True
        while len(self._stale_ids) > CLIENT_STALE_IDS_MAX:
            self._stale_ids.pop(next(iter(self._stale_ids)))

    def _recv_reply(self, qid, deadline: float) -> dict:
        """Drain messages until the data reply carrying ``qid``
        arrives.  Torn frames (undecodable lines) are skipped — the
        framing resyncs on the next newline; out-of-turn messages are
        buffered for ``recv()``; late replies to abandoned retry ids
        are discarded."""
        while True:
            line = self._readline(deadline)
            if not line:
                raise ConnectionError(
                    "pub/sub server closed the connection")
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue   # damaged frame: the message is lost, the
                #            stream is not — resync on the next line
            if not isinstance(msg, dict):
                continue
            data = msg.get("data")
            rid = data.get("id") if isinstance(data, dict) else None
            if msg.get("type") == "data" and rid is not None:
                if rid == qid:
                    return data
                if self._stale_ids.pop(rid, None) is not None:
                    continue   # late reply to an abandoned attempt
            self._pending.append(msg)
            if len(self._pending) > CLIENT_PENDING_MAX:
                self._pending.pop(0)

    def _readline(self, deadline: float | None = None) -> bytes:
        """One newline-terminated line from the recv buffer.  With a
        deadline, raises TimeoutError when it passes — the partial
        line stays buffered for the next read.  Returns b'' on EOF
        with an empty buffer (a partial line at EOF is returned as
        is; its json parse fails like any damaged frame)."""
        while b"\n" not in self._rbuf:
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("pub/sub read deadline passed")
                self._sock.settimeout(remaining)
            try:
                chunk = self._sock.recv(65536)
            finally:
                if deadline is not None:
                    self._sock.settimeout(self._timeout_s)
            if not chunk:
                out = bytes(self._rbuf)
                self._rbuf.clear()
                return out
            self._rbuf += chunk
        i = self._rbuf.find(b"\n")
        out = bytes(self._rbuf[:i + 1])
        del self._rbuf[:i + 1]
        return out

    def _send(self, msg: dict) -> None:
        self._file.write(json.dumps(msg).encode() + b"\n")
        self._file.flush()

    def recv(self) -> dict:
        if self._pending:
            return self._pending.pop(0)
        line = self._readline()
        if not line:
            raise ConnectionError("pub/sub server closed the connection")
        return json.loads(line)

    def close(self) -> None:
        try:
            self._file.close()
        finally:
            self._sock.close()
