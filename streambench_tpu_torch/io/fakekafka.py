"""Recorded-protocol fake of the confluent-kafka surface the adapter uses.

The port's copy of ``streambench_tpu/io/fakekafka.py``: a
semantics-honest stand-in for exactly the client subset
``KafkaWriter``/``KafkaReader``/``KafkaBroker`` (``io.kafka``) touch, so
the broker contract runs against the real adapter with no
confluent-kafka and no cluster.

Two modes, one cluster model:

- **in-process** — ``clients(cluster)`` returns a client bundle that the
  adapter installs through its module-level seam
  (:func:`streambench_tpu_torch.io.kafka.use_clients`) or receives via
  the ``clients=`` constructor argument.  ``":inprocess:"`` as
  ``bootstrap.servers`` resolves to a process-global cluster (the
  ``redis.host: :inprocess:`` precedent).
- **TCP** — :class:`FakeKafkaServer` serves the same cluster over a
  JSON-lines socket protocol (the ``io.fakeredis.FakeRedisServer``
  precedent), so the harness can launch a real broker *process*
  (``START_KAFKA``/``STOP_KAFKA``) and the engine CLI consumes over an
  actual socket:  ``python -m streambench_tpu_torch.io.fakekafka --port N``.

Delivery model:

- per-partition logs are append-only; record offsets are list indices;
  per-partition order is ALWAYS preserved, faults included;
- producers get delivery callbacks (served by ``poll``/``flush``); a
  delivery-report failure means the record did NOT land and the callback
  says so — the hardened writer re-produces it;
- a consumer that loses its connection rewinds to the start of the last
  batch it *returned* — un-checkpointed records arrive twice (Kafka's
  at-least-once shape); the hardened reader counts and filters the
  redelivery;
- broker faults are drawn from a seeded ``chaos.plan.FaultPlan`` via
  ``chaos.inject.FaultInjector.kafka_fault()`` attached to the cluster
  (the CLI's ``--fault-*`` flags build one): same plan, same faults, and
  with no injector, or a rate-0 plan, every op is an exact pass-through.
"""

from __future__ import annotations

import argparse
import base64
import json
import signal
import socket
import socketserver
import threading
import time

from streambench_tpu_torch.metrics import FaultCounters

#: bootstrap.servers sentinel: the process-global in-process cluster
INPROC = ":inprocess:"

# confluent_kafka.KafkaError code values (the ones the adapter and the
# fault model touch); negative codes are librdkafka-internal.
ERR__PARTITION_EOF = -191
ERR__TRANSPORT = -195
ERR__ALL_BROKERS_DOWN = -187
ERR__MSG_TIMED_OUT = -192
ERR_TOPIC_ALREADY_EXISTS = 36
ERR_UNKNOWN_TOPIC_OR_PART = 3

_RETRIABLE = frozenset({ERR__TRANSPORT, ERR__ALL_BROKERS_DOWN,
                        ERR__MSG_TIMED_OUT})


class FakeKafkaError:
    """``confluent_kafka.KafkaError`` lookalike (code + retriable)."""

    _PARTITION_EOF = ERR__PARTITION_EOF
    _TRANSPORT = ERR__TRANSPORT
    _ALL_BROKERS_DOWN = ERR__ALL_BROKERS_DOWN
    _MSG_TIMED_OUT = ERR__MSG_TIMED_OUT
    TOPIC_ALREADY_EXISTS = ERR_TOPIC_ALREADY_EXISTS
    UNKNOWN_TOPIC_OR_PART = ERR_UNKNOWN_TOPIC_OR_PART

    def __init__(self, code: int, reason: str = ""):
        self._code = int(code)
        self._reason = reason or f"fake kafka error code={code}"

    def code(self) -> int:
        return self._code

    def retriable(self) -> bool:
        return self._code in _RETRIABLE

    def str(self) -> str:
        return self._reason

    def __str__(self) -> str:  # KafkaException(err) stringifies the error
        return self._reason

    def __repr__(self) -> str:
        return f"FakeKafkaError({self._code}, {self._reason!r})"


class FakeKafkaException(Exception):
    """``confluent_kafka.KafkaException``: ``args[0]`` is the error."""


class FakeTopicPartition:
    """``confluent_kafka.TopicPartition`` lookalike."""

    def __init__(self, topic: str, partition: int = 0, offset: int = 0):
        self.topic = topic
        self.partition = int(partition)
        self.offset = int(offset)

    def __repr__(self) -> str:
        return (f"FakeTopicPartition({self.topic!r}, {self.partition}, "
                f"{self.offset})")


class FakeMessage:
    """``confluent_kafka.Message`` lookalike (value/offset/error)."""

    __slots__ = ("_topic", "_partition", "_offset", "_value", "_error")

    def __init__(self, topic, partition, offset=None, value=None,
                 error=None):
        self._topic = topic
        self._partition = partition
        self._offset = offset
        self._value = value
        self._error = error

    def topic(self):
        return self._topic

    def partition(self):
        return self._partition

    def offset(self):
        return self._offset

    def value(self):
        return self._value

    def error(self):
        return self._error


class FakeConnectionDropped(ConnectionError):
    """The broker dropped this client's connection (fault-injected)."""


# ---------------------------------------------------------------------------
# the cluster: per-partition append-only logs + seeded broker faults
# ---------------------------------------------------------------------------

class FakeCluster:
    """Broker state shared by every client (in-process or via TCP).

    ``attach_chaos(injector)`` arms seeded broker-surface faults: every
    append/fetch asks ``injector.kafka_fault()`` for this op's fault
    kind (``None`` almost always).  Kinds not applicable to the op are
    ignored — the draw is consumed either way, so fault placement is a
    pure function of the plan and the op sequence.
    """

    def __init__(self, chaos=None):
        self._lock = threading.RLock()
        self._topics: "dict[str, list[list[bytes]]]" = {}
        self._chaos = chaos
        self.counters = FaultCounters()

    def attach_chaos(self, injector) -> None:
        with self._lock:
            self._chaos = injector

    def _fault(self) -> "str | None":
        chaos = self._chaos
        if chaos is None:
            return None
        return chaos.kafka_fault()

    # -- admin ---------------------------------------------------------
    def create_topic(self, topic: str, partitions: int = 1) -> bool:
        """True when created, False when it already existed."""
        with self._lock:
            if topic in self._topics:
                return False
            self._topics[topic] = [[] for _ in range(max(partitions, 1))]
            return True

    def topics_meta(self) -> "dict[str, int]":
        with self._lock:
            return {t: len(parts) for t, parts in self._topics.items()}

    # -- data plane ----------------------------------------------------
    def append(self, topic: str, partition: int, value: bytes):
        """-> ``(offset, fault_kind)``; ``offset`` None when rejected."""
        kind = self._fault()
        if kind in ("down", "produce", "dr_fail"):
            self.counters.inc(f"fake_kafka_{kind}")
            return None, kind
        with self._lock:
            parts = self._topics.setdefault(
                topic, [[] for _ in range(partition + 1)])
            while len(parts) <= partition:
                parts.append([])
            log = parts[partition]
            log.append(bytes(value))
            return len(log) - 1, None

    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int):
        """-> ``(records, log_end, fault_kind)``.

        ``records`` is ``[(offset, value), ...]`` starting at ``offset``;
        on a fault the records that WOULD have shipped are withheld
        (nothing was delivered), matching a socket that died mid-fetch.
        """
        kind = self._fault()
        if kind in ("down", "consume", "conn_drop"):
            self.counters.inc(f"fake_kafka_{kind}")
            return [], self.log_end(topic, partition), kind
        with self._lock:
            parts = self._topics.get(topic)
            log = parts[partition] if parts and partition < len(parts) \
                else []
            end = len(log)
            lo = max(int(offset), 0)
            recs = [(i, log[i])
                    for i in range(lo, min(end, lo + max(max_records, 0)))]
            return recs, end, None

    def log_end(self, topic: str, partition: int) -> int:
        with self._lock:
            parts = self._topics.get(topic)
            if not parts or partition >= len(parts):
                return 0
            return len(parts[partition])

    def total_records(self) -> int:
        with self._lock:
            return sum(len(log) for parts in self._topics.values()
                       for log in parts)


_default_cluster: "FakeCluster | None" = None
_default_lock = threading.Lock()


def default_cluster() -> FakeCluster:
    """The process-global cluster behind ``":inprocess:"``."""
    global _default_cluster
    with _default_lock:
        if _default_cluster is None:
            _default_cluster = FakeCluster()
        return _default_cluster


def reset_default_cluster() -> None:
    """Drop the process-global cluster (test isolation)."""
    global _default_cluster
    with _default_lock:
        _default_cluster = None


# ---------------------------------------------------------------------------
# transports: same five verbs in-process or over the JSON-lines socket
# ---------------------------------------------------------------------------

class _InProcTransport:
    def __init__(self, cluster: FakeCluster):
        self._cluster = cluster

    def create(self, topic, partitions):
        return self._cluster.create_topic(topic, partitions)

    def meta(self):
        return self._cluster.topics_meta()

    def append(self, topic, partition, value):
        off, kind = self._cluster.append(topic, partition, value)
        if kind == "conn_drop":  # not applicable to appends, but honest
            raise FakeConnectionDropped("broker dropped the connection")
        return off, kind

    def fetch(self, topic, partition, offset, max_records):
        recs, end, kind = self._cluster.fetch(topic, partition, offset,
                                              max_records)
        if kind == "conn_drop":
            raise FakeConnectionDropped("broker dropped the connection")
        return recs, end, kind

    def log_end(self, topic, partition):
        return self._cluster.log_end(topic, partition)

    def close(self):
        pass


class _TcpTransport:
    """One JSON-lines connection to a :class:`FakeKafkaServer`.

    A request is one JSON object + ``\\n``; the response likewise.  A
    fault-injected connection drop closes the socket server-side — the
    next request here raises, and the caller reconnects lazily.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self._addr = (host, int(port))
        self._timeout = timeout_s
        self._sock: "socket.socket | None" = None
        self._buf = b""
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self._addr, timeout=self._timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            self._buf = b""
        return self._sock

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._buf = b""

    def _rpc(self, req: dict) -> dict:
        with self._lock:
            try:
                s = self._connect()
                s.sendall(json.dumps(req).encode("utf-8") + b"\n")
                while b"\n" not in self._buf:
                    chunk = s.recv(65536)
                    if not chunk:
                        raise FakeConnectionDropped(
                            "broker dropped the connection")
                    self._buf += chunk
                line, self._buf = self._buf.split(b"\n", 1)
            except (OSError, FakeConnectionDropped):
                self._drop()
                raise FakeConnectionDropped(
                    "broker dropped the connection") from None
            return json.loads(line)

    def create(self, topic, partitions):
        return self._rpc({"op": "create", "topic": topic,
                          "parts": partitions})["created"]

    def meta(self):
        return {t: int(n)
                for t, n in self._rpc({"op": "meta"})["topics"].items()}

    def append(self, topic, partition, value):
        r = self._rpc({"op": "append", "topic": topic, "part": partition,
                       "value": base64.b64encode(value).decode("ascii")})
        return r.get("offset"), r.get("fault")

    def fetch(self, topic, partition, offset, max_records):
        r = self._rpc({"op": "fetch", "topic": topic, "part": partition,
                       "offset": offset, "max": max_records})
        recs = [(int(o), base64.b64decode(v)) for o, v in r["records"]]
        return recs, int(r["end"]), r.get("fault")

    def log_end(self, topic, partition):
        return int(self._rpc({"op": "end", "topic": topic,
                              "part": partition})["end"])

    def close(self):
        with self._lock:
            self._drop()


def _transport(conf: dict, cluster: "FakeCluster | None"):
    if cluster is not None:
        return _InProcTransport(cluster)
    servers = str(conf.get("bootstrap.servers", "") or "")
    if servers in ("", INPROC):
        return _InProcTransport(default_cluster())
    first = servers.split(",")[0].strip()
    host, _, port = first.rpartition(":")
    return _TcpTransport(host or "127.0.0.1", int(port))


# ---------------------------------------------------------------------------
# the client surface the adapter touches
# ---------------------------------------------------------------------------

class FakeProducer:
    """``confluent_kafka.Producer`` subset: produce/poll/flush.

    Delivery reports are queued at produce time and served from
    ``poll``/``flush`` exactly like librdkafka's callback pump.  A
    fault-injected produce error raises (retriable); a delivery-report
    failure lands the error in the callback instead — the record did
    NOT reach the log either way.
    """

    def __init__(self, conf: dict, *, cluster: "FakeCluster | None" = None):
        self._conf = dict(conf or {})
        self._t = _transport(self._conf, cluster)
        self._pending: "list[tuple]" = []   # (callback, err, msg)
        self._lock = threading.Lock()

    def produce(self, topic, value=None, partition=0, on_delivery=None,
                callback=None, **_kw):
        cb = on_delivery or callback
        data = value if isinstance(value, bytes) else \
            str(value or "").encode("utf-8")
        try:
            off, kind = self._t.append(topic, int(partition), data)
        except FakeConnectionDropped:
            raise FakeKafkaException(FakeKafkaError(
                ERR__TRANSPORT, "produce failed: connection dropped"))
        if kind == "down":
            raise FakeKafkaException(FakeKafkaError(
                ERR__ALL_BROKERS_DOWN, "produce failed: broker down"))
        if kind == "produce":
            raise FakeKafkaException(FakeKafkaError(
                ERR__TRANSPORT, "produce failed: transient broker error"))
        if kind == "dr_fail":
            msg = FakeMessage(topic, int(partition), None, data,
                              FakeKafkaError(ERR__MSG_TIMED_OUT,
                                             "delivery report: timed out"))
            with self._lock:
                self._pending.append(
                    (cb, msg.error(), msg))
            return
        msg = FakeMessage(topic, int(partition), off, data, None)
        with self._lock:
            self._pending.append((cb, None, msg))

    def poll(self, timeout=0):
        with self._lock:
            pending, self._pending = self._pending, []
        for cb, err, msg in pending:
            if cb is not None:
                cb(err, msg)
        return len(pending)

    def flush(self, timeout=None):
        self.poll(0)
        return 0

    def __len__(self):
        with self._lock:
            return len(self._pending)


class FakeConsumer:
    """``confluent_kafka.Consumer`` subset: assign/seek/consume/pause.

    Fetch positions live client-side (like librdkafka's fetch state).
    On a dropped connection the consumer reconnects and resumes from the
    start of the last batch it *returned* — anything newer it had
    fetched but not surfaced is refetched, and anything the caller has
    not checkpointed arrives again.  That redelivery is the honest
    at-least-once shape the hardened reader must absorb.
    """

    def __init__(self, conf: dict, *, cluster: "FakeCluster | None" = None):
        self._conf = dict(conf or {})
        self._t = _transport(self._conf, cluster)
        self._pos: "dict[tuple, int]" = {}
        self._batch_start: "dict[tuple, int]" = {}
        self._order: "list[tuple]" = []
        self._paused: "set[tuple]" = set()
        self._closed = False

    @staticmethod
    def _key(tp) -> tuple:
        return (tp.topic, int(tp.partition))

    def assign(self, tps) -> None:
        self._order = []
        for tp in tps:
            k = self._key(tp)
            off = int(getattr(tp, "offset", 0))
            if off < 0:   # OFFSET_BEGINNING (-2) / OFFSET_END (-1)
                off = self._t.log_end(*k) if off == -1 else 0
            self._order.append(k)
            self._pos[k] = off
            self._batch_start[k] = off

    def seek(self, tp) -> None:
        k = self._key(tp)
        self._pos[k] = int(tp.offset)
        self._batch_start[k] = int(tp.offset)

    def pause(self, tps) -> None:
        self._paused.update(self._key(tp) for tp in tps)

    def resume(self, tps) -> None:
        self._paused.difference_update(self._key(tp) for tp in tps)

    def get_watermark_offsets(self, tp, timeout=None, cached=False):
        return 0, self._t.log_end(*self._key(tp))

    def _dropped(self) -> "list[FakeMessage]":
        # reconnect-and-rewind: resume from the last RETURNED batch
        for k in self._order:
            self._pos[k] = self._batch_start.get(k, self._pos.get(k, 0))
        return [FakeMessage(None, None, None, None,
                            FakeKafkaError(ERR__TRANSPORT,
                                           "connection dropped; "
                                           "reconnected"))]

    def consume(self, num_messages=1, timeout=None):
        if self._closed:
            raise FakeKafkaException(FakeKafkaError(
                ERR__TRANSPORT, "consumer is closed"))
        out: "list[FakeMessage]" = []
        for k in self._order:
            if k in self._paused or len(out) >= num_messages:
                continue
            topic, part = k
            pos = self._pos[k]
            try:
                recs, end, kind = self._t.fetch(
                    topic, part, pos, num_messages - len(out))
            except FakeConnectionDropped:
                out.extend(self._dropped())
                continue
            if kind == "down":
                out.append(FakeMessage(topic, part, None, None,
                                       FakeKafkaError(
                                           ERR__ALL_BROKERS_DOWN,
                                           "broker down")))
                continue
            if recs:
                self._batch_start[k] = pos
                for off, val in recs:
                    out.append(FakeMessage(topic, part, off, val, None))
                self._pos[k] = recs[-1][0] + 1
            elif kind is None and pos >= end:
                # a clean empty fetch confirms the position: a later
                # drop rewinds at most one batch, never the whole log
                self._batch_start[k] = pos
                out.append(FakeMessage(topic, part, end, None,
                                       FakeKafkaError(ERR__PARTITION_EOF,
                                                      "partition EOF")))
            if kind == "consume":
                out.append(FakeMessage(topic, part, None, None,
                                       FakeKafkaError(
                                           ERR__TRANSPORT,
                                           "transient consume error")))
        return out

    def close(self) -> None:
        self._closed = True
        self._t.close()


class _FakeFuture:
    def __init__(self, exc=None):
        self._exc = exc

    def result(self, timeout=None):
        if self._exc is not None:
            raise self._exc
        return None


class _TopicMetadata:
    def __init__(self, topic: str, partitions: int):
        self.topic = topic
        self.error = None
        self.partitions = {i: None for i in range(partitions)}


class _ClusterMetadata:
    def __init__(self, topics: "dict[str, int]"):
        self.topics = {t: _TopicMetadata(t, n) for t, n in topics.items()}


class FakeAdminClient:
    """``confluent_kafka.admin.AdminClient`` subset."""

    def __init__(self, conf: dict, *, cluster: "FakeCluster | None" = None):
        self._conf = dict(conf or {})
        self._t = _transport(self._conf, cluster)

    def create_topics(self, new_topics):
        futures = {}
        for nt in new_topics:
            created = self._t.create(nt.topic,
                                     int(getattr(nt, "num_partitions", 1)))
            exc = None if created else FakeKafkaException(FakeKafkaError(
                ERR_TOPIC_ALREADY_EXISTS,
                f"TOPIC_ALREADY_EXISTS: {nt.topic!r}"))
            futures[nt.topic] = _FakeFuture(exc)
        return futures

    def list_topics(self, topic=None, timeout=None) -> _ClusterMetadata:
        meta = self._t.meta()
        if topic is not None:
            meta = {t: n for t, n in meta.items() if t == topic}
        return _ClusterMetadata(meta)


class FakeNewTopic:
    """``confluent_kafka.admin.NewTopic`` lookalike."""

    def __init__(self, topic: str, num_partitions: int = 1,
                 replication_factor: int = 1):
        self.topic = topic
        self.num_partitions = int(num_partitions)
        self.replication_factor = int(replication_factor)


class FakeClients:
    """The client bundle ``io.kafka`` resolves through its seam.

    Mirrors the attribute surface the adapter needs: ``Producer``,
    ``Consumer``, ``AdminClient``, ``NewTopic``, ``TopicPartition``,
    ``KafkaError``, ``KafkaException``.  When ``cluster`` is given every
    client binds to it; otherwise each client resolves its own transport
    from ``bootstrap.servers`` (``":inprocess:"`` or ``host:port``).
    """

    name = "fakekafka"

    def __init__(self, cluster: "FakeCluster | None" = None):
        self.cluster = cluster
        self.NewTopic = FakeNewTopic
        self.TopicPartition = FakeTopicPartition
        self.KafkaError = FakeKafkaError
        self.KafkaException = FakeKafkaException

    def Producer(self, conf):
        return FakeProducer(conf, cluster=self.cluster)

    def Consumer(self, conf):
        return FakeConsumer(conf, cluster=self.cluster)

    def AdminClient(self, conf):
        return FakeAdminClient(conf, cluster=self.cluster)


def clients(cluster: "FakeCluster | None" = None) -> FakeClients:
    """A client bundle for :func:`streambench_tpu_torch.io.kafka.use_clients`
    or the ``clients=`` constructor seam."""
    return FakeClients(cluster)


# ---------------------------------------------------------------------------
# the standalone broker process (FakeRedisServer precedent)
# ---------------------------------------------------------------------------

class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        cluster: FakeCluster = self.server.cluster  # type: ignore
        buf = b""
        while True:
            try:
                chunk = self.request.recv(65536)
            except (ConnectionError, OSError):
                return
            if not chunk:
                return
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                try:
                    req = json.loads(line)
                    resp, drop = self._dispatch(cluster, req)
                except Exception as e:  # malformed request: answer, keep going
                    resp, drop = {"ok": False, "err": str(e)}, False
                if drop:
                    # fault-injected connection drop: no response, close —
                    # the client sees a dead socket mid-fetch
                    return
                try:
                    self.request.sendall(
                        json.dumps(resp).encode("utf-8") + b"\n")
                except (ConnectionError, OSError):
                    return

    @staticmethod
    def _dispatch(cluster: FakeCluster, req: dict):
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "pong": True}, False
        if op == "create":
            created = cluster.create_topic(req["topic"],
                                           int(req.get("parts", 1)))
            return {"ok": True, "created": created}, False
        if op == "meta":
            return {"ok": True, "topics": cluster.topics_meta()}, False
        if op == "end":
            return {"ok": True,
                    "end": cluster.log_end(req["topic"],
                                           int(req["part"]))}, False
        if op == "append":
            off, kind = cluster.append(req["topic"], int(req["part"]),
                                       base64.b64decode(req["value"]))
            return {"ok": off is not None, "offset": off,
                    "fault": kind}, False
        if op == "fetch":
            recs, end, kind = cluster.fetch(
                req["topic"], int(req["part"]), int(req["offset"]),
                int(req.get("max", 65536)))
            if kind == "conn_drop":
                return {}, True
            return {"ok": True,
                    "records": [[o, base64.b64encode(v).decode("ascii")]
                                for o, v in recs],
                    "end": end, "fault": kind}, False
        if op == "counters":
            return {"ok": True,
                    "counters": cluster.counters.snapshot(),
                    "records": cluster.total_records()}, False
        return {"ok": False, "err": f"unknown op {op!r}"}, False


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class FakeKafkaServer:
    """The fake cluster behind a real socket, as its own lifecycle unit."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 cluster: "FakeCluster | None" = None):
        self.cluster = cluster if cluster is not None else FakeCluster()
        self._server = _Server((host, port), _Handler)
        self._server.cluster = self.cluster  # type: ignore[attr-defined]
        self.host, self.port = self._server.server_address[:2]
        self._thread: "threading.Thread | None" = None

    def start(self) -> "FakeKafkaServer":
        t = threading.Thread(
            target=lambda: self._server.serve_forever(poll_interval=0.05),
            name="fakekafka-server", daemon=True)
        t.start()
        self._thread = t
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "FakeKafkaServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def ping(host: str, port: int, timeout_s: float = 1.0) -> bool:
    """True when a FakeKafkaServer answers at host:port (liveness probe,
    the ``_redis_alive`` analog for START_KAFKA adoption)."""
    try:
        t = _TcpTransport(host, port, timeout_s=timeout_s)
        try:
            ok = bool(t._rpc({"op": "ping"}).get("pong"))
        finally:
            t.close()
        return ok
    except (OSError, ValueError, FakeConnectionDropped):
        return False


def _build_chaos(ns):
    """Seeded broker faults for a server process (CLI knobs -> plan), or
    None when no rate and no down window is set."""
    if not (ns.fault_produce_rate or ns.fault_consume_rate
            or ns.fault_conn_drop_rate or ns.fault_dr_fail_rate
            or ns.fault_down):
        return None
    from streambench_tpu_torch.chaos import FaultInjector, FaultPlan

    down = ()
    if ns.fault_down:
        lo, _, hi = ns.fault_down.partition(":")
        down = ((int(lo), int(hi)),)
    plan = FaultPlan.generate(
        ns.fault_seed,
        kafka_produce_rate=ns.fault_produce_rate,
        kafka_consume_rate=ns.fault_consume_rate,
        kafka_conn_drop_rate=ns.fault_conn_drop_rate,
        kafka_dr_fail_rate=ns.fault_dr_fail_rate,
        kafka_ops=ns.fault_ops, kafka_down=down)
    return FaultInjector(plan)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="standalone fake Kafka broker (JSON-lines protocol)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--fault-produce-rate", type=float, default=0.0)
    ap.add_argument("--fault-consume-rate", type=float, default=0.0)
    ap.add_argument("--fault-conn-drop-rate", type=float, default=0.0)
    ap.add_argument("--fault-dr-fail-rate", type=float, default=0.0)
    ap.add_argument("--fault-ops", type=int, default=0)
    ap.add_argument("--fault-down", default="",
                    help="broker-down op window as LO:HI")
    ns = ap.parse_args(argv)

    srv = FakeKafkaServer(ns.host, ns.port)
    chaos = _build_chaos(ns)
    if chaos is not None:
        srv.cluster.attach_chaos(chaos)
        print(f"chaos armed: seed={ns.fault_seed} "
              f"plan={'zero' if chaos.plan.is_zero else 'nonzero'}",
              flush=True)
    srv.start()
    print(f"ready {srv.host}:{srv.port}", flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    snap = srv.cluster.counters.snapshot()
    print(f"stopping: records={srv.cluster.total_records()} "
          f"faults={json.dumps(snap, sort_keys=True)}", flush=True)
    srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
