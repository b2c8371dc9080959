"""Real-Kafka broker adapter (import-guarded; confluent-kafka optional).

The port's copy of ``streambench_tpu/io/kafka.py``: host code, no torch.

The reference's firehose is a live Kafka cluster: the harness creates the
``ad-events`` topic with ``$PARTITIONS`` partitions
(``create_kafka_topic``, ``stream-bench.sh:107-115``) and the generator
produces paced JSON events to it (``core.clj:203``).  This module is the
same firehose behind the exact reader/writer/broker contract the rest of
the framework consumes (``io.journal.FileBroker``), so an engine, the
generator, and the harness can switch between the hermetic file journal
and a real cluster with one constructor swap:

- ``KafkaWriter.append/append_many/flush/close``  == ``JournalWriter``
- ``KafkaReader.poll/seek/offset/close``          == ``JournalReader``
  (offsets are Kafka record offsets, not byte positions — both are
  opaque monotonic ints to checkpoints, which is all ``Snapshot.offset``
  requires)
- ``KafkaBroker.create_topic/partitions/writer/reader/multi_reader/
  read_all``                                      == ``FileBroker``

Client resolution goes through one module-level seam: every adapter
resolves its client classes from :func:`_clients`, which returns either
the real confluent-kafka surface or whatever bundle :func:`use_clients`
installed (``io.fakekafka.clients()`` — the hermetic broker).  That is
how the broker-contract suite executes this adapter for real in an image
with no confluent-kafka and no cluster, without monkeypatching internals.

confluent-kafka itself stays gated: importing the module is safe
anywhere; constructing an adapter without the library (and without an
installed bundle) raises ``KafkaUnavailableError`` with install
guidance.  The contract is pinned by ``tests/test_torch_kafka.py``,
which runs the same suite against ``FileBroker`` and against
``KafkaBroker`` over the fake.

Robustness (the broker edge is a fault surface):

- transient produce/consume errors and broker-down windows are absorbed
  by bounded capped-jitter retry/backoff, with
  every retry and every backoff millisecond counted
  (``kafka_produce_retries`` / ``kafka_consume_retries`` /
  ``kafka_broker_down_ms``);
- a failed delivery report re-produces the record (it never landed);
- a reconnecting consumer REDELIVERS records past the last checkpoint —
  the reader counts them (``kafka_redeliveries``) and filters them, so
  at-least-once at the socket stays exactly-once into the engine;
- a mid-batch consumer error returns the records already accumulated
  before surfacing (dropping them after the offset had advanced would
  lose them on retry);
- ``pause()``/``resume()`` park the consumer broker-side (the admission
  controller's defer actuator), with ``lag()`` measuring the backlog
  left in the broker via watermark offsets.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace
from typing import Iterator

from streambench_tpu_torch.metrics import FaultCounters

try:  # pragma: no cover - exercised only where the library exists
    import confluent_kafka as _ck
    from confluent_kafka.admin import AdminClient as _AdminClient
    from confluent_kafka.admin import NewTopic as _NewTopic
except ImportError:  # the baked image has no confluent-kafka
    _ck = None
    _AdminClient = None
    _NewTopic = None

#: retry/backoff defaults (overridable per adapter): bounded, capped,
#: jittered
RETRY_LIMIT = 16
RETRY_BASE_MS = 25.0
RETRY_CAP_MS = 500.0


class KafkaUnavailableError(RuntimeError):
    """confluent-kafka is not installed in this environment."""


def available() -> bool:
    """True when the confluent-kafka client library is importable."""
    return _ck is not None


def _require() -> None:
    if _ck is None:
        raise KafkaUnavailableError(
            "confluent-kafka is not installed; use io.journal.FileBroker "
            "(the hermetic stand-in) or install confluent-kafka to drive "
            "a real cluster")


#: the injection seam: a client bundle installed by use_clients() wins
#: over the real library (io.fakekafka.clients() is the one installer)
_override = None


def use_clients(bundle) -> None:
    """Install (or with ``None`` remove) an alternate client bundle.

    The bundle must expose ``Producer``/``Consumer``/``AdminClient``/
    ``NewTopic``/``TopicPartition``/``KafkaError``/``KafkaException`` —
    the exact surface this adapter touches.  This is the module-level
    seam the hermetic fake installs through; nothing else in the adapter
    special-cases fakes.
    """
    global _override
    _override = bundle


def _clients():
    """The client bundle every adapter constructor resolves."""
    if _override is not None:
        return _override
    _require()
    return SimpleNamespace(
        Producer=_ck.Producer, Consumer=_ck.Consumer,
        TopicPartition=_ck.TopicPartition, KafkaError=_ck.KafkaError,
        KafkaException=_ck.KafkaException,
        AdminClient=_AdminClient, NewTopic=_NewTopic)


def _retriable(exc) -> bool:
    """Transient per librdkafka's own taxonomy (``KafkaError.retriable``
    plus the local-queue-full BufferError)."""
    if isinstance(exc, BufferError):
        return True
    err = exc.args[0] if getattr(exc, "args", None) else None
    try:
        return bool(err.retriable())
    except Exception:
        return False


class _Backoff:
    """Capped exponential backoff with jitter, counted."""

    def __init__(self, base_ms: float, cap_ms: float, limit: int,
                 counters: FaultCounters, rng: "random.Random | None"):
        self.base_ms = max(float(base_ms), 0.0)
        self.cap_ms = max(float(cap_ms), self.base_ms)
        self.limit = max(int(limit), 0)
        self.counters = counters
        self._rng = rng if rng is not None else random.Random()

    def sleep(self, attempt: int) -> None:
        n = min(max(attempt, 1), 16)
        base = min(self.base_ms * (1 << (n - 1)), self.cap_ms)
        ms = base * (0.5 + 0.5 * self._rng.random())
        self.counters.inc("kafka_broker_down_ms", int(ms) or 1)
        time.sleep(ms / 1000.0)


class KafkaWriter:
    """JournalWriter-contract producer for one (topic, partition).

    ``counters`` accounting: ``kafka_produced`` — records acked by the
    broker (the *sent* side of the delivery ledger);
    ``kafka_produce_retries`` — re-produces after a transient error or a
    failed delivery report; ``kafka_broker_down_ms`` — backoff sleep.
    """

    def __init__(self, brokers: str, topic: str, partition: int = 0,
                 linger_ms: int = 5, clients=None,
                 counters: "FaultCounters | None" = None,
                 retry_base_ms: float = RETRY_BASE_MS,
                 retry_cap_ms: float = RETRY_CAP_MS,
                 retry_limit: int = RETRY_LIMIT,
                 rng: "random.Random | None" = None):
        self._c = clients if clients is not None else _clients()
        self.topic = topic
        self.partition = partition
        self.counters = counters if counters is not None else FaultCounters()
        self.retry_limit = max(int(retry_limit), 0)
        self._back = _Backoff(retry_base_ms, retry_cap_ms, retry_limit,
                              self.counters, rng)
        self._redo: list[bytes] = []   # failed delivery reports, re-produced
        self._producer = self._c.Producer({
            "bootstrap.servers": brokers,
            "linger.ms": linger_ms,
        })

    def _on_delivery(self, err, msg) -> None:
        if err is None:
            self.counters.inc("kafka_produced")
            return
        # the record never landed: queue it for re-produce (at-least-once
        # is the writer's job; the reader dedupes the other direction)
        self.counters.inc("kafka_dr_failures")
        self._redo.append(msg.value())

    def _produce(self, data: bytes) -> None:
        attempt = 0
        while True:
            try:
                self._producer.produce(self.topic, value=data,
                                       partition=self.partition,
                                       on_delivery=self._on_delivery)
                self._producer.poll(0)  # serve delivery callbacks
                return
            except Exception as e:
                if not _retriable(e) or attempt >= self.retry_limit:
                    raise
                attempt += 1
                self.counters.inc("kafka_produce_retries")
                self._back.sleep(attempt)

    def _drain_redo(self) -> None:
        rounds = 0
        while self._redo and rounds <= self.retry_limit:
            rounds += 1
            redo, self._redo = self._redo, []
            for data in redo:
                self.counters.inc("kafka_produce_retries")
                self._produce(data)
            self._producer.flush()
        if self._redo:
            raise self._c.KafkaException(self._c.KafkaError(
                self._c.KafkaError._MSG_TIMED_OUT
                if hasattr(self._c.KafkaError, "_MSG_TIMED_OUT") else -192,
                f"{len(self._redo)} records undeliverable after "
                f"{rounds} re-produce rounds"))

    def append(self, line: str | bytes) -> None:
        data = line.encode("utf-8") if isinstance(line, str) else line
        self._produce(data.rstrip(b"\n"))

    def append_many(self, lines: list[str] | list[bytes]) -> None:
        for line in lines:
            self.append(line)

    def flush(self) -> None:
        self._producer.flush()
        self._drain_redo()

    def close(self) -> None:
        self.flush()

    def __enter__(self) -> "KafkaWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class KafkaReader:
    """JournalReader-contract consumer over one (topic, partition).

    ``offset`` is the next Kafka record offset to consume — the checkpoint
    unit, advanced only over *delivered* records, exactly like the
    journal reader's byte offset (and Kafka's own committed-offset
    semantics, ``setStartFromEarliest``,
    ``AdvertisingTopologyNative.java:92``).

    Delivery ledger (``counters``): ``kafka_consumed`` counts every
    record the broker handed up; ``kafka_delivered`` the unique records
    returned to the caller; ``kafka_redeliveries`` the duplicates a
    reconnecting broker re-sent (observed, counted, filtered — never
    double-delivered); ``kafka_consume_retries``/``kafka_broker_down_ms``
    the retry/backoff spent absorbing transient errors.
    """

    def __init__(self, brokers: str, topic: str, partition: int = 0,
                 offset: int = 0, group_id: str = "streambench",
                 poll_timeout_s: float = 0.05, clients=None,
                 counters: "FaultCounters | None" = None,
                 retry_base_ms: float = RETRY_BASE_MS,
                 retry_cap_ms: float = RETRY_CAP_MS,
                 retry_limit: int = RETRY_LIMIT,
                 rng: "random.Random | None" = None):
        self._c = clients if clients is not None else _clients()
        self.topic = topic
        self.partition = partition
        self.offset = offset
        self.counters = counters if counters is not None else FaultCounters()
        self.retry_limit = max(int(retry_limit), 0)
        self._back = _Backoff(retry_base_ms, retry_cap_ms, retry_limit,
                              self.counters, rng)
        self._poll_timeout = poll_timeout_s
        self._paused = False
        self._consumer = self._c.Consumer({
            "bootstrap.servers": brokers,
            "group.id": group_id,
            "enable.auto.commit": False,
            "auto.offset.reset": "earliest",
        })
        self._assign()

    def _tp(self):
        return self._c.TopicPartition(self.topic, self.partition,
                                      self.offset)

    def _assign(self) -> None:
        self._consumer.assign([self._tp()])

    def seek(self, offset: int) -> None:
        self.offset = offset
        self._assign()

    # -- admission actuator: park the backlog IN THE BROKER ------------
    def pause(self) -> None:
        """Stop fetching; records queue up broker-side (measured by
        ``lag()``), nothing is dropped.  The admission controller's
        defer actuator."""
        if self._paused:
            return
        self._paused = True
        try:
            self._consumer.pause([self._tp()])
        except Exception:
            pass  # pause is an optimization; the poll() gate is the law

    def resume(self) -> None:
        if not self._paused:
            return
        self._paused = False
        try:
            self._consumer.resume([self._tp()])
        except Exception:
            pass

    @property
    def paused(self) -> bool:
        return self._paused

    def lag(self) -> int:
        """Records sitting in the broker past this reader's offset (the
        consumer-lag gauge unit)."""
        try:
            _lo, hi = self._consumer.get_watermark_offsets(
                self._tp(), timeout=0.1)
        except Exception:
            return 0
        return max(int(hi) - int(self.offset), 0)

    # -- consume -------------------------------------------------------
    def _consume_into(self, out: list, max_records: int):
        """One consume pass.  Appends delivered values to ``out`` and
        advances ``offset``; returns the first non-EOF error (records
        accumulated BEFORE it stay in ``out``), or None."""
        try:
            msgs = self._consumer.consume(
                num_messages=max(max_records - len(out), 1),
                timeout=self._poll_timeout)
        except Exception as e:
            if _retriable(e):
                return e.args[0] if getattr(e, "args", None) else e
            raise
        for m in msgs:
            err = m.error()
            if err is not None:
                if err.code() == self._c.KafkaError._PARTITION_EOF:
                    continue
                return err
            off = m.offset()
            self.counters.inc("kafka_consumed")
            if off is not None and off < self.offset:
                # a reconnecting broker re-sent records we already
                # delivered: count the redelivery, never double-deliver
                self.counters.inc("kafka_redeliveries")
                continue
            out.append(m.value())
            self.counters.inc("kafka_delivered")
            if off is not None:
                self.offset = max(self.offset, off + 1)
            else:
                self.offset += 1
        return None

    def _pump(self, out: list, max_records: int):
        """Consume passes until records are delivered, the tail is
        confirmed, or an error surfaces.  A pass that yields nothing but
        filtered redeliveries is PROGRESS, not the tail — returning []
        there would read as caught-up to a catchup loop while undelivered
        records still sit past the rewound batch."""
        while True:
            before = self.counters.get("kafka_consumed")
            err = self._consume_into(out, max_records)
            if err is not None or out:
                return err
            if self.counters.get("kafka_consumed") == before:
                return None   # clean empty fetch: genuinely at the tail

    def poll(self, max_records: int = 65536) -> list[bytes]:
        if self._paused:
            return []
        out: list[bytes] = []
        err = self._pump(out, max_records)
        attempt = 0
        # retry only from empty: once records are in hand they are
        # returned THIS call — raising here would drop them after the
        # offset had advanced (data loss)
        while err is not None and not out and attempt < self.retry_limit:
            attempt += 1
            self.counters.inc("kafka_consume_retries")
            self._back.sleep(attempt)
            err = self._pump(out, max_records)
        if err is not None and not out:
            raise self._c.KafkaException(err)
        return out

    def poll_blocking(self, max_records: int = 65536,
                      timeout_s: float = 1.0,
                      poll_interval_s: float = 0.001) -> list[bytes]:
        deadline = time.monotonic() + timeout_s
        while True:
            lines = self.poll(max_records)
            if lines or time.monotonic() >= deadline:
                return lines
            time.sleep(poll_interval_s)

    def close(self) -> None:
        self._consumer.close()

    def __enter__(self) -> "KafkaReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class KafkaBroker:
    """FileBroker-contract facade over a real (or fake) Kafka cluster.

    One ``FaultCounters`` ledger is shared by every writer/reader this
    broker hands out, so a run's delivery accounting
    (``kafka_produced`` == ``kafka_delivered``,
    ``kafka_consumed`` == delivered + redelivered) reads off a single
    snapshot.
    """

    def __init__(self, brokers: str, group_id: str = "streambench",
                 create_timeout_s: float = 30.0, clients=None,
                 counters: "FaultCounters | None" = None):
        self._c = clients if clients is not None else _clients()
        self.brokers = brokers
        self.group_id = group_id
        self.counters = counters if counters is not None else FaultCounters()
        self._create_timeout = create_timeout_s
        self._admin = self._c.AdminClient({"bootstrap.servers": brokers})

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        futures = self._admin.create_topics(
            [self._c.NewTopic(topic, num_partitions=partitions,
                              replication_factor=1)])
        for fut in futures.values():
            try:
                fut.result(timeout=self._create_timeout)
            except Exception as e:  # TOPIC_ALREADY_EXISTS is fine
                if "TOPIC_ALREADY_EXISTS" not in str(e):
                    raise

    def partitions(self, topic: str) -> list[int]:
        md = self._admin.list_topics(topic, timeout=self._create_timeout)
        t = md.topics.get(topic)
        if t is None or t.error is not None:
            return []
        return sorted(t.partitions)

    def writer(self, topic: str, partition: int = 0,
               append: bool = True) -> KafkaWriter:
        # Kafka topics are always append-only; append=False (truncate)
        # has no cluster analog and is ignored.
        return KafkaWriter(self.brokers, topic, partition,
                           clients=self._c, counters=self.counters)

    def reader(self, topic: str, partition: int = 0,
               offset: int = 0) -> KafkaReader:
        return KafkaReader(self.brokers, topic, partition, offset,
                           group_id=self.group_id, clients=self._c,
                           counters=self.counters)

    def multi_reader(self, topic: str):
        from streambench_tpu_torch.io.journal import MultiReader

        parts = self.partitions(topic) or [0]
        return MultiReader([self.reader(topic, p) for p in parts])

    def read_all(self, topic: str) -> Iterator[bytes]:
        for p in self.partitions(topic):
            with self.reader(topic, p) as r:
                while True:
                    lines = r.poll_blocking(timeout_s=1.0)
                    if not lines:
                        break
                    yield from lines


def make_broker(brokers: str | None, journal_root: str, *,
                fake: bool = False):
    """The one switch point: a real cluster when ``brokers`` names one,
    the hermetic fake broker when ``fake`` is set (``kafka.fake``), else
    the file journal.

    A named cluster with no client library is an ERROR, not a silent
    fallback — an operator who pointed the harness at Kafka must not get
    a file journal pretending to be one
    (``stream-bench.sh:107-115`` likewise hard-fails without Kafka).
    """
    if fake:
        from streambench_tpu_torch.io import fakekafka

        # empty bootstrap -> the in-process cluster; host:port -> a
        # FakeKafkaServer process (START_KAFKA)
        return KafkaBroker(brokers or fakekafka.INPROC,
                           clients=fakekafka.clients())
    if brokers:
        if not available():
            raise KafkaUnavailableError(
                f"kafka bootstrap {brokers!r} was configured but "
                "confluent-kafka is not installed; install it or drop "
                "the kafka.bootstrap / KAFKA_BROKERS setting to use the "
                "file-journal broker")
        return KafkaBroker(brokers)
    from streambench_tpu_torch.io.journal import FileBroker

    return FileBroker(journal_root)
