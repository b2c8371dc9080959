"""The port's Kafka source: the adapter (``io.kafka``), the fake broker
(``io.fakekafka``), and the engine over them, against the JAX package.

The broker contract runs against ``FileBroker`` and against the REAL
adapter over the fake (in process through the ``use_clients`` seam, and
over a live TCP broker thread); the fake's protocol units and delivery
model are the ports of ``tests/test_kafka_contract.py`` and the cases of
``tests/test_fakekafka.py`` that need no chaos package (the one fault
case drives a scripted injector instead).  Then a catchup over a
3-partition in-process cluster, serial and pipelined, exact against the
JAX engine on the same cluster contents; the CLI and harness process
stories; and the refusal of the broker's ``--fault-*`` flags.
"""

import json
import os
import random
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import AdAnalyticsEngine as JaxEngine
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io import fakekafka as jax_fakekafka
from streambench_tpu.io import kafka as jax_kafka
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu_torch.config import default_config, write_local_conf
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.io import fakekafka, kafka
from streambench_tpu_torch.io.fakeredis import FakeRedisStore
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    as_redis,
    read_seen_counts,
    seed_campaigns,
)
from streambench_tpu_torch.metrics import FaultCounters
from streambench_tpu_torch.utils.ids import make_ids

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: TCP broker threads started by a case, stopped by the autouse fixture
_SERVERS: list = []


@pytest.fixture(autouse=True)
def _reset_fake_kafka():
    yield
    kafka.use_clients(None)
    fakekafka.reset_default_cluster()
    while _SERVERS:
        _SERVERS.pop().stop()


def _file_broker(tmp_path):
    return FileBroker(str(tmp_path / "broker"))


def _fake_inproc_broker(tmp_path):
    # the injection seam itself: KafkaBroker resolves its clients through
    # ``_clients()`` exactly as the real path would
    kafka.use_clients(fakekafka.clients(fakekafka.FakeCluster()))
    return kafka.KafkaBroker(fakekafka.INPROC)


def _fake_tcp_broker(tmp_path):
    srv = fakekafka.FakeKafkaServer()
    srv.start()
    _SERVERS.append(srv)
    return kafka.KafkaBroker(f"{srv.host}:{srv.port}",
                             clients=fakekafka.clients())


BROKERS = pytest.mark.parametrize(
    "make", [_file_broker, _fake_inproc_broker, _fake_tcp_broker],
    ids=["file", "fake_inproc", "fake_tcp"])


# ----------------------------------------------------------------------
# the broker contract (tests/test_kafka_contract.py)
# ----------------------------------------------------------------------

@BROKERS
def test_roundtrip_and_tailing(tmp_path, make):
    b = make(tmp_path)
    b.create_topic("t", partitions=1)
    w = b.writer("t")
    r = b.reader("t")
    w.append(b"one")
    w.append_many([b"two", b"three\n"])
    w.flush()
    got = r.poll_blocking(timeout_s=5.0, max_records=2)
    got += r.poll_blocking(timeout_s=5.0)
    assert got == [b"one", b"two", b"three"]
    assert r.poll() == []
    w.append(b"four")
    w.flush()
    assert r.poll_blocking(timeout_s=5.0) == [b"four"]
    w.close()
    r.close()


@BROKERS
def test_offset_seek_resume(tmp_path, make):
    b = make(tmp_path)
    b.create_topic("s", partitions=1)
    w = b.writer("s")
    w.append_many([b"a", b"b", b"c", b"d"])
    w.flush()
    r = b.reader("s")
    assert r.poll_blocking(timeout_s=5.0, max_records=2) == [b"a", b"b"]
    mark = r.offset
    assert r.poll_blocking(timeout_s=5.0) == [b"c", b"d"]
    r.seek(mark)
    assert r.poll_blocking(timeout_s=5.0) == [b"c", b"d"]
    r2 = b.reader("s", offset=mark)
    assert r2.poll_blocking(timeout_s=5.0) == [b"c", b"d"]
    r.close()
    r2.close()
    w.close()


@BROKERS
def test_partitions_and_multi_reader(tmp_path, make):
    b = make(tmp_path)
    b.create_topic("p", partitions=3)
    assert b.partitions("p") == [0, 1, 2]
    for part in range(3):
        w = b.writer("p", part)
        w.append(f"m{part}".encode())
        w.flush()
        w.close()
    with b.multi_reader("p") as mr:
        got = set()
        for _ in range(50):
            got.update(mr.poll())
            if len(got) == 3:
                break
        assert got == {b"m0", b"m1", b"m2"}
    assert set(b.read_all("p")) == {b"m0", b"m1", b"m2"}


def test_unavailable_guard_raises_actionably():
    assert not kafka.available()   # no confluent-kafka in the test image
    with pytest.raises(kafka.KafkaUnavailableError, match="FileBroker"):
        kafka.KafkaWriter("localhost:9092", "t")
    with pytest.raises(kafka.KafkaUnavailableError):
        kafka.KafkaReader("localhost:9092", "t")
    with pytest.raises(kafka.KafkaUnavailableError):
        kafka.KafkaBroker("localhost:9092")


def test_make_broker_switch_point(tmp_path):
    assert isinstance(kafka.make_broker(None, str(tmp_path / "j")),
                      FileBroker)
    assert isinstance(kafka.make_broker("", str(tmp_path / "j2")),
                      FileBroker)
    # fake: the in-process cluster when no address is named
    fake = kafka.make_broker("", str(tmp_path / "j3"), fake=True)
    assert isinstance(fake, kafka.KafkaBroker)
    # a named cluster with no client library is an ERROR, never a file
    # journal pretending to be the configured cluster
    with pytest.raises(kafka.KafkaUnavailableError, match="KAFKA_BROKERS"):
        kafka.make_broker("localhost:9092", str(tmp_path / "j4"))


def test_engine_cli_reaches_kafka_adapter(tmp_path):
    """``kafka.bootstrap`` routes the port CLI through ``make_broker``:
    without confluent-kafka that is the actionable error, not a quiet
    file journal."""
    conf = tmp_path / "conf.yaml"
    write_local_conf(conf, {"kafka.bootstrap": "kafkahost:9092",
                            "redis.host": ":inprocess:"})
    (tmp_path / "ad-to-campaign-ids.txt").write_text("ad1,c1\n")
    p = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.engine",
         "--confPath", str(conf), "--workdir", str(tmp_path), "--catchup",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert p.returncode != 0
    assert "KafkaUnavailable" in p.stderr and "confluent-kafka" in p.stderr


# ----------------------------------------------------------------------
# the fake's protocol units and delivery model (tests/test_fakekafka.py)
# ----------------------------------------------------------------------

def test_producer_delivery_callbacks():
    cl = fakekafka.FakeCluster()
    cl.create_topic("t", 1)
    p = fakekafka.FakeProducer({"bootstrap.servers": fakekafka.INPROC},
                               cluster=cl)
    seen = []
    p.produce("t", value=b"a", partition=0,
              on_delivery=lambda err, msg: seen.append((err, msg)))
    assert seen == []                   # served by the poll/flush pump
    p.flush()
    (err, msg), = seen
    assert err is None and msg.value() == b"a" and msg.offset() == 0
    assert cl._topics["t"][0] == [b"a"]


def test_admin_create_list_and_already_exists():
    cl = fakekafka.FakeCluster()
    admin = fakekafka.FakeAdminClient(
        {"bootstrap.servers": fakekafka.INPROC}, cluster=cl)
    assert admin.create_topics(
        [fakekafka.FakeNewTopic("t", 3)])["t"].result() is None
    assert sorted(admin.list_topics().topics["t"].partitions) == [0, 1, 2]
    futs = admin.create_topics([fakekafka.FakeNewTopic("t", 3)])
    with pytest.raises(fakekafka.FakeKafkaException) as ei:
        futs["t"].result()
    assert ei.value.args[0].code() == fakekafka.ERR_TOPIC_ALREADY_EXISTS


def test_consumer_assign_seek_eof_watermarks_pause():
    cl = fakekafka.FakeCluster()
    cl.create_topic("t", 1)
    for v in (b"a", b"b", b"c"):
        cl.append("t", 0, v)
    c = fakekafka.FakeConsumer({"bootstrap.servers": fakekafka.INPROC,
                                "group.id": "g"}, cluster=cl)
    tp = fakekafka.FakeTopicPartition("t", 0, 0)
    c.assign([tp])
    assert [m.value() for m in c.consume(10, 0)] == [b"a", b"b", b"c"]
    msgs = c.consume(num_messages=10, timeout=0)
    assert len(msgs) == 1
    assert msgs[0].error().code() == fakekafka.ERR__PARTITION_EOF
    assert c.get_watermark_offsets(tp) == (0, 3)
    c.seek(fakekafka.FakeTopicPartition("t", 0, 1))
    assert [m.value() for m in c.consume(10, 0)] == [b"b", b"c"]
    c.pause([tp])
    assert c.consume(10, 0) == []
    c.resume([tp])
    c.seek(fakekafka.FakeTopicPartition("t", 0, 0))
    assert [m.value() for m in c.consume(10, 0)] == [b"a", b"b", b"c"]
    c.close()


class _ScriptedConsumer:
    def __init__(self, batches):
        self._batches = list(batches)

    def assign(self, tps):
        pass

    def consume(self, num_messages=1, timeout=None):
        return self._batches.pop(0) if self._batches else []

    def close(self):
        pass


def test_reader_returns_records_accumulated_before_mid_batch_error():
    err = fakekafka.FakeKafkaError(fakekafka.ERR__TRANSPORT,
                                   "transient mid-batch")
    eof = fakekafka.FakeKafkaError(fakekafka.ERR__PARTITION_EOF, "eof")
    batches = [
        [fakekafka.FakeMessage("t", 0, 0, b"a", None),
         fakekafka.FakeMessage("t", 0, 1, b"b", None),
         fakekafka.FakeMessage("t", 0, None, None, err)],
        [fakekafka.FakeMessage("t", 0, 2, b"c", None)],
        [fakekafka.FakeMessage("t", 0, 3, None, eof)],
    ]

    class _Clients(fakekafka.FakeClients):
        def Consumer(self, conf):
            return _ScriptedConsumer(batches)

    counters = FaultCounters()
    r = kafka.KafkaReader(fakekafka.INPROC, "t", clients=_Clients(),
                          counters=counters, retry_base_ms=0.01,
                          retry_cap_ms=0.02)
    assert r.poll() == [b"a", b"b"] and r.offset == 2
    assert r.poll() == [b"c"]
    assert r.poll() == []
    snap = counters.snapshot()
    assert snap.get("kafka_delivered") == snap.get("kafka_consumed") == 3
    assert "kafka_redeliveries" not in snap


class _Every:
    """An injector that faults every ``k``-th op with ``kind`` (the
    cluster's seam; the seeded plans of the chaos package are not
    ported)."""

    def __init__(self, kind, k):
        self.kind, self.k, self.ops = kind, k, 0

    def kafka_fault(self):
        self.ops += 1
        return self.kind if self.ops % self.k == 0 else None


def test_conn_drop_redelivery_counted_filtered_never_doubled():
    values = [b"r%03d" % i for i in range(80)]
    counters = FaultCounters()
    cl = fakekafka.FakeCluster()
    b = kafka.KafkaBroker(fakekafka.INPROC, clients=fakekafka.clients(cl),
                          counters=counters)
    b.create_topic("t", partitions=1)
    w = b.writer("t")
    w.append_many(values)
    w.flush()
    cl.attach_chaos(_Every("conn_drop", 3))
    r = kafka.KafkaReader(fakekafka.INPROC, "t",
                          clients=fakekafka.clients(cl), counters=counters,
                          retry_base_ms=0.01, retry_cap_ms=0.02)
    got = []
    for _ in range(200):
        try:
            got.extend(r.poll(max_records=8))
        except fakekafka.FakeKafkaException:
            pass
    assert got == values == cl._topics["t"][0]
    snap = counters.snapshot()
    assert snap.get("kafka_redeliveries", 0) > 0
    assert snap["kafka_consumed"] == (snap["kafka_delivered"]
                                      + snap["kafka_redeliveries"])
    assert snap["kafka_delivered"] == snap["kafka_produced"] == 80


# ----------------------------------------------------------------------
# the engine over a 3-partition fake cluster, against the JAX engine
# ----------------------------------------------------------------------

def _fill_cluster(cluster, n, seed):
    """Generated events spread over three partitions of ``ad-events``;
    returns (campaigns, mapping)."""
    rng = random.Random(seed)
    campaigns = make_ids(100, rng)
    ads = make_ids(1000, rng)
    mapping = {a: campaigns[i // 10] for i, a in enumerate(ads)}
    src = gen.EventSource(ads=ads, user_ids=make_ids(100, rng),
                          page_ids=make_ids(100, rng), with_skew=True,
                          rng=rng)
    cluster.create_topic("ad-events", 3)
    start = 1_700_000_000_000
    for i in range(n):
        cluster.append("ad-events", i % 3,
                       src.event_at(start + 7 * i).encode())
    return campaigns, mapping


@pytest.mark.parametrize("pipeline", ["off", "on", "auto"])
def test_catchup_over_three_partitions_matches_jax(pipeline):
    cluster = fakekafka.FakeCluster()
    campaigns, mapping = _fill_cluster(cluster, 9_000, seed=4)
    # the JAX engine reads the same cluster contents through its own
    # adapter and fake
    jcl = jax_fakekafka.FakeCluster()
    for p, log in enumerate(cluster._topics["ad-events"]):
        for v in log:
            jcl.append("ad-events", p, v)
    over = dict(kafka_topic="ad-events", jax_batch_size=512,
                jax_scan_batches=2, jax_ingest_pipeline=pipeline)

    jr = jax_as_redis(JaxStore())
    jax_seed(jr, campaigns)
    jeng = JaxEngine(jax_default_config(**over), mapping,
                     campaigns=campaigns, redis=jr)
    jb = jax_kafka.KafkaBroker(jax_fakekafka.INPROC,
                               clients=jax_fakekafka.clients(jcl))
    with jb.multi_reader("ad-events") as reader:
        jstats = JaxRunner(jeng, reader).run_catchup()
    jeng.close()

    tr = as_redis(FakeRedisStore())
    seed_campaigns(tr, campaigns)
    eng = AdAnalyticsEngine(default_config(**over), mapping,
                            campaigns=campaigns, redis=tr, device="cpu")
    tb = kafka.KafkaBroker(fakekafka.INPROC,
                           clients=fakekafka.clients(cluster))
    assert tb.partitions("ad-events") == [0, 1, 2]
    with tb.multi_reader("ad-events") as reader:
        runner = StreamRunner(eng, reader)
        # no poll_block on Kafka: "auto" resolves to the serial loop
        assert runner._pipeline_on() == (pipeline == "on")
        stats = runner.run_catchup()
        offsets = runner._reader_position()
    eng.close()
    assert stats.events == jstats.events == 9_000
    assert offsets == [3_000, 3_000, 3_000]
    got = read_seen_counts(tr)
    assert got == jax_seen(jr)
    assert sum(sum(v.values()) for v in got.values()) > 0


# ----------------------------------------------------------------------
# processes: the standalone broker, its fault flags, the harness verbs
# ----------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read_ready_line(proc):
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("ready "):
            host, port = line.split()[1].rsplit(":", 1)
            return host, int(port)
        if not line:
            time.sleep(0.05)
    raise AssertionError("broker never printed its ready line")


def test_cli_broker_process_roundtrip_and_stop():
    proc = subprocess.Popen(
        [sys.executable, "-m", "streambench_tpu_torch.io.fakekafka",
         "--host", "127.0.0.1", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    try:
        host, port = _read_ready_line(proc)
        assert fakekafka.ping(host, port)
        b = kafka.KafkaBroker(f"{host}:{port}", clients=fakekafka.clients())
        b.create_topic("t", partitions=1)
        w = b.writer("t")
        w.append_many([b"x", b"y"])
        w.flush()
        r = b.reader("t")
        assert r.poll_blocking(timeout_s=5.0) == [b"x", b"y"]
        w.close()
        r.close()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=20)
        assert "stopping:" in out and "records=2" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


#: each fault flag with what it needs to arm a nonzero plan (a rate draws
#: nothing without --fault-ops) and the cluster counter its fault bumps
FAULT_CASES = {
    "--fault-seed": (["--fault-consume-rate", "0.5", "--fault-ops", "200"],
                     "fake_kafka_consume"),
    "--fault-produce-rate": (["--fault-ops", "200"], "fake_kafka_produce"),
    "--fault-conn-drop-rate": (["--fault-ops", "200"],
                               "fake_kafka_conn_drop"),
    "--fault-down": ([], "fake_kafka_down"),
}


@pytest.mark.parametrize("flag,value", [
    ("--fault-seed", "7"), ("--fault-produce-rate", "0.5"),
    ("--fault-conn-drop-rate", "0.5"), ("--fault-down", "2:6")])
def test_fault_flags_are_refused_not_ignored(flag, value):
    """A ``--fault-*`` flag is never ignored: the broker process arms the
    seeded plan it describes (``chaos armed:`` with a nonzero plan) and
    the fault shows in the cluster's counters after traffic."""
    extra, counter = FAULT_CASES[flag]
    proc = subprocess.Popen(
        [sys.executable, "-m", "streambench_tpu_torch.io.fakekafka",
         "--host", "127.0.0.1", "--port", "0", flag, value, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    try:
        armed = proc.stdout.readline()
        seed = value if flag == "--fault-seed" else "0"
        assert armed.strip() == f"chaos armed: seed={seed} plan=nonzero"
        host, port = _read_ready_line(proc)
        counters = FaultCounters()
        b = kafka.KafkaBroker(f"{host}:{port}", clients=fakekafka.clients(),
                              counters=counters)
        b.create_topic("t", partitions=1)
        w = kafka.KafkaWriter(f"{host}:{port}", "t",
                              clients=fakekafka.clients(),
                              counters=counters, retry_base_ms=0.01,
                              retry_cap_ms=0.05)
        values = [b"v%02d" % i for i in range(30)]
        w.append_many(values)
        w.flush()
        w.close()
        r = kafka.KafkaReader(f"{host}:{port}", "t",
                              clients=fakekafka.clients(),
                              counters=counters, retry_base_ms=0.01,
                              retry_cap_ms=0.05)
        got = []
        for _ in range(400):
            if len(got) >= len(values):
                break
            try:
                got.extend(r.poll(max_records=4))
            except fakekafka.FakeKafkaException:
                pass            # retries exhausted on an empty batch
        r.close()
        assert sorted(got) == sorted(values)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=20)
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("stopping:"))
        faults = json.loads(line.split("faults=", 1)[1])
        assert faults.get(counter, 0) > 0, line
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _harness(verb, env):
    return subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.harness", verb],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60)


def _harness_env(workdir, port, **extra):
    return dict(os.environ, WORKDIR=str(workdir), KAFKA_FAKE="1",
                KAFKA_BROKERS=f"127.0.0.1:{port}", PYTHONPATH=REPO,
                **extra)


def test_start_stop_kafka_harness_verbs(tmp_path):
    port = _free_port()
    env = _harness_env(tmp_path, port)
    p = _harness("START_KAFKA", env)
    assert p.returncode == 0, p.stdout + p.stderr
    try:
        assert (tmp_path / "pids" / "kafka.pid").exists()
        b = kafka.KafkaBroker(f"127.0.0.1:{port}",
                              clients=fakekafka.clients())
        b.create_topic("h", partitions=1)
        w = b.writer("h")
        w.append(b"hello")
        w.flush()
        r = b.reader("h")
        assert r.poll_blocking(timeout_s=5.0) == [b"hello"]
        w.close()
        r.close()
    finally:
        p = _harness("STOP_KAFKA", env)
    assert p.returncode == 0, p.stdout + p.stderr
    assert not (tmp_path / "pids" / "kafka.pid").exists()
    assert not fakekafka.ping("127.0.0.1", port, timeout_s=0.5)


def test_start_kafka_adopts_external_broker(tmp_path):
    srv = fakekafka.FakeKafkaServer(port=0)
    srv.start()
    try:
        env = _harness_env(tmp_path, srv.port)
        p = _harness("START_KAFKA", env)
        assert p.returncode == 0, p.stdout + p.stderr
        assert (tmp_path / "pids" / "kafka.external").exists()
        assert not (tmp_path / "pids" / "kafka.pid").exists()
        p = _harness("STOP_KAFKA", env)
        assert p.returncode == 0, p.stdout + p.stderr
        assert fakekafka.ping("127.0.0.1", srv.port)
    finally:
        srv.stop()


def test_start_kafka_with_fault_flags_fails(tmp_path):
    """``KAFKA_FAULT_*`` reaches the broker, which serves with the seeded
    faults armed: a broker-down window on the first ops is absorbed by
    the writer's backoff, counted by the cluster, and named in the log."""
    port = _free_port()
    env = _harness_env(tmp_path, port, KAFKA_FAULT_SEED="3",
                       KAFKA_FAULT_DOWN="0:4")
    p = _harness("START_KAFKA", env)
    assert p.returncode == 0, p.stdout + p.stderr
    try:
        counters = FaultCounters()
        b = kafka.KafkaBroker(f"127.0.0.1:{port}",
                              clients=fakekafka.clients(), counters=counters)
        b.create_topic("h", partitions=1)
        w = kafka.KafkaWriter(f"127.0.0.1:{port}", "h",
                              clients=fakekafka.clients(),
                              counters=counters, retry_base_ms=0.01,
                              retry_cap_ms=0.05)
        w.append_many([b"hello", b"world"])
        w.flush()
        w.close()
        r = b.reader("h")
        assert r.poll_blocking(timeout_s=5.0) == [b"hello", b"world"]
        r.close()
        assert counters.get("kafka_produce_retries") > 0
    finally:
        p = _harness("STOP_KAFKA", env)
    assert p.returncode == 0, p.stdout + p.stderr
    log = (tmp_path / "logs" / "kafka.log").read_text()
    assert "chaos armed: seed=3 plan=nonzero" in log
    assert '"fake_kafka_down": 4' in log
