"""The broker edge under seeded faults: the port's fake Kafka cluster, its
adapter and its engine, against the JAX package's.

The twins of ``tests/test_chaos_kafka.py`` (broker-down windows,
transient produce errors and connection drops, with and without a crash
script, each run oracle-exact under ``jax.sink.exactly_once`` with the
delivery ledger balanced; the default-off pin) and of the broker-fault
cases of ``tests/test_fakekafka.py`` (redelivery counted and filtered,
failed delivery reports re-produced, produce retries, the down window,
seeded determinism, the rate-0 pass-through).  Where the op schedule is
the same in both packages, the port's stream, ledger and fault draws
must equal the JAX package's.  All on the CPU.
"""

import random

import pytest
import torch

from streambench_tpu import chaos as jax_chaos
from streambench_tpu.checkpoint import Checkpointer as JaxCheckpointer
from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import AdAnalyticsEngine as JaxEngine
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io import fakekafka as jax_fakekafka
from streambench_tpu.io import kafka as jax_kafka
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu.metrics import FaultCounters as JaxCounters
from streambench_tpu_torch import chaos
from streambench_tpu_torch.chaos import (
    FaultInjector,
    FaultPlan,
    check_kafka_edge,
)
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
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
from streambench_tpu_torch.obs import FlightRecorder

torch.set_num_threads(1)

EVENTS = 6_000
TAIL = 1_024   # records produced AFTER chaos attaches (the faulted tail)


@pytest.fixture(autouse=True)
def _clean_seam():
    yield
    kafka.use_clients(None)
    fakekafka.reset_default_cluster()


class Side:
    """One package's broker edge: fake cluster, adapter, chaos, engine."""

    def __init__(self, name: str):
        jax = name == "jax"
        self.name = name
        self.fake = jax_fakekafka if jax else fakekafka
        self.kafka = jax_kafka if jax else kafka
        self.chaos = jax_chaos if jax else chaos
        self.counters = JaxCounters if jax else FaultCounters
        self._jax = jax

    def plan(self, plan: FaultPlan):
        return self.chaos.FaultPlan(**{k: getattr(plan, k) for k in (
            "seed", "crashes", "kafka_faults", "kafka_down")})

    def broker(self, cl, counters=None):
        return self.kafka.KafkaBroker(self.fake.INPROC,
                                      clients=self.fake.clients(cl),
                                      counters=counters)

    def writer(self, cl, topic, counters):
        return self.kafka.KafkaWriter(self.fake.INPROC, topic,
                                      clients=self.fake.clients(cl),
                                      counters=counters,
                                      retry_base_ms=0.01,
                                      retry_cap_ms=0.02)

    def reader(self, cl, topic, counters):
        return self.kafka.KafkaReader(self.fake.INPROC, topic,
                                      clients=self.fake.clients(cl),
                                      counters=counters,
                                      retry_base_ms=0.01,
                                      retry_cap_ms=0.02)

    def store(self, campaigns):
        if self._jax:
            r = jax_as_redis(JaxStore())
            jax_seed(r, campaigns)
        else:
            r = as_redis(FakeRedisStore())
            seed_campaigns(r, campaigns)
        return r

    def engine(self, cfg_over, mapping, r):
        if self._jax:
            return JaxEngine(jax_default_config(**cfg_over), mapping,
                             redis=r)
        return AdAnalyticsEngine(default_config(**cfg_over), mapping,
                                 redis=r, device="cpu")

    def runner(self):
        return JaxRunner if self._jax else StreamRunner

    def seen(self, r):
        return (jax_seen if self._jax else read_seen_counts)(r)


def _minus_wallclock(snap):
    # kafka_broker_down_ms is real backoff sleep with unseeded jitter
    return {k: v for k, v in snap.items() if k != "kafka_broker_down_ms"}


# ----------------------------------------------------------------------
# the engine over a faulted cluster (tests/test_chaos_kafka.py)
# ----------------------------------------------------------------------

CFG = dict(jax_batch_size=256, jax_scan_batches=2, jax_sink_retry_base_ms=1,
           jax_sink_retry_cap_ms=4, jax_sink_exactly_once=True)


@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    """Generated events and oracle in a file journal (the ground truth);
    the same bytes are produced into each cluster."""
    tmp = tmp_path_factory.mktemp("kafka_chaos")
    cfg = default_config(**CFG)
    fb = FileBroker(str(tmp / "journal"))
    gen.do_setup(None, cfg, broker=fb, events_num=EVENTS,
                 rng=random.Random(7), workdir=str(tmp))
    mapping = gen.load_ad_mapping_file(str(tmp / gen.AD_TO_CAMPAIGN_FILE))
    campaigns = gen.load_ids(str(tmp))[0]
    events = list(fb.read_all(cfg.kafka_topic))
    assert len(events) >= EVENTS
    return str(tmp), cfg.kafka_topic, mapping, campaigns, events


def _setup(side: Side, journal, inj):
    """Mirror every event into a fresh cluster of ``side``: the bulk
    clean, the last ``TAIL`` records through the armed cluster, so
    produce faults and the down window land on a real writer."""
    _, topic, _, _, events = journal
    counters = side.counters()
    cl = side.fake.FakeCluster()
    kb = side.broker(cl, counters)
    kb.create_topic(topic, partitions=1)
    w = kb.writer(topic)
    w.append_many(events[:-TAIL])
    w.flush()
    w.close()
    cl.attach_chaos(inj)
    wf = side.writer(cl, topic, counters)
    wf.append_many(events[-TAIL:])
    wf.flush()
    wf.close()
    # every event acked and in the log: faults absorbed, never dropped
    assert cl._topics[topic][0] == events
    return kb, cl, counters


def _broker_fault_plan(crashes=()):
    plan = FaultPlan.generate(
        1234,
        kafka_produce_rate=0.08, kafka_conn_drop_rate=0.12,
        kafka_ops=8_000, kafka_down=((20, 28),))
    return FaultPlan(seed=plan.seed, kafka_faults=plan.kafka_faults,
                     kafka_down=plan.kafka_down, crashes=tuple(crashes))


def test_broker_faults_oracle_exact_ledger_balanced(journal, tmp_path):
    """Down window, produce faults and conn drops, no crash: oracle-exact,
    the ledger balanced with genuine redeliveries, and the port's
    windows, ledger and draws equal to the JAX engine's."""
    workdir, topic, mapping, campaigns, events = journal
    out = {}
    for name in ("jax", "port"):
        side = Side(name)
        inj = side.chaos.FaultInjector(side.plan(_broker_fault_plan()))
        kb, cl, counters = _setup(side, journal, inj)
        r = side.store(campaigns)
        eng = side.engine(CFG, mapping, r)
        fr = (FlightRecorder(str(tmp_path), capacity=64)
              if name == "port" else None)
        side.runner()(eng, kb.reader(topic), flightrec=fr).run_catchup()
        eng.close()
        snap = inj.counters.snapshot()
        assert snap.get("chaos_kafka_down", 0) > 0
        assert snap.get("chaos_kafka_produce", 0) > 0
        assert snap.get("chaos_kafka_conn_drop", 0) > 0
        v = side.chaos.check_exactly_once(r, workdir)
        assert v.ok, (name, v.summary(), v.undercounts[:3])
        assert v.exact == v.windows > 0
        kv = side.chaos.check_kafka_edge(counters, require_redeliveries=True,
                                         windows=v)
        assert kv.ok, kv.summary()
        assert kv.sent == kv.delivered == len(events)
        assert eng.events_processed == EVENTS
        out[name] = (side.seen(r), _minus_wallclock(counters.snapshot()),
                     snap, cl.counters.snapshot())
    assert out["port"] == out["jax"]


def test_broker_faults_with_crash_resume_oracle_exact(journal, tmp_path):
    """Broker faults AND a crash script: the supervised engine resumes
    from its checkpoint over the adapter (fresh consumer, seek) and lands
    oracle-exact in both engines; replayed records are honest re-reads,
    so ``delivered >= sent``, and the port's delivered count is exactly
    the acked records plus the records its replay segments cover."""
    workdir, topic, mapping, campaigns, events = journal
    for name in ("jax", "port"):
        side = Side(name)
        inj = side.chaos.FaultInjector(side.plan(_broker_fault_plan(
            crashes=(("batch", 5), ("flush", 1), ("batch", 2)))))
        kb, cl, counters = _setup(side, journal, inj)
        r = side.store(campaigns)
        ckpt = (Checkpointer if name == "port" else JaxCheckpointer)(
            str(tmp_path / f"ckpt-{name}"))
        fr = (FlightRecorder(str(tmp_path / "fr"), capacity=64)
              if name == "port" else None)

        def make_runner():
            return side.runner()(side.engine(CFG, mapping, r),
                                 kb.reader(topic), checkpointer=ckpt,
                                 crash_points=inj.scheduler, flightrec=fr)

        sup = side.chaos.Supervisor(make_runner, backoff_base_ms=1,
                                    backoff_cap_ms=4, seed=1, flightrec=fr)
        st = sup.run(catchup=True)
        assert st.completed, (name, st.errors)
        assert st.crashes >= 2
        sup.runner.engine.close()
        v = side.chaos.check_exactly_once(r, workdir)
        assert v.ok, (name, v.summary(), v.undercounts[:3])
        snap = counters.snapshot()
        assert snap["kafka_consumed"] == \
            snap["kafka_delivered"] + snap.get("kafka_redeliveries", 0)
        assert snap["kafka_produced"] == len(events)
        assert snap["kafka_delivered"] >= len(events)
        assert snap.get("kafka_redeliveries", 0) > 0
        assert sup.runner.engine.events_processed == EVENTS
        if name == "port":
            replayed = sum(hi - lo for lo, hi in st.replay_segments)
            kv = check_kafka_edge(counters, sent=len(events) + replayed,
                                  require_redeliveries=True, windows=v)
            assert kv.ok, kv.summary()


def test_no_kafka_config_keeps_hot_paths_untouched(tmp_path):
    """Default-off pin: no kafka config keeps the file journal, and a
    default fault plan carries zero broker draws."""
    cfg = default_config()
    assert cfg.kafka_bootstrap == "" and cfg.kafka_fake is False
    b = kafka.make_broker(cfg.kafka_bootstrap_servers,
                          str(tmp_path / "j"), fake=cfg.kafka_fake)
    assert isinstance(b, FileBroker)
    plan = FaultPlan.generate(99, sink_rate=0.2, sink_ops=10,
                              journal_rate=0.3, journal_polls=5, crashes=2)
    assert plan.kafka_faults == {} and plan.kafka_down == ()
    inj = FaultInjector(plan)
    assert not any(k.startswith("chaos_kafka")
                   for k in inj.counters.snapshot())


# ----------------------------------------------------------------------
# delivery semantics under faults (tests/test_fakekafka.py:181-300)
# ----------------------------------------------------------------------

def _produce_clean(side, cl, counters, values):
    b = side.broker(cl, counters)
    b.create_topic("t", partitions=1)
    w = b.writer("t")
    w.append_many(values)
    w.flush()
    w.close()


def _poll_fixed(r, rounds=600):
    """Plain ``poll()`` on a FIXED op schedule (no wall clock)."""
    got = []
    for _ in range(rounds):
        try:
            got.extend(r.poll(max_records=8))
        except Exception as e:          # retries exhausted on an empty batch
            assert type(e).__name__ == "FakeKafkaException", e
    return got


def test_conn_drop_redelivery_counted_filtered_never_double_delivered():
    values = [b"r%03d" % i for i in range(80)]
    out = {}
    for name in ("jax", "port"):
        side = Side(name)
        counters = side.counters()
        cl = side.fake.FakeCluster()
        _produce_clean(side, cl, counters, values)
        plan = side.chaos.FaultPlan.generate(
            7, kafka_conn_drop_rate=0.25, kafka_ops=4000)
        cl.attach_chaos(side.chaos.FaultInjector(plan))
        r = side.reader(cl, "t", counters)
        got = _poll_fixed(r)
        r.close()
        assert got == cl._topics["t"][0] == values
        snap = counters.snapshot()
        assert snap.get("kafka_redeliveries", 0) > 0
        assert snap["kafka_consumed"] == \
            snap["kafka_delivered"] + snap["kafka_redeliveries"]
        assert side.chaos.check_kafka_edge(
            counters, require_redeliveries=True).ok
        out[name] = (got, _minus_wallclock(snap))
    assert out["port"] == out["jax"]


def test_writer_dr_fail_redo_lands_every_record():
    values = [b"w%03d" % i for i in range(40)]
    counters = FaultCounters()
    cl = fakekafka.FakeCluster(chaos=FaultInjector(FaultPlan.generate(
        11, kafka_dr_fail_rate=0.2, kafka_ops=4000)))
    b = Side("port").broker(cl, counters)
    b.create_topic("t", partitions=1)
    w = b.writer("t")
    w.append_many(values)
    w.flush()
    w.close()
    snap = counters.snapshot()
    assert snap.get("kafka_dr_failures", 0) > 0
    # dr_fail'd records are re-produced at flush: every record lands
    # exactly once, the failed ones later in the log
    assert sorted(cl._topics["t"][0]) == sorted(values)
    assert snap["kafka_produced"] == len(values)


def test_transient_produce_errors_are_retried_and_counted():
    values = [b"p%03d" % i for i in range(40)]
    counters = FaultCounters()
    cl = fakekafka.FakeCluster(chaos=FaultInjector(FaultPlan.generate(
        3, kafka_produce_rate=0.2, kafka_ops=4000)))
    side = Side("port")
    side.broker(cl, counters).create_topic("t", partitions=1)
    w = side.writer(cl, "t", counters)
    w.append_many(values)
    w.flush()
    w.close()
    snap = counters.snapshot()
    assert snap.get("kafka_produce_retries", 0) > 0
    assert cl._topics["t"][0] == values   # retries preserve submit order
    assert snap["kafka_produced"] == len(values)


def test_broker_down_window_absorbed_by_backoff():
    counters = FaultCounters()
    cl = fakekafka.FakeCluster(chaos=FaultInjector(FaultPlan.generate(
        0, kafka_ops=4000, kafka_down=((2, 6),))))
    side = Side("port")
    side.broker(cl, counters).create_topic("t", partitions=1)
    w = side.writer(cl, "t", counters)
    w.append_many([b"a", b"b", b"c", b"d", b"e"])
    w.flush()
    w.close()
    snap = counters.snapshot()
    assert cl._topics["t"][0] == [b"a", b"b", b"c", b"d", b"e"]
    assert snap.get("kafka_produce_retries", 0) > 0
    assert snap.get("kafka_broker_down_ms", 0) > 0
    assert cl.counters.snapshot().get("fake_kafka_down", 0) > 0


def _faulted_run(side: Side, seed: int):
    """One full produce + consume pass on a FIXED op schedule."""
    values = [b"d%03d" % i for i in range(60)]
    counters = side.counters()
    inj = side.chaos.FaultInjector(side.chaos.FaultPlan.generate(
        seed, kafka_produce_rate=0.1, kafka_consume_rate=0.1,
        kafka_conn_drop_rate=0.1, kafka_dr_fail_rate=0.05,
        kafka_ops=4000))
    cl = side.fake.FakeCluster(chaos=inj)
    side.broker(cl, counters).create_topic("t", partitions=1)
    w = side.writer(cl, "t", counters)
    w.append_many(values)
    w.flush()
    w.close()
    r = side.reader(cl, "t", counters)
    got = _poll_fixed(r)
    r.close()
    return (got, _minus_wallclock(counters.snapshot()),
            inj.counters.snapshot(), cl.counters.snapshot())


@pytest.mark.parametrize("seed", [21, 22])
def test_seeded_faults_are_deterministic_and_equal_the_jax_fake(seed):
    a = _faulted_run(Side("port"), seed)
    assert a == _faulted_run(Side("port"), seed)
    assert a == _faulted_run(Side("jax"), seed)
    assert a[2].get("chaos_kafka_faults", 0) > 0
    v = check_kafka_edge(dict(a[1]), sent=60)
    assert v.ok, v.summary()


def test_rate0_plan_is_byte_identical_and_passthrough():
    base = FaultPlan.generate(5)
    explicit = FaultPlan.generate(5, kafka_produce_rate=0.0,
                                  kafka_consume_rate=0.0,
                                  kafka_dr_fail_rate=0.0,
                                  kafka_conn_drop_rate=0.0,
                                  kafka_ops=0, kafka_down=())
    assert base == explicit
    assert base.kafka_faults == {} and base.kafka_down == ()
    assert FaultPlan.generate(5, kafka_ops=500).kafka_faults == {}
    inj = FaultInjector(FaultPlan.generate(5, kafka_ops=500))
    counters = FaultCounters()
    cl = fakekafka.FakeCluster(chaos=inj)
    b = Side("port").broker(cl, counters)
    b.create_topic("t", partitions=1)
    w = b.writer("t")
    w.append_many([b"a", b"b", b"c"])
    w.flush()
    r = b.reader("t")
    assert r.poll_blocking(timeout_s=5.0) == [b"a", b"b", b"c"]
    assert inj.counters.snapshot() == {}
    assert cl.counters.snapshot() == {}
    snap = counters.snapshot()
    assert snap.get("kafka_redeliveries", 0) == 0
    assert snap.get("kafka_produce_retries", 0) == 0
