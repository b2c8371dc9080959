"""The port's chaos layer (``streambench_tpu_torch.chaos``) against the JAX
package's, unit by unit.

Seeded plans are equal field by field for every knob family; the crash
scheduler's script and reset; the twins of ``tests/test_chaos_inject.py``
(sink faults atomic and scheduled, the native-store probe hidden, journal
faults losing nothing in line and block mode, the zero plan a
pass-through, the multi-reader refused), each wrapper's output equal to
the JAX wrapper's on the same inputs; the supervisor's backoff under one
seed, its give-up and progress rules (the twins of
``tests/test_supervisor.py``) and its catch, which lets a CUDA error
through; the checks' verdicts on the same stores; the runner's chaos
counters in ``RunStats.faults``; and the obs hooks (the twins of
``tests/test_flightrec.py``'s crash and give-up dumps).  All on the CPU.
"""

import dataclasses
import glob
import json
import os
import random

import pytest
import torch

from streambench_tpu import chaos as jax_chaos
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.journal import JournalReader as JaxReader
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu.io.redis_schema import (
    write_windows_pipelined as jax_write,
)
from streambench_tpu.io.resp import RespError as JaxRespError
from streambench_tpu_torch import chaos
from streambench_tpu_torch.chaos import (
    CrashScheduler,
    EngineCrash,
    FaultInjector,
    FaultPlan,
    Supervisor,
)
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.io.fakeredis import FakeRedisStore
from streambench_tpu_torch.io.journal import (
    FileBroker,
    JournalReader,
    JournalWriter,
    MultiReader,
)
from streambench_tpu_torch.io.redis_schema import (
    as_redis,
    seed_campaigns,
    write_windows_pipelined,
)
from streambench_tpu_torch.io.resp import RespError
from streambench_tpu_torch.obs import FlightRecorder

torch.set_num_threads(1)

# ----------------------------------------------------------------------
# plans: one seed and one set of knobs, the same plan in both packages
# ----------------------------------------------------------------------

KNOBS = {
    "sink": dict(sink_rate=0.3, sink_ops=80, sink_outage=(5, 6),
                 sink_partial_rate=0.1),
    "journal": dict(journal_rate=0.35, journal_polls=60),
    "crashes": dict(crashes=6, crash_span=9),
    "broker": dict(kafka_produce_rate=0.08, kafka_consume_rate=0.05,
                   kafka_dr_fail_rate=0.04, kafka_conn_drop_rate=0.12,
                   kafka_ops=500, kafka_down=((20, 28), (90, 95))),
    "fleet": dict(net_drop_rate=0.1, net_delay_rate=0.05, net_delay_ms=7,
                  net_dup_rate=0.05, net_torn_rate=0.05, net_msgs=300,
                  partition_windows=((10, 4),), ship_rate=0.3,
                  ship_ops=40),
    "all": dict(sink_rate=0.12, sink_ops=60, sink_outage=(5, 6),
                sink_partial_rate=0.08, journal_rate=0.4,
                journal_polls=12, crashes=4, net_drop_rate=0.1,
                net_msgs=50, ship_rate=0.2, ship_ops=10,
                kafka_produce_rate=0.08, kafka_conn_drop_rate=0.12,
                kafka_ops=800, kafka_down=((20, 28),)),
}


def _fields(plan) -> dict:
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


@pytest.mark.parametrize("family", sorted(KNOBS))
def test_generated_plans_equal_the_jax_plans_field_by_field(family):
    knobs = KNOBS[family]
    assert [f.name for f in dataclasses.fields(FaultPlan)] == \
        [f.name for f in dataclasses.fields(jax_chaos.FaultPlan)]
    for seed in list(range(24)) + [1234, 2**31 - 1]:
        mine = FaultPlan.generate(seed, **knobs)
        ref = jax_chaos.FaultPlan.generate(seed, **knobs)
        assert _fields(mine) == _fields(ref), (family, seed)
        assert mine.is_zero == ref.is_zero is False


def test_zero_and_default_plans():
    assert FaultPlan.zeros().is_zero and FaultPlan.generate(5).is_zero
    assert _fields(FaultPlan.generate(5, kafka_ops=500)) == \
        _fields(jax_chaos.FaultPlan.generate(5, kafka_ops=500))
    a = FaultPlan.generate(42, sink_rate=0.3, sink_ops=50,
                           journal_rate=0.3, journal_polls=50, crashes=5)
    assert a == FaultPlan.generate(42, sink_rate=0.3, sink_ops=50,
                                   journal_rate=0.3, journal_polls=50,
                                   crashes=5)
    assert a != FaultPlan.generate(43, sink_rate=0.3, sink_ops=50,
                                   journal_rate=0.3, journal_polls=50,
                                   crashes=5)


def test_crash_scheduler_script_and_reset():
    sched = CrashScheduler([("batch", 2), ("flush", 1)])
    sched.point("batch")                     # batch #1: armed at #2
    with pytest.raises(EngineCrash):
        sched.point("batch")
    assert sched.remaining == 1
    sched.reset()                            # restart: counts restart
    sched.point("batch")                     # not a flush: no crash
    with pytest.raises(EngineCrash):
        sched.point("flush")
    assert sched.exhausted
    for _ in range(5):                       # exhausted: never raises again
        sched.point("batch")
        sched.point("flush")
    assert sched.counters.get("crashes_injected") == 2
    with pytest.raises(ValueError):
        CrashScheduler([("drain", 1)])


def test_crash_scheduler_raises_where_the_jax_one_does():
    """One generated script, one boundary sequence: both schedulers raise
    at the same boundaries with the same message."""
    rng = random.Random(3)
    kinds = [rng.choice(("batch", "batch", "flush", "checkpoint"))
             for _ in range(400)]
    script = FaultPlan.generate(9, crashes=8).crashes
    out = []
    for sched in (CrashScheduler(script),
                  jax_chaos.CrashScheduler(script)):
        got = []
        for i, kind in enumerate(kinds):
            if i % 37 == 0:
                sched.reset()
            try:
                sched.point(kind)
            except (EngineCrash, jax_chaos.EngineCrash) as e:
                got.append((i, str(e)))
        out.append(got)
    assert out[0] == out[1] and len(out[0]) == len(script)


# ----------------------------------------------------------------------
# the wrappers (twins of tests/test_chaos_inject.py)
# ----------------------------------------------------------------------

def test_sink_faults_are_atomic_and_scheduled():
    """A faulted op raises the mapped error and forwards nothing; clean
    ops pass through untouched."""
    store = FakeRedisStore()
    plan = FaultPlan(sink_faults={0: "refused", 2: "timeout", 3: "resp"})
    proxy = FaultInjector(plan).wrap_redis(as_redis(store))
    with pytest.raises(ConnectionRefusedError):
        proxy.execute("SET", "k", "v")
    assert store.get("k") is None            # nothing applied
    assert proxy.execute("SET", "k", "v") == "OK"   # op 1: clean
    with pytest.raises(TimeoutError):
        proxy.pipeline_execute([("SET", "k", "w")])
    with pytest.raises(RespError):
        proxy.execute("GET", "k")
    assert store.get("k") == "v"             # only the clean op landed
    assert proxy.execute("GET", "k") == "v"


def _sink_trace(pkg: str, plan_kw: dict) -> tuple:
    """Ops through each package's sink proxy: what each raised and the
    store's contents after, with a partial pipeline in the mix."""
    if pkg == "jax":
        inj = jax_chaos.FaultInjector(jax_chaos.FaultPlan(**plan_kw))
        store = JaxStore()
        proxy = inj.wrap_redis(jax_as_redis(store))
        resp_err = JaxRespError
    else:
        inj = FaultInjector(FaultPlan(**plan_kw))
        store = FakeRedisStore()
        proxy = inj.wrap_redis(as_redis(store))
        resp_err = RespError
    out = []
    for i in range(12):
        try:
            if i % 3:
                proxy.pipeline_execute([("HINCRBY", "h", f"f{j}", i)
                                        for j in range(4)])
            else:
                proxy.execute("HINCRBY", "h", "single", i)
            out.append("ok")
        except ConnectionRefusedError:
            out.append("refused")
        except TimeoutError as e:
            out.append(f"timeout:{e}")
        except resp_err as e:
            out.append(f"resp:{e}")
    return out, proxy.execute("HGETALL", "h"), inj.counters.snapshot()


def test_sink_proxy_matches_the_jax_proxy():
    plan_kw = dict(sink_faults={0: "partial", 1: "refused", 2: "partial",
                                4: "timeout", 7: "resp", 9: "partial"})
    assert _sink_trace("port", plan_kw) == _sink_trace("jax", plan_kw)


def test_sink_proxy_hides_native_store_probe():
    """The engine's ``redis._store`` probe must miss, or flushes would
    bypass the faultable path through the in-C bulk writeback."""
    proxy = FaultInjector(FaultPlan.zeros()).wrap_redis(
        as_redis(FakeRedisStore()))
    assert getattr(proxy, "_store", None) is None


def test_faulted_engine_flush_goes_through_the_proxy():
    """The engine's native-table probe sees no store behind the proxy, so
    its flush rides the faultable pipeline: a scheduled refusal is
    counted by the writer, retried, and the counts land once."""
    mapping = {f"ad{i}": f"camp{i % 3}" for i in range(9)}
    store = as_redis(FakeRedisStore())
    seed_campaigns(store, ["camp0", "camp1", "camp2"])
    inj = FaultInjector(FaultPlan(sink_faults={0: "refused"}))
    eng = AdAnalyticsEngine(
        default_config(jax_batch_size=64, jax_sink_retry_base_ms=1,
                       jax_sink_retry_cap_ms=2),
        mapping, redis=inj.wrap_redis(store), device="cpu")
    assert eng._native_table() is None
    eng.process_chunk([json.dumps({
        "user_id": "u", "page_id": "p", "ad_id": f"ad{i % 9}",
        "ad_type": "banner", "event_type": "view",
        "event_time": str(1_000_000 + i), "ip_address": "1.2.3.4"}).encode()
        for i in range(90)])
    eng.close()
    assert inj.counters.get("chaos_sink_faults") == 1
    assert eng.faults.get("sink_errors") == 1
    from streambench_tpu_torch.io.redis_schema import read_seen_counts

    assert sum(sum(per.values())
               for per in read_seen_counts(store).values()) == 90


def _write_topic(tmp_path, n=50):
    path = str(tmp_path / "t.jsonl")
    lines = [f'{{"rec": {i}, "pad": "{"x" * 40}"}}'.encode()
             for i in range(n)]
    with JournalWriter(path) as w:
        w.append_many(lines)
    return path, lines


def _read_all(reader, block: bool, size: int, end: int) -> list[bytes]:
    """Every line the polls hand back, garbage included, in order, until
    the reader's offset reaches ``end``."""
    out = []
    for _ in range(200):
        if block:
            data = reader.poll_block(size)
            out += [line for line in data.split(b"\n") if line]
        else:
            out += reader.poll(size)
        if reader.offset == end:
            break
    return out


@pytest.mark.parametrize("block", [False, True], ids=["line", "block"])
@pytest.mark.parametrize("kind", ["truncated", "torn", "corrupt"])
def test_journal_faults_lose_nothing(tmp_path, kind, block):
    """Reading the whole topic through a faulting wrapper yields every
    original record exactly once; the damage is NUL-marked garbage that
    never parses, delivered exactly as the JAX wrapper delivers it."""
    path, lines = _write_topic(tmp_path)
    faults = {0: kind, 2: kind, 3: kind}
    inj = FaultInjector(FaultPlan(journal_faults=faults))
    size, end = (512 if block else 8), os.path.getsize(path)
    got = _read_all(inj.wrap_reader(JournalReader(path)), block, size, end)
    ref = _read_all(jax_chaos.FaultInjector(jax_chaos.FaultPlan(
        journal_faults=faults)).wrap_reader(JaxReader(path)), block, size,
        end)
    assert got == ref
    assert [line for line in got if b"\x00" not in line] == lines
    garbage = [line for line in got if b"\x00" in line]
    assert inj.counters.get("journal_faults") == 3
    if kind != "truncated":
        assert garbage                       # damage was actually delivered
    for g in garbage:
        with pytest.raises(ValueError):
            json.loads(g)


def test_zero_plan_wrappers_are_passthrough(tmp_path):
    path, lines = _write_topic(tmp_path, n=10)
    inj = FaultInjector(FaultPlan.zeros())
    r = inj.wrap_reader(JournalReader(path))
    assert r.poll(100) == lines
    r2 = inj.wrap_reader(JournalReader(path))
    with open(path, "rb") as f:
        assert r2.poll_block(1 << 20) == f.read()
    assert inj.counters.snapshot() == {}
    store = FakeRedisStore()
    proxy = inj.wrap_redis(as_redis(store))
    assert proxy.execute("SET", "a", "1") == "OK"
    assert store.get("a") == "1"


def test_wrap_reader_rejects_multireader(tmp_path):
    broker = FileBroker(str(tmp_path / "b"))
    broker.create_topic("t", partitions=2)
    with pytest.raises(TypeError):
        FaultInjector(FaultPlan.zeros()).wrap_reader(
            MultiReader([broker.reader("t", 0), broker.reader("t", 1)]))


def test_kafka_draws_match_the_jax_injector():
    plan_kw = KNOBS["broker"]
    mine = FaultInjector(FaultPlan.generate(77, **plan_kw))
    ref = jax_chaos.FaultInjector(jax_chaos.FaultPlan.generate(77, **plan_kw))
    assert [mine.kafka_fault() for _ in range(600)] == \
        [ref.kafka_fault() for _ in range(600)]
    assert mine.counters.snapshot() == ref.counters.snapshot()


# ----------------------------------------------------------------------
# the supervisor (twins of tests/test_supervisor.py:105-231)
# ----------------------------------------------------------------------

def _wedged(calls):
    class _Runner:
        crash_points = None

        def resume(self):
            return False

        def _reader_position(self):
            return 0            # never advances

        def run_catchup(self, **kw):
            calls["n"] += 1
            raise EngineCrash("wedged at the same offset")

        def run(self, **kw):
            return self.run_catchup(**kw)
    return _Runner


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_backoff_sequence_equals_the_jax_supervisor(seed):
    """Same seed, same crash loop: the same sleeps, the same stats."""
    out = []
    for sup_cls, crash in ((Supervisor, EngineCrash),
                           (jax_chaos.Supervisor, jax_chaos.EngineCrash)):
        calls = {"n": 0}
        runner = _wedged(calls)
        if crash is not EngineCrash:
            def run_catchup(self, **kw):
                calls["n"] += 1
                raise jax_chaos.EngineCrash("wedged at the same offset")
            runner.run_catchup = run_catchup
        slept = []
        sup = sup_cls(runner, max_no_progress_restarts=6,
                      backoff_base_ms=3, backoff_cap_ms=40, seed=seed,
                      sleep=slept.append)
        st = sup.run(catchup=True)
        out.append((slept, st.attempts, st.crashes, st.restarts,
                    st.gave_up, st.backoff_ms_total, st.replay_segments,
                    st.errors, calls["n"]))
    assert out[0] == out[1]


def test_supervisor_gives_up_after_no_progress():
    """A crash loop that never advances the checkpoint ends in a clean
    give-up after exactly N consecutive no-progress restarts."""
    calls = {"n": 0}
    slept = []
    sup = Supervisor(_wedged(calls), max_no_progress_restarts=3,
                     backoff_base_ms=8, backoff_cap_ms=32, seed=0,
                     sleep=slept.append)
    st = sup.run(catchup=True)
    assert st.gave_up and not st.completed
    # first crash sets the baseline; 3 more at the same offset give up
    assert calls["n"] == 4 and st.crashes == 4 and st.restarts == 3
    assert len(slept) == 3
    assert all(0.004 <= s <= 0.032 for s in slept)


def test_supervisor_progress_resets_giveup_counter():
    """Crashes whose checkpoint ADVANCED reset the no-progress streak."""
    class _Ckpt:
        def __init__(self):
            self.offset = 0

        def load(self):
            class _Snap:
                pass
            s = _Snap()
            s.offset = self.offset
            return s if self.offset else None

    ckpt = _Ckpt()
    seq = iter([10, 20, 30, 40])

    class _Runner:
        crash_points = None
        checkpointer = ckpt

        def resume(self):
            return False

        def _reader_position(self):
            return ckpt.offset

        def run_catchup(self, **kw):
            ckpt.offset = next(seq)
            raise EngineCrash("crash with progress")

    made = {"n": 0}

    def factory():
        made["n"] += 1
        r = _Runner()
        if made["n"] == 5:                       # attempt 5 completes
            r.run_catchup = lambda **kw: "done"
        return r

    sup = Supervisor(factory, max_no_progress_restarts=2,
                     backoff_base_ms=0, backoff_cap_ms=0, seed=0)
    st = sup.run(catchup=True)
    assert st.completed and not st.gave_up
    assert st.crashes == 4 and st.restarts == 4


def test_supervisor_counts_checkpoint_then_crash_as_progress():
    """A crash right after a checkpoint is durable progress at THAT
    crash: three no-checkpoint crashes followed by a checkpoint-boundary
    crash must not give up."""
    class _Ckpt:
        offset = 0

        def load(self):
            if not self.offset:
                return None

            class _S:
                offset = self.offset
            return _S()

    ckpt = _Ckpt()
    attempt = {"n": 0}

    class _Runner:
        crash_points = None
        checkpointer = ckpt

        def resume(self):
            return False

        def _reader_position(self):
            return ckpt.offset

        def run_catchup(self, **kw):
            attempt["n"] += 1
            if attempt["n"] <= 3:
                raise EngineCrash("before any checkpoint")
            if attempt["n"] == 4:
                ckpt.offset = 999           # saved, THEN crashed
                raise EngineCrash("at the checkpoint boundary")
            return "done"

    sup = Supervisor(lambda: _Runner(), max_no_progress_restarts=3,
                     backoff_base_ms=0, backoff_cap_ms=0, seed=0)
    st = sup.run(catchup=True)
    assert st.completed and not st.gave_up
    assert st.crashes == 4


@pytest.mark.parametrize("err", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
    AssertionError("schema mismatch")], ids=["cuda", "oom", "assert"])
def test_device_errors_propagate_and_are_never_restarted(err):
    """The catch is the reference's: only the simulated crash and
    connection-shaped errors restart; a device error ends the run."""
    assert Supervisor(lambda: None).catch == (EngineCrash, ConnectionError,
                                              TimeoutError)
    made = {"n": 0}

    class _Runner:
        crash_points = None

        def resume(self):
            return False

        def run_catchup(self, **kw):
            raise err

    def factory():
        made["n"] += 1
        return _Runner()

    sup = Supervisor(factory, seed=0, sleep=lambda s: None)
    with pytest.raises(type(err)):
        sup.run(catchup=True)
    assert made["n"] == 1 and sup.stats.crashes == 0


# ----------------------------------------------------------------------
# the checks: the same verdicts as the JAX package's on the same stores
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def verdict_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("verdicts")
    cfg = default_config(jax_batch_size=256)
    broker = FileBroker(str(tmp / "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=3_000,
                 rng=random.Random(5), workdir=str(tmp))
    campaigns, _ = gen.load_ids(str(tmp))
    oracle = gen.dostats(str(tmp))
    rows = [(c, b * 10_000, n) for c, per in sorted(oracle.items())
            for b, n in sorted(per.items())]
    return tmp, broker.topic_path(cfg.kafka_topic), campaigns, rows


def _perturbed(rows, seed):
    """The oracle's rows with some counts moved up or down and one
    window dropped, one added."""
    rng = random.Random(seed)
    out = []
    for c, ts, n in rows:
        roll = rng.random()
        if roll < 0.1:
            n += rng.randrange(1, 4)
        elif roll < 0.15:
            n = max(n - rng.randrange(1, 3), 0)
        elif roll < 0.17:
            continue
        out.append((c, ts, n))
    out.append((rows[0][0], rows[-1][1] + 10_000, 2))
    return out


def _stores(campaigns, rows):
    j = jax_as_redis(JaxStore())
    jax_seed(j, campaigns)
    jax_write(j, rows, time_updated=0)
    p = as_redis(FakeRedisStore())
    seed_campaigns(p, campaigns)
    write_windows_pipelined(p, rows, time_updated=0)
    return j, p


def _verdict(v) -> tuple:
    return (v.ok, v.windows, v.exact, v.within_bound, v.undercounts,
            v.overcounts, v.max_overcount, v.repro)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_check_verdicts_equal_the_jax_checks(verdict_data, seed):
    tmp, topic, campaigns, rows = verdict_data
    j, p = _stores(campaigns, _perturbed(rows, seed) if seed else rows)
    size = os.path.getsize(topic)
    segments = [(0, size // 3), (size // 4, size // 2 + 17)]
    carried = {(rows[1][0], rows[1][1]): 3}
    note = chaos.replay_note(seed=seed, topic_path=topic,
                             overrides={"jax.batch.size": 256})
    assert note == jax_chaos.replay_note(seed=seed, topic_path=topic,
                                         overrides={"jax.batch.size": 256})
    mine = chaos.check_exactly_once(p, str(tmp), repro=note)
    ref = jax_chaos.check_exactly_once(j, str(tmp), repro=note)
    assert _verdict(mine) == _verdict(ref) and mine.summary() == \
        ref.summary()
    assert mine.ok == (seed == 0)
    mine = chaos.check_at_least_once(p, str(tmp), topic, segments, carried)
    ref = jax_chaos.check_at_least_once(j, str(tmp), topic, segments,
                                        carried)
    assert _verdict(mine) == _verdict(ref)
    mapping = gen.load_ad_mapping_file(
        os.path.join(str(tmp), gen.AD_TO_CAMPAIGN_FILE))
    assert chaos.segment_view_counts(topic, segments, mapping) == \
        jax_chaos.segment_view_counts(topic, segments, mapping)


@pytest.mark.parametrize("snap", [
    {"kafka_produced": 10, "kafka_consumed": 12, "kafka_delivered": 10,
     "kafka_redeliveries": 2},
    {"kafka_produced": 10, "kafka_consumed": 12, "kafka_delivered": 9,
     "kafka_redeliveries": 2},
    {"kafka_produced": 10, "kafka_consumed": 9, "kafka_delivered": 9},
    {"kafka_produced": 5, "kafka_consumed": 5, "kafka_delivered": 5}])
def test_kafka_edge_verdicts_equal_the_jax_check(snap):
    for require in (False, True):
        mine = chaos.check_kafka_edge(snap, require_redeliveries=require)
        ref = jax_chaos.check_kafka_edge(snap, require_redeliveries=require)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.summary() == ref.summary()


# ----------------------------------------------------------------------
# the runner: crash points and chaos counters; the obs hooks
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run")
    cfg = default_config(jax_batch_size=256, jax_scan_batches=2)
    broker = FileBroker(str(tmp / "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=4_000,
                 rng=random.Random(5), workdir=str(tmp))
    mapping = gen.load_ad_mapping_file(str(tmp / gen.AD_TO_CAMPAIGN_FILE))
    campaigns, _ = gen.load_ids(str(tmp))
    return tmp, cfg, broker, mapping, campaigns


def _engine(cfg, mapping, campaigns, redis=None):
    r = redis
    if r is None:
        r = as_redis(FakeRedisStore())
        seed_campaigns(r, campaigns)
    return AdAnalyticsEngine(cfg, mapping, redis=r, device="cpu")


@pytest.mark.parametrize("block", [True, False], ids=["block", "line"])
def test_run_stats_carry_the_wrapped_readers_chaos_counters(small_run,
                                                            block):
    tmp, cfg, broker, mapping, campaigns = small_run
    if not block:
        cfg = dataclasses.replace(cfg, jax_use_native_encoder=False)
    inj = FaultInjector(FaultPlan(journal_faults={0: "torn", 1: "corrupt",
                                                  3: "truncated"}))
    eng = _engine(cfg, mapping, campaigns)
    runner = StreamRunner(eng, inj.wrap_reader(broker.reader(
        cfg.kafka_topic)))
    assert runner._block_mode() is block
    st = runner.run_catchup()
    eng.close()
    assert st.faults["journal_faults"] == 3
    assert st.faults["bad_lines"] == 2       # the torn page, the corrupt copy
    assert eng.events_processed == 4_000


def _load(path):
    return [json.loads(line) for line in open(path)]


def _assert_monotonic(recs):
    seqs = [r["seq"] for r in recs]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


def test_runner_crash_via_fault_plan_leaves_black_box(small_run, tmp_path):
    """A crash from a FaultPlan leaves ``flight_crash.jsonl``, records in
    order, the terminal fault last."""
    _, cfg, broker, mapping, campaigns = small_run
    eng = _engine(cfg, mapping, campaigns)
    fr = FlightRecorder(str(tmp_path), capacity=64)
    plan = FaultPlan(crashes=(("batch", 2),))
    runner = StreamRunner(eng, broker.reader(cfg.kafka_topic),
                          crash_points=CrashScheduler(plan.crashes),
                          flightrec=fr)
    with pytest.raises(EngineCrash):
        runner.run_catchup()
    files = glob.glob(str(tmp_path / "flight_*.jsonl"))
    assert len(files) == 1 and files[0].endswith("flight_crash.jsonl")
    recs = _load(files[0])
    _assert_monotonic(recs)
    last = recs[-1]
    assert last["kind"] == "fault" and last["event"] == "crash"
    assert "EngineCrash" in last["error"]
    assert last["offset"] > 0 and last["events"] > 0
    assert last["batches"] == 2


def test_supervisor_give_up_dumps_terminal_fault(tmp_path):
    """A supervised run that dies for good leaves
    ``flight_give_up.jsonl``: the crash/restart history, the give-up
    fault last; the sampler gets the same events as annotations."""

    class CrashingRunner:
        checkpointer = None
        crash_points = None

        def resume(self):
            return False

        def _reader_position(self):
            return 10

        def run(self, **kw):
            raise EngineCrash("boom")

    class _Sampler:
        def __init__(self):
            self.events = []

        def annotate(self, event, **fields):
            self.events.append((event, fields))

    fr = FlightRecorder(str(tmp_path), capacity=32)
    sampler = _Sampler()
    sup = Supervisor(CrashingRunner, max_no_progress_restarts=2,
                     backoff_base_ms=0, sleep=lambda s: None,
                     flightrec=fr, sampler=sampler)
    st = sup.run()
    assert st.gave_up
    files = glob.glob(str(tmp_path / "flight_*.jsonl"))
    assert files == [str(tmp_path / "flight_give_up.jsonl")]
    recs = _load(files[0])
    _assert_monotonic(recs)
    events = [(r["kind"], r.get("event")) for r in recs]
    assert ("supervisor", "crash") in events
    assert ("supervisor", "restart") in events
    last = recs[-1]
    assert last["kind"] == "fault" and last["event"] == "give_up"
    assert "EngineCrash" in last["error"]
    assert last["crashes"] == st.crashes
    assert [e for e, _ in sampler.events] == [
        "crash", "restart", "crash", "restart", "crash", "give_up"]


def test_resume_record_reaches_sampler_and_flight_ring(small_run,
                                                       tmp_path):
    """Under exactly-once a resume writes its restored fence into the
    sampler and the flight ring (the supervisor's ``resume`` event)."""
    _, cfg, broker, mapping, campaigns = small_run
    cfg = dataclasses.replace(cfg, jax_sink_exactly_once=True,
                              jax_sink_retry_base_ms=1,
                              jax_sink_retry_cap_ms=2, redis_hashtable="")
    r = as_redis(FakeRedisStore())
    seed_campaigns(r, campaigns)
    inj = FaultInjector(FaultPlan(crashes=(("checkpoint", 1),)))
    fr = FlightRecorder(str(tmp_path), capacity=128)
    from streambench_tpu_torch.checkpoint import Checkpointer

    ckpt = Checkpointer(str(tmp_path / "ck"))
    annotated = []

    class _Sampler:
        def annotate(self, event, **fields):
            annotated.append((event, fields))

    def make_runner():
        return StreamRunner(_engine(cfg, mapping, campaigns, r),
                            inj.wrap_reader(broker.reader(cfg.kafka_topic)),
                            checkpointer=ckpt, crash_points=inj.scheduler,
                            flightrec=fr)

    sup = Supervisor(make_runner, backoff_base_ms=0, seed=0,
                     sleep=lambda s: None, flightrec=fr,
                     sampler=_Sampler())
    st = sup.run(catchup=True)
    sup.runner.engine.close()
    assert st.completed and st.crashes == 1
    resume = [f for e, f in annotated if e == "resume"]
    assert len(resume) == 1 and resume[0]["fence_epoch"] >= 1
    ring = [rec for rec in fr.snapshot() if rec.get("event") == "resume"]
    assert ring and ring[0]["kind"] == "supervisor"
    assert chaos.check_exactly_once(r, str(small_run[0])).ok


def test_crashed_engine_is_freed_while_its_writer_drains(small_run):
    """An engine abandoned without close() (a supervised crash) leaves
    its writer thread alive, as the reference's zombie writer; the
    thread holds the engine weakly, so the engine and its device state
    are freed once nothing else refers to them, and the writer's landed
    rows are still applied."""
    import gc
    import weakref

    _, cfg, broker, mapping, campaigns = small_run
    r = as_redis(FakeRedisStore())
    seed_campaigns(r, campaigns)
    eng = _engine(cfg, mapping, campaigns, r)
    runner = StreamRunner(eng, broker.reader(cfg.kafka_topic),
                          crash_points=CrashScheduler((("flush", 1),)))
    with pytest.raises(EngineCrash):
        runner.run_catchup()          # crashes right after the final flush
    writer, ref = eng._writer, weakref.ref(eng)
    del eng, runner
    gc.collect()
    assert ref() is None
    assert writer._thread.is_alive()
    writer.drain()
    assert chaos.check_exactly_once(r, str(small_run[0])).ok
