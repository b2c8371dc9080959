"""Supervised crash recovery of the port's engine, against the JAX engine's.

The reference's supervised runs (``tests/test_chaos_recovery.py``, the
supervised half of ``tests/test_exactly_once.py``, the fast randomized
seeds of ``tests/test_supervisor.py`` and ``tests/test_exactly_once.py``,
and the device-decode sweep of ``tests/test_devdecode.py``) through the
port's engine and chaos layer, each with the same plan through the JAX
engine and the JAX chaos layer on the same journal.  Both must be exact
under ``jax.sink.exactly_once`` and within ``check_at_least_once``'s
bound otherwise.  Where a script crashes only at batch boundaries and no
flush or checkpoint depends on the clock, the two runs must also leave
equal windows and equal ``SupervisorStats``: a flush or checkpoint crash
lands where the wall clock puts the periodic flushes, which differs
between the engines.  One cross-engine case resumes a snapshot left by a
crashed JAX attempt in the port's supervised run.  All on the CPU.
"""

import dataclasses
import random
import threading

import pytest
import torch

from streambench_tpu import chaos as jax_chaos
from streambench_tpu.checkpoint import Checkpointer as JaxCheckpointer
from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import AdAnalyticsEngine as JaxEngine
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu.obs import FlightRecorder as JaxFlightRecorder
from streambench_tpu_torch import chaos
from streambench_tpu_torch.chaos import FaultPlan
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.io.fakeredis import FakeRedisStore
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    as_redis,
    read_seen_counts,
    seed_campaigns,
)
from streambench_tpu_torch.obs import FlightRecorder

torch.set_num_threads(1)

XO = {"jax_sink_exactly_once": True}
# every flush but the final one off the clock: crash points and sink ops
# then fall where the journal puts them, in either engine
QUIET = {"jax_flush_interval_ms": 10**9}


@dataclasses.dataclass
class Data:
    workdir: str
    topic: str
    mapping: dict
    campaigns: list
    events: int


def make_data(tmp, events: int, seed: int) -> Data:
    """The generator's journal and oracle in ``tmp``, read by both
    engines (the same bytes)."""
    cfg = default_config()
    broker = FileBroker(str(tmp / "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=events,
                 rng=random.Random(seed), workdir=str(tmp))
    return Data(str(tmp), cfg.kafka_topic,
                gen.load_ad_mapping_file(str(tmp / gen.AD_TO_CAMPAIGN_FILE)),
                gen.load_ids(str(tmp))[0], events)


@pytest.fixture(scope="module")
def data12k(tmp_path_factory):
    return make_data(tmp_path_factory.mktemp("c12k"), 12_000, 7)


@pytest.fixture(scope="module")
def data6k(tmp_path_factory):
    return make_data(tmp_path_factory.mktemp("c6k"), 6_000, 7)


@pytest.fixture(scope="module")
def sweep_data(tmp_path_factory):
    return make_data(tmp_path_factory.mktemp("sweep"), 6_000, 11)


class Side:
    """One engine and its chaos layer: the JAX package's or the port's."""

    def __init__(self, name: str):
        self.name = name
        jax = name == "jax"
        self.chaos = jax_chaos if jax else chaos
        self.config = jax_default_config if jax else default_config
        self.broker = JaxBroker if jax else FileBroker
        self.checkpointer = JaxCheckpointer if jax else Checkpointer
        self.runner = JaxRunner if jax else StreamRunner
        self.flightrec = JaxFlightRecorder if jax else FlightRecorder
        self.seen = jax_seen if jax else read_seen_counts
        self._jax = jax

    def plan(self, plan: FaultPlan):
        """The same plan, as this side's ``FaultPlan``."""
        return self.chaos.FaultPlan(**{
            f.name: getattr(plan, f.name)
            for f in dataclasses.fields(FaultPlan)})

    def store(self, campaigns):
        if self._jax:
            r = jax_as_redis(JaxStore())
            jax_seed(r, campaigns)
        else:
            r = as_redis(FakeRedisStore())
            seed_campaigns(r, campaigns)
        return r

    def engine(self, cfg, mapping, redis):
        if self._jax:
            return JaxEngine(cfg, mapping, redis=redis)
        return AdAnalyticsEngine(cfg, mapping, redis=redis, device="cpu")


SIDES = ("jax", "port")


@dataclasses.dataclass
class Run:
    st: object
    inj: object
    sup: object
    r: object
    engines: list


def supervise(side: Side, data: Data, plan: FaultPlan, ckpt_dir, *,
              seed: int = 1, max_no_progress: int = 3, flightrec=None,
              backoff_cap_ms: float = 4, r=None, **cfg_over) -> Run:
    """One supervised catchup of ``data`` under ``plan`` through ``side``:
    a fresh engine, wrapped reader and runner per attempt."""
    cfg = side.config(jax_batch_size=256, jax_scan_batches=2,
                      jax_sink_retry_base_ms=1, jax_sink_retry_cap_ms=4,
                      **cfg_over)
    r = side.store(data.campaigns) if r is None else r
    inj = side.chaos.FaultInjector(side.plan(plan))
    ckpt = side.checkpointer(str(ckpt_dir))
    broker = side.broker(data.workdir + "/broker")
    engines = []

    def make_runner():
        eng = side.engine(cfg, data.mapping, inj.wrap_redis(r))
        engines.append(eng)
        return side.runner(eng, inj.wrap_reader(broker.reader(data.topic)),
                           checkpointer=ckpt, crash_points=inj.scheduler,
                           flightrec=flightrec)

    sup = side.chaos.Supervisor(make_runner, backoff_base_ms=1,
                                backoff_cap_ms=backoff_cap_ms, seed=seed,
                                max_no_progress_restarts=max_no_progress,
                                flightrec=flightrec)
    st = sup.run(catchup=True)
    assert st.completed and not st.gave_up, (side.name, st.errors)
    sup.runner.engine.close()
    return Run(st, inj, sup, r, engines)


def at_least_once(side: Side, data: Data, run: Run, repro=None):
    v = side.chaos.check_at_least_once(
        run.r, data.workdir, _topic(data), run.st.replay_segments,
        run.st.carried, repro=repro)
    assert v.ok, (side.name, v.summary(), v.undercounts[:3],
                  v.overcounts[:3])
    assert v.windows > 0
    return v


def exactly_once(side: Side, data: Data, run: Run, repro=None):
    v = side.chaos.check_exactly_once(run.r, data.workdir, repro=repro)
    assert v.ok, (side.name, v.summary(), v.undercounts[:3],
                  v.overcounts[:3])
    assert v.exact == v.windows > 0
    return v


def stats_of(st) -> tuple:
    """The supervisor's record of a run, comparable across packages."""
    return (st.attempts, st.crashes, st.restarts, st.gave_up,
            st.backoff_ms_total, st.replay_segments, st.carried, st.errors)


def acceptance_plan(xo: bool) -> FaultPlan:
    """The reference's acceptance faults (sink outage and scattered
    errors, torn/truncated/corrupt journal reads) with its explicit
    four-crash script; under exactly-once the denser, wider sink index
    window with partial applies."""
    if xo:
        plan = FaultPlan.generate(1234, sink_rate=0.12, sink_ops=60,
                                  sink_outage=(5, 6), sink_partial_rate=0.08,
                                  journal_rate=0.4, journal_polls=12)
    else:
        plan = FaultPlan.generate(1234, sink_rate=0.25, sink_ops=30,
                                  sink_outage=(5, 6), journal_rate=0.4,
                                  journal_polls=12)
    return FaultPlan(seed=plan.seed, sink_faults=plan.sink_faults,
                     journal_faults=plan.journal_faults,
                     crashes=(("batch", 5), ("flush", 1), ("batch", 2),
                              ("checkpoint", 1)))


def _topic(data: Data) -> str:
    return FileBroker(data.workdir + "/broker").topic_path(data.topic)


# ----------------------------------------------------------------------
# at-least-once (tests/test_chaos_recovery.py)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_all_three_surfaces_within_oracle_bounds(data12k, tmp_path,
                                                 pipeline):
    """The acceptance run, serial and with the staged ingest pipeline
    (crashes land while the stages hold prefetched blocks): every window
    within the bound in both engines, the whole journal folded."""
    plan = acceptance_plan(xo=False)
    for name in SIDES:
        side = Side(name)
        run = supervise(side, data12k, plan, tmp_path / name,
                        jax_ingest_pipeline=pipeline)
        assert run.st.crashes >= 3
        assert run.inj.counters.get("chaos_sink_faults") > 0
        assert run.inj.counters.get("journal_faults") > 0
        at_least_once(side, data12k, run, side.chaos.replay_note(
            seed=plan.seed, topic_path=_topic(data12k)))
        assert run.sup.runner.engine.events_processed == 12_000
        if pipeline == "on":
            assert run.sup.runner._pipeline is not None
            # every crashed attempt's stage threads stopped before the
            # next attempt read the journal
            assert not [t for t in threading.enumerate()
                        if t.name.startswith("ingest-")]


def test_crash_between_flush_and_checkpoint_overcounts_within_bound(
        data6k, tmp_path):
    """The documented replay window, hit on purpose: a crash right after
    the final flush landed and before its snapshot.  The replayed counts
    exceed the oracle inside the recorded bound, in both engines."""
    plan = FaultPlan(crashes=(("batch", 3), ("flush", 1)))
    for name in SIDES:
        side = Side(name)
        run = supervise(side, data6k, plan, tmp_path / name, **QUIET)
        assert run.st.crashes == 2
        v = at_least_once(side, data6k, run)
        assert v.within_bound > 0 and v.max_overcount > 0


def test_zero_plan_is_exact_passthrough(data6k, tmp_path):
    """The chaos layer with the zero plan is the plain run: the same
    windows and run accounting as the port without it, and as the JAX
    engine with it."""
    cfg = default_config(jax_batch_size=256, jax_scan_batches=2)
    r = as_redis(FakeRedisStore())
    seed_campaigns(r, data6k.campaigns)
    plain = AdAnalyticsEngine(cfg, data6k.mapping, redis=r, device="cpu")
    broker = FileBroker(data6k.workdir + "/broker")
    ps = StreamRunner(plain, broker.reader(data6k.topic)).run_catchup()
    plain.close()
    out = {}
    for name in SIDES:
        side = Side(name)
        cfg = side.config(jax_batch_size=256, jax_scan_batches=2)
        r2 = side.store(data6k.campaigns)
        inj = side.chaos.FaultInjector(side.chaos.FaultPlan.zeros())
        eng = side.engine(cfg, data6k.mapping, inj.wrap_redis(r2))
        cs = side.runner(eng, inj.wrap_reader(side.broker(
            data6k.workdir + "/broker").reader(data6k.topic)),
            crash_points=inj.scheduler).run_catchup()
        eng.close()
        assert inj.counters.snapshot() == {}
        out[name] = (side.seen(r2), cs.events, cs.batches,
                     cs.windows_written, cs.faults)
    assert out["port"] == out["jax"] == (read_seen_counts(r), ps.events,
                                         ps.batches, ps.windows_written, {})


def test_sink_outage_only_recovers_exactly(data6k, tmp_path):
    """A pure sink outage, no crashes: retained batches, backoff and
    reconnect until it lifts; oracle-exact, the same faults in both."""
    plan = FaultPlan(sink_faults={i: "refused" for i in range(8)})
    faults = {}
    for name in SIDES:
        side = Side(name)
        run = supervise(side, data6k, plan, tmp_path / name)
        assert run.st.crashes == 0 and run.st.attempts == 1
        correct, differ, missing = gen.check_correct(
            run.r, data6k.workdir, log=lambda s: None)
        assert differ == 0 and missing == 0 and correct > 0
        assert run.inj.counters.get("chaos_sink_faults") > 0
        assert run.st.stats.faults.get("sink_errors", 0) > 0
        assert run.st.stats.faults.get("sink_retries", 0) > 0
        faults[name] = run.inj.counters.snapshot()
    assert faults["port"] == faults["jax"]


# ----------------------------------------------------------------------
# exactly-once (tests/test_exactly_once.py:311-353)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_all_three_surfaces_exactly_once(data12k, tmp_path, pipeline):
    """Sink outage, scattered faults, PARTIAL pipeline applies, torn
    journal reads and the four-crash script: every window equals the
    oracle exactly in both engines."""
    plan = acceptance_plan(xo=True)
    assert any(k == "partial" for k in plan.sink_faults.values())
    for name in SIDES:
        side = Side(name)
        run = supervise(side, data12k, plan, tmp_path / name,
                        max_no_progress=8, redis_hashtable="",
                        jax_ingest_pipeline=pipeline, **XO)
        assert run.st.crashes >= 3
        assert run.inj.counters.get("chaos_sink_faults") > 0
        assert run.inj.counters.get("journal_faults") > 0
        exactly_once(side, data12k, run, side.chaos.replay_note(
            seed=plan.seed, topic_path=_topic(data12k),
            overrides={"jax.sink.exactly_once": True,
                       "jax.ingest.pipeline": pipeline}))
        assert run.sup.runner.engine.events_processed == 12_000


def test_crash_after_flush_reconciles_to_exact(data6k, tmp_path):
    """Crash right after a flush landed, before its snapshot: the resume
    detects the unfenced flush and reconciles to exact equality."""
    plan = FaultPlan(crashes=(("batch", 3), ("flush", 1)))
    for name in SIDES:
        side = Side(name)
        run = supervise(side, data6k, plan, tmp_path / name,
                        max_no_progress=8, redis_hashtable="", **QUIET,
                        **XO)
        assert run.st.crashes == 2
        merged = dict(run.st.stats.faults)
        assert merged.get("sink_unfenced_resumes", 0) > 0, merged
        assert merged.get("reconciled_windows", 0) > 0, merged
        exactly_once(side, data6k, run)


# ----------------------------------------------------------------------
# batch-only scripts: equal windows and equal supervisor stats
# ----------------------------------------------------------------------

@pytest.mark.parametrize("xo", [False, True], ids=["alo", "xo"])
@pytest.mark.parametrize("seed", [3, 8])
def test_batch_only_scripts_agree_with_the_jax_engine(data12k, tmp_path,
                                                      xo, seed):
    """Crashes at batch boundaries only, sink and journal faults, no
    periodic flush: both engines crash at the same journal offsets,
    record the same replay segments and backoff, draw the same faults
    and leave the same windows."""
    rng = random.Random(seed)
    base = FaultPlan.generate(seed, sink_rate=0.2, sink_ops=20,
                              sink_partial_rate=0.1 if xo else 0.0,
                              journal_rate=0.3, journal_polls=20)
    plan = FaultPlan(seed=seed, sink_faults=base.sink_faults,
                     journal_faults=base.journal_faults,
                     crashes=tuple(("batch", rng.randrange(1, 9))
                                   for _ in range(rng.randrange(2, 5))))
    out = {}
    for name in SIDES:
        side = Side(name)
        over = dict(QUIET, redis_hashtable="", **(XO if xo else {}))
        run = supervise(side, data12k, plan, tmp_path / name, seed=seed,
                        max_no_progress=len(plan.crashes) + 1, **over)
        (exactly_once if xo else at_least_once)(side, data12k, run)
        out[name] = (stats_of(run.st), side.seen(run.r),
                     run.inj.counters.snapshot(),
                     run.sup.runner.engine.events_processed)
    assert out["port"] == out["jax"]
    assert out["port"][0][1] == len(plan.crashes)


# ----------------------------------------------------------------------
# randomized seeds (tests/test_supervisor.py:94, test_exactly_once.py:429)
# ----------------------------------------------------------------------

def random_script(seed: int) -> tuple:
    rng = random.Random(seed)
    crashes = []
    for _ in range(rng.randrange(1, 5)):
        kind = rng.choice(("batch", "batch", "flush", "checkpoint"))
        n = rng.randrange(1, 9) if kind == "batch" else 1
        crashes.append((kind, n))
    return tuple(crashes), rng


def crash_sweep_seed(data: Data, tmp_path, seed: int) -> None:
    """The reference's randomized at-least-once sweep, one seed, both
    engines: the oracle bounds hold."""
    crashes, rng = random_script(seed)
    plan = FaultPlan(seed=seed, crashes=crashes,
                     sink_faults={i: "refused"
                                  for i in range(rng.randrange(0, 4))})
    for name in SIDES:
        side = Side(name)
        run = supervise(side, data, plan, tmp_path / name, seed=seed,
                        backoff_cap_ms=2,
                        max_no_progress=len(crashes) + 1)
        at_least_once(side, data, run, side.chaos.replay_note(
            seed=seed, topic_path=_topic(data),
            overrides={"jax.batch.size": 256, "jax.scan.batches": 2}))
        assert run.sup.runner.engine.events_processed == data.events


def xo_sweep_seed(data: Data, tmp_path, seed: int, flight: bool) -> None:
    """The reference's randomized exactly-once sweep, one seed, both
    engines (the flight recorder armed, as the reference's fast seeds
    run): every window exact."""
    crashes, _ = random_script(seed)
    base = FaultPlan.generate(seed, sink_rate=0.08, sink_ops=24,
                              sink_partial_rate=0.12)
    plan = FaultPlan(seed=seed, sink_faults=base.sink_faults,
                     crashes=crashes)
    for name in SIDES:
        side = Side(name)
        fr = (side.flightrec(str(tmp_path / f"fr-{name}"), capacity=64)
              if flight else None)
        run = supervise(side, data, plan, tmp_path / name, seed=seed,
                        backoff_cap_ms=2, flightrec=fr,
                        max_no_progress=len(crashes) + 1,
                        redis_hashtable="", **XO)
        exactly_once(side, data, run, side.chaos.replay_note(
            seed=seed, topic_path=_topic(data),
            overrides={"jax.sink.exactly_once": True,
                       "jax.batch.size": 256}))
        assert run.sup.runner.engine.events_processed == data.events


@pytest.mark.parametrize("seed", range(4))
def test_randomized_crash_boundaries_fast(sweep_data, tmp_path, seed):
    crash_sweep_seed(sweep_data, tmp_path, seed)


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("seed", range(4, 24))
def test_randomized_crash_boundaries_sweep(sweep_data, tmp_path, seed):
    crash_sweep_seed(sweep_data, tmp_path, seed)


@pytest.mark.parametrize("seed", range(4))
def test_randomized_crash_boundaries_exactly_once_fast(sweep_data,
                                                       tmp_path, seed):
    xo_sweep_seed(sweep_data, tmp_path, seed, flight=True)


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("seed", range(4, 24))
def test_randomized_crash_boundaries_exactly_once_sweep(sweep_data,
                                                        tmp_path, seed):
    xo_sweep_seed(sweep_data, tmp_path, seed, flight=False)


# ----------------------------------------------------------------------
# device decode (tests/test_devdecode.py:353)
# ----------------------------------------------------------------------

def test_chaos_sweep_with_device_decode(data12k, tmp_path):
    """The acceptance run with ``jax.decode.device: on``: within the
    bound in both engines.  In the port the journal's damage never
    reaches the decode kernel: the layout probe rejects every torn page
    and corrupt copy the wrapper served, and only those rows fall back
    to the host encoder, which counts them as bad lines."""
    plan = acceptance_plan(xo=False)
    for name in SIDES:
        side = Side(name)
        run = supervise(side, data12k, plan, tmp_path / name,
                        jax_decode_device="on")
        assert run.st.crashes >= 3
        assert run.sup.runner.engine._devdecode is not None
        at_least_once(side, data12k, run)
        assert run.sup.runner.engine.events_processed == 12_000
        if name == "port":
            served = [kind for i, kind in plan.journal_faults.items()
                      if i < run.inj._journal_idx]
            damaged = sum(kind != "truncated" for kind in served)
            assert damaged > 0
            assert sum(e._devdecode.rows_fallback
                       for e in run.engines) == damaged
            assert sum(e.encoder.bad_lines for e in run.engines) == damaged


# ----------------------------------------------------------------------
# a snapshot of a crashed JAX attempt, resumed by the port's supervisor
# ----------------------------------------------------------------------

def test_jax_crash_snapshot_resumed_by_port_supervisor(data12k, tmp_path):
    """A JAX attempt (exactly-once, a checkpoint after every flush)
    crashes right after its third snapshot; the port's supervised run,
    under its own sink faults and batch crashes, resumes that snapshot on
    the same store and ends oracle-exact (the npz and the sink fence are
    the same in both engines)."""
    over = dict(jax_flush_interval_ms=0, jax_checkpoint_interval_ms=0,
                redis_hashtable="", **XO)
    r = as_redis(FakeRedisStore())        # one sink, as a Redis would be
    seed_campaigns(r, data12k.campaigns)
    jeng = JaxEngine(jax_default_config(
        jax_batch_size=256, jax_scan_batches=2, jax_sink_retry_base_ms=1,
        jax_sink_retry_cap_ms=4, **over), data12k.mapping, redis=r)
    jrun = JaxRunner(jeng, JaxBroker(data12k.workdir + "/broker").reader(
        data12k.topic), checkpointer=JaxCheckpointer(str(tmp_path / "ck")),
        crash_points=jax_chaos.CrashScheduler((("checkpoint", 3),)))
    with pytest.raises(jax_chaos.EngineCrash):
        jrun.run_catchup()
    jeng.drain_writes()
    del jeng, jrun                           # the crash: no close()
    snap = Checkpointer(str(tmp_path / "ck")).load()
    assert 0 < snap.offset and snap.meta["sink_seq"] > 0

    plan = FaultPlan(sink_faults={1: "refused", 4: "partial", 6: "timeout"},
                     crashes=(("batch", 4), ("batch", 2)))
    run = supervise(Side("port"), data12k, plan, tmp_path / "ck",
                    max_no_progress=8, r=r, **over)
    assert run.st.crashes == 2 and run.st.attempts == 3
    assert run.st.replay_segments[0][0] >= snap.offset
    exactly_once(Side("port"), data12k, run)
    assert run.sup.runner.engine.events_processed == 12_000


# ----------------------------------------------------------------------
# chip_smoke.py phase 14, rehearsed on the CPU at a small size
# ----------------------------------------------------------------------

def test_chip_smoke_phase14_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 14's config #5 and fake-Kafka runs, through the smoke's own
    code (the probe, the supervisor, the checks, the ledger), on the CPU
    at a small size: 1,000 campaigns and 60,000 events with a flush and
    a checkpoint after every batch; 20,000 events over three partitions.
    The card runs them at full size."""
    import chip_smoke

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        return str(path)

    monkeypatch.setattr(chip_smoke, "_workdir", workdir)
    monkeypatch.setattr(chip_smoke, "CHAOS_CONFIG5_SCRIPT",
                        (("batch", 3), ("checkpoint", 1), ("batch", 2)))
    data = chip_smoke.Config5Data(60_000, keys=dict(
        chip_smoke.CONFIG5, **{"jax.num.campaigns": 1_000,
                               "jax.flush.interval.ms": 0}))
    rec = chip_smoke._chaos_config5(data, "cpu")
    assert rec["crashes"] == 3 and rec["verdict"]["ok"]
    assert [a["crash_at"] for a in rec["per_attempt"]] == [
        "batch", "checkpoint", "batch", None]
    restarts = rec["per_attempt"][1:]
    assert all(a["recover"]["total_ms"] > 0 for a in restarts)
    assert all(a["engines_alive_at_first_fold"] == 1 for a in restarts)
    assert rec["checkpoints"] and all(c["save_ms"] > 0
                                      for c in rec["checkpoints"])
    rec = chip_smoke._chaos_kafka(20_000, "cpu")
    assert rec["crashes"] == 3 and rec["verdict"]["ok"]
    ledger = rec["ledger"]
    assert ledger["violations"] == [] and ledger["redelivered"] > 0
    assert ledger["delivered"] == 20_000 + ledger["replayed_records"]
