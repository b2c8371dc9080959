"""Exactly-once writeback of the port's engine, against the JAX engine's.

The port of the scenarios of ``tests/test_exactly_once.py`` that run
without a supervisor: flag off writes no fence; a fenced flush commits its
fence and counts; a zombie writer is fenced out; the retry of a flush
that landed is suppressed; a partial apply is reconciled absolute; rows
lost are counted at close; and a crash after a flush, before the snapshot
that would cover it, reconciles to exact (driven by hand: an engine
abandoned without ``close()`` and a fresh one resumed from the newest
checkpoint).  Every scenario runs through the JAX engine and the port on
the same inputs, each on its own in-process store: the sink fences
(epoch, seq, intent) and the window rows must be equal.  All on the CPU.
"""

import json
import random

import pytest
import torch

from streambench_tpu.checkpoint import Checkpointer as JaxCheckpointer
from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import AdAnalyticsEngine as JaxEngine
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_fence as jax_read_fence
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.io.fakeredis import FakeRedisStore
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    as_redis,
    fence_key,
    read_fence,
    read_seen_counts,
    seed_campaigns,
)

torch.set_num_threads(1)

XO = {"jax_sink_exactly_once": True}
MAPPING = {f"ad{i}": f"camp{i % 3}" for i in range(9)}
CAMPAIGNS = ["camp0", "camp1", "camp2"]


class Side:
    """One engine implementation and its store, so a scenario can run
    through both: ``engine(redis, **cfg)``, ``store()``, ``seen(r)``,
    ``fence(r)``."""

    def __init__(self, name):
        self.name = name
        self.jax = name == "jax"

    def config(self, **over):
        return (jax_default_config if self.jax else default_config)(**over)

    def engine(self, redis, campaigns=None, mapping=MAPPING, **over):
        cfg = self.config(**over)
        if self.jax:
            return JaxEngine(cfg, mapping, campaigns=campaigns, redis=redis)
        return AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                                 redis=redis, device="cpu")

    def store(self, campaigns=CAMPAIGNS):
        if self.jax:
            r = jax_as_redis(JaxStore())
            jax_seed(r, campaigns)
        else:
            r = as_redis(FakeRedisStore())
            seed_campaigns(r, campaigns)
        return r

    def seen(self, r):
        return (jax_seen if self.jax else read_seen_counts)(r)

    def fence(self, r, topic="test1"):
        return (jax_read_fence if self.jax else read_fence)(
            r, fence_key(topic))


def run_both(scenario):
    """The scenario's (fence, rows, extra) from each engine, which must
    agree; returns the port's."""
    out = {name: scenario(Side(name)) for name in ("jax", "port")}
    assert out["port"][0] == out["jax"][0], "sink fences differ"
    assert out["port"][1] == out["jax"][1], "window rows differ"
    return out["port"]


def view_lines(n, t0=1_000_000, step=10):
    return [json.dumps({"user_id": "u", "page_id": "p",
                        "ad_id": f"ad{i % 9}", "ad_type": "banner",
                        "event_type": "view",
                        "event_time": str(t0 + i * step),
                        "ip_address": "1.2.3.4"}).encode()
            for i in range(n)]


def make_engine(side, r, **over):
    return side.engine(r, jax_batch_size=64, jax_sink_retry_base_ms=1,
                       jax_sink_retry_cap_ms=2, **XO, **over)


def total_counts(side, r):
    return {(c, ts): n for c, per in side.seen(r).items()
            for ts, n in per.items()}


def test_flag_off_writes_no_fence():
    """Default-off: no fence key, no ledger."""
    def scenario(side):
        r = side.store()
        eng = side.engine(r, jax_batch_size=64)
        eng.process_chunk(view_lines(100))
        eng.flush()
        eng.close()
        assert r.execute("HGET", fence_key("test1"), "seq") is None
        assert eng._sink_totals == {} and not eng._taint
        return side.fence(r), side.seen(r)

    fence, rows = run_both(scenario)
    assert fence == (0, 0, 0) and sum(sum(v.values())
                                      for v in rows.values()) == 100


def test_fenced_flush_commits_fence_and_counts():
    def scenario(side):
        r = side.store()
        eng = make_engine(side, r)
        eng.process_chunk(view_lines(200))
        eng.flush()
        eng.drain_writes()
        fk = fence_key(eng.cfg.kafka_topic)
        assert r.execute("HGET", fk, "epoch") == "1"
        assert r.execute("HGET", fk, "seq") == "1"
        assert r.execute("HGET", fk, "intent") == "1"
        assert sum(total_counts(side, r).values()) == 200
        eng.process_chunk(view_lines(200))
        eng.flush()
        eng.drain_writes()
        assert r.execute("HGET", fk, "seq") == "2"
        assert sum(total_counts(side, r).values()) == 400
        eng.close()
        return side.fence(r), side.seen(r)

    assert run_both(scenario)[0] == (1, 2, 2)


def test_zombie_writer_is_fenced_out():
    """Two writers on one sink: the older epoch's flush is rejected and
    counted (``fence_conflicts``), the newer epoch's rows land intact."""
    def scenario(side):
        r = side.store()
        a = make_engine(side, r)
        a.process_chunk(view_lines(90))
        a.flush()
        a.drain_writes()                  # epoch 1, 90 views on the sink
        before = total_counts(side, r)
        assert sum(before.values()) == 90

        b = make_engine(side, r)          # same sink, fresh lineage
        b.process_chunk(view_lines(90, t0=2_000_000))
        b.flush()
        b.drain_writes()                  # claims epoch 2
        assert side.fence(r)[0] == 2

        # the superseded writer keeps draining: its flush is DROPPED,
        # neither applied nor retained for retry
        a.process_chunk(view_lines(90))
        a.flush()
        a.drain_writes()
        assert a.faults.get("fence_conflicts") >= 1
        assert not a._writer.has_failed()
        after = total_counts(side, r)
        for key, n in before.items():
            assert after[key] == n, (key, after[key], n)
        assert sum(after.values()) == 180
        b.close()
        a.close()   # fenced-out batches are not "unwritten"
        return side.fence(r), side.seen(r)

    run_both(scenario)


class _ApplyThenRaise:
    """Sink proxy: applies the window-mutation pipeline FULLY, then
    raises -- the response-lost timeout (the fence commit is on the sink
    but the writer saw an error)."""

    def __init__(self, target):
        self._target = target
        self.armed = 0

    def execute(self, *args):
        return self._target.execute(*args)

    def pipeline_execute(self, commands):
        cmds = list(commands)
        res = self._target.pipeline_execute(cmds)
        if self.armed and any(c[0] in ("HINCRBY",) or
                              (c[0] == "HSET" and "intent" in c)
                              for c in cmds):
            self.armed -= 1
            raise TimeoutError("stub: response lost after full apply")
        return res

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._target, name)


def test_fence_dedup_suppresses_retry_of_landed_flush():
    """A flush whose pipeline landed but whose response was lost is NOT
    applied again: the commit fence proves it landed."""
    def scenario(side):
        store = side.store()
        proxy = _ApplyThenRaise(store)
        eng = make_engine(side, proxy)
        eng.process_chunk(view_lines(120))
        proxy.armed = 1
        eng.flush()
        eng.drain_writes()
        assert eng.faults.get("dedup_suppressed_flushes") == 1
        assert not eng._writer.has_failed()   # nothing retained
        assert sum(total_counts(side, store).values()) == 120
        # and the windows are NOT tainted: next flush is plain deltas
        eng.process_chunk(view_lines(120))
        eng.flush()
        eng.drain_writes()
        assert sum(total_counts(side, store).values()) == 240
        assert eng.faults.get("reconciled_windows") == 0
        eng.close()
        return side.fence(store), side.seen(store)

    run_both(scenario)


class _PartialAt:
    """Sink proxy: the ``at``-th sink operation (``execute`` and
    ``pipeline_execute`` counted together) applies only the first half
    of its pipeline, then raises -- the non-atomic timeout."""

    def __init__(self, target, at):
        self._target = target
        self._at = at
        self._ops = 0

    def _tick(self) -> bool:
        self._ops += 1
        return self._ops - 1 == self._at

    def execute(self, *args):
        if self._tick():
            self._target.execute(*args)
            raise TimeoutError("stub: sink timed out after apply")
        return self._target.execute(*args)

    def pipeline_execute(self, commands):
        cmds = list(commands)
        if self._tick():
            k = max(len(cmds) // 2, 1)
            self._target.pipeline_execute(cmds[:k])
            raise TimeoutError(f"stub: sink timed out after {k}/{len(cmds)}"
                               " commands")
        return self._target.pipeline_execute(cmds)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._target, name)


def test_partial_apply_is_reconciled_absolute():
    """A prefix of the pipeline lands, the fence commit does not: the
    retry rewrites the tainted windows ABSOLUTE from the ledger."""
    def scenario(side):
        store = side.store()
        eng = make_engine(side, _PartialAt(store, at=4))
        eng.process_chunk(view_lines(120))
        # sink ops: 0 = attach fence read, 1 = epoch claim, 2 = writer
        # epoch check, 3 = existence probes, 4 = the mutation pipeline
        eng.flush()
        eng.drain_writes()
        assert eng.faults.get("sink_errors") >= 1
        fk = fence_key(eng.cfg.kafka_topic)
        # the partial signature: intent ran ahead of the commit seq
        assert int(store.execute("HGET", fk, "intent") or 0) \
            > int(store.execute("HGET", fk, "seq") or 0)
        eng.flush()
        eng.drain_writes()
        assert eng.faults.get("reconciled_windows") > 0
        assert sum(total_counts(side, store).values()) == 120
        eng.close()
        assert total_counts(side, store) == {
            ("camp0", 1_000_000): 40, ("camp1", 1_000_000): 40,
            ("camp2", 1_000_000): 40}
        return side.fence(store), side.seen(store)

    run_both(scenario)


def test_rows_lost_counted_at_close():
    """Rows abandoned when close() exhausts CLOSE_RETRY_LIMIT are counted
    as ``rows_lost`` (and close still raises)."""
    class _DeadSink:
        def execute(self, *args):
            raise ConnectionRefusedError("down")

        def pipeline_execute(self, commands):
            raise ConnectionRefusedError("down")

    def scenario(side):
        eng = side.engine(_DeadSink(), jax_batch_size=64,
                          jax_sink_retry_base_ms=1, jax_sink_retry_cap_ms=2)
        eng.CLOSE_RETRY_LIMIT = 2
        eng.process_chunk(view_lines(50))
        with pytest.raises(RuntimeError, match="rows lost"):
            eng.close()
        assert eng.faults.get("rows_lost") > 0
        assert eng.faults.get("sink_errors") > 0
        return eng.faults.get("rows_lost"), None

    run_both(scenario)


def test_sink_unreachable_at_attach_holds_everything():
    """Exactly-once with the sink down from the start claims no epoch, so
    nothing is submitted unfenced; close() counts the held windows as
    lost and raises."""
    class _DeadSink:
        def execute(self, *args):
            raise ConnectionRefusedError("down")

        def pipeline_execute(self, commands):
            raise ConnectionRefusedError("down")

    def scenario(side):
        eng = make_engine(side, _DeadSink())
        eng.CLOSE_RETRY_LIMIT = 2
        eng.process_chunk(view_lines(50))
        with pytest.raises(RuntimeError, match="never flushed"):
            eng.close()
        assert eng._writer is None and eng._sink_epoch is None
        assert eng.faults.get("fence_read_errors") > 0
        return eng.faults.get("rows_lost"), None

    run_both(scenario)


# ----------------------------------------------------------------------
# crash in the replay window, by hand


@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("xo")
    cfg = default_config(jax_batch_size=256)
    broker = FileBroker(str(tmp / "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=6_000,
                 rng=random.Random(11), workdir=str(tmp))
    mapping = gen.load_ad_mapping_file(str(tmp / gen.AD_TO_CAMPAIGN_FILE))
    campaigns, _ = gen.load_ids(str(tmp))
    return tmp, mapping, campaigns


def test_crash_after_flush_reconciles_to_exact(journal, tmp_path):
    """Engine A checkpoints, then flushes again AFTER its last checkpoint
    and is abandoned without close() (a crash in the replay window).
    Engine B resumes from the checkpoint on the same sink: it detects the
    unfenced flush (sink seq > snapshot seq), writes every window it
    flushes absolute from its ledger, and the sink ends oracle-exact."""
    tmp, mapping, campaigns = journal
    over = dict(jax_batch_size=256, jax_scan_batches=2,
                jax_sink_retry_base_ms=1, jax_sink_retry_cap_ms=4,
                redis_hashtable="", **XO)
    # flushes only where the scenario asks for them: no 1 Hz tick
    quiet = dict(flush_interval_ms=10**9)

    def scenario(side):
        r = side.store(campaigns)
        broker = (JaxBroker if side.jax else FileBroker)(str(tmp / "broker"))
        ckpt_cls = JaxCheckpointer if side.jax else Checkpointer
        runner_cls = JaxRunner if side.jax else StreamRunner
        ckpt = ckpt_cls(str(tmp_path / side.name))

        a = side.engine(r, campaigns, mapping, **over)
        reader_a = broker.reader("test1")
        runner_cls(a, reader_a, checkpointer=ckpt,
                   **quiet).run_catchup(max_events=2_500)
        # more events, flushed and landed, never checkpointed
        runner_cls(a, reader_a, **quiet).run_catchup(max_events=1_500)
        a.drain_writes()
        seq_a = side.fence(r)[1]
        assert seq_a > ckpt.load().meta["sink_seq"]
        del a  # crash: no close()

        b = side.engine(r, campaigns, mapping, **over)
        runner_b = runner_cls(b, broker.reader("test1"), checkpointer=ckpt,
                              **quiet)
        assert runner_b.resume()
        stats = runner_b.run_catchup()
        b.close()
        faults = dict(stats.faults)
        assert faults.get("sink_unfenced_resumes", 0) > 0, faults
        assert faults.get("reconciled_windows", 0) > 0, faults
        assert b.events_processed == 6_000
        correct, differ, missing = gen.check_correct(r, str(tmp),
                                                     log=lambda s: None)
        assert differ == 0 and missing == 0 and correct > 0
        return side.fence(r), side.seen(r)

    fence, _ = run_both(scenario)
    assert fence[0] == 2        # B claimed the epoch after A's
