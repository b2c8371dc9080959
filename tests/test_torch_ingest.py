"""The staged ingest pipeline of the port, against the JAX package's.

One generated journal goes through the JAX engine's pipelined runner and
the port's (``device="cpu"``), each into its own in-process store: every
window must agree bit for bit and pass the generator's oracle, in catchup
and in paced mode.  Then the checkpoint contract under a live pipeline
(the folded offset, never the read-ahead; a resume replays in-flight
blocks and counts none twice), exactly-once with the pipeline on, the
mode resolution ("off"/"on"/"auto"), that the stage threads touch no
torch at all, and the ports of ``tests/test_ingest_pipeline.py`` and
``tests/test_runner_adaptive.py``.
"""

import os
import random
import threading
import time
import types

import pytest
import torch

from streambench_tpu.checkpoint import Checkpointer as JaxCheckpointer
from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import AdAnalyticsEngine as JaxEngine
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu.metrics import FaultCounters as JaxFaultCounters
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.engine.ingest import EOF, IngestPipeline
from streambench_tpu_torch.io.fakeredis import FakeRedisStore
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    as_redis,
    read_seen_counts,
    seed_campaigns,
)
from streambench_tpu_torch.metrics import FaultCounters

torch.set_num_threads(1)

SMALL = {"jax_batch_size": 256, "jax_scan_batches": 2}


class Side:
    """One engine implementation (``"jax"`` or ``"torch"``) over the
    same workdir, each with its own broker handle and stores."""

    def __init__(self, name, workdir):
        self.jax = name == "jax"
        self.workdir = str(workdir)

    def config(self, **over):
        return (jax_default_config if self.jax else default_config)(
            **{**SMALL, **over})

    def broker(self):
        root = os.path.join(self.workdir, "broker")
        return JaxBroker(root) if self.jax else FileBroker(root)

    def store(self):
        campaigns = gen.load_ids(self.workdir)[0]
        if self.jax:
            r = jax_as_redis(JaxStore())
            jax_seed(r, campaigns)
        else:
            r = as_redis(FakeRedisStore())
            seed_campaigns(r, campaigns)
        return r

    def engine(self, cfg, r):
        mapping = gen.load_ad_mapping_file(
            os.path.join(self.workdir, gen.AD_TO_CAMPAIGN_FILE))
        if self.jax:
            return JaxEngine(cfg, mapping, redis=r)
        return AdAnalyticsEngine(cfg, mapping, redis=r, device="cpu")

    def runner(self, engine, reader, **kw):
        return (JaxRunner if self.jax else StreamRunner)(engine, reader,
                                                          **kw)

    def checkpointer(self, path):
        return (JaxCheckpointer if self.jax else Checkpointer)(path)

    def seen(self, r):
        return jax_seen(r) if self.jax else read_seen_counts(r)


def setup_run(tmp_path, events=20_000, partitions=1, **cfg_over):
    """A generated journal (``gen.do_setup``) and the port's config."""
    cfg = default_config(**{**SMALL, **cfg_over})
    broker = FileBroker(str(tmp_path / "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=events,
                 rng=random.Random(7), workdir=str(tmp_path),
                 partitions=partitions)
    mapping = gen.load_ad_mapping_file(
        str(tmp_path / gen.AD_TO_CAMPAIGN_FILE))
    return cfg, broker, mapping


def fresh_store(tmp_path):
    r = as_redis(FakeRedisStore())
    seed_campaigns(r, gen.load_ids(str(tmp_path))[0])
    return r


def oracle_exact(r, workdir):
    correct, differ, missing = gen.check_correct(r, workdir=str(workdir),
                                                 log=lambda s: None)
    assert differ == 0 and missing == 0 and correct > 0


def run_side(side, mode, catchup=True, **over):
    cfg = side.config(**over)
    r = side.store()
    eng = side.engine(cfg, r)
    with side.broker().reader(cfg.kafka_topic) as reader:
        runner = side.runner(eng, reader, ingest_pipeline=mode)
        stats = (runner.run_catchup() if catchup
                 else runner.run(idle_timeout_s=0.5))
        eng.close()
    return r, stats, runner


# ----------------------------------------------------------------------
# the port against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("catchup", [True, False], ids=["catchup", "paced"])
def test_pipelined_runs_match_jax_pipelined_runs(tmp_path, catchup):
    setup_run(tmp_path, events=12_000)
    jr, jstats, _ = run_side(Side("jax", tmp_path), "on", catchup)
    tr, tstats, runner = run_side(Side("torch", tmp_path), "on", catchup)
    assert tstats.events == jstats.events == 12_000
    assert read_seen_counts(tr) == jax_seen(jr)
    oracle_exact(tr, tmp_path)
    tel = runner._pipeline.telemetry()
    assert tel["records_read"] == tel["records_folded"] == 12_000
    assert runner._pipeline.closed


@pytest.mark.parametrize("mode", ["off", "on", "auto", " On "])
@pytest.mark.parametrize("cores", [1, 8])
@pytest.mark.parametrize("native", [True, False], ids=["block", "line"])
def test_modes_resolve_as_the_reference_does(tmp_path, monkeypatch, mode,
                                             cores, native):
    """"off" never pipelines, "on" always, "auto" only with block-mode
    ingest on more than one core — the same answer as the JAX runner's
    in every case."""
    setup_run(tmp_path, events=500, jax_use_native_encoder=native)
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    got = []
    for name in ("jax", "torch"):
        side = Side(name, tmp_path)
        cfg = side.config(jax_use_native_encoder=native,
                          jax_ingest_pipeline="off")
        eng = side.engine(cfg, None)
        with side.broker().reader(cfg.kafka_topic) as reader:
            got.append(side.runner(eng, reader,
                                   ingest_pipeline=mode)._pipeline_on())
        eng.close()
    assert got[0] == got[1]
    want = {"off": False, "on": True, " On ": True,
            "auto": cores > 1 and native}[mode]
    assert got[1] is want


def test_config_key_sets_the_default_mode(tmp_path):
    """The runner takes ``jax.ingest.pipeline`` from the config unless
    the caller names a mode."""
    cfg, broker, mapping = setup_run(tmp_path, events=500,
                                     jax_ingest_pipeline="on")
    eng = AdAnalyticsEngine(cfg, mapping, device="cpu")
    with broker.reader(cfg.kafka_topic) as reader:
        assert StreamRunner(eng, reader).ingest_mode == "on"
        assert StreamRunner(eng, reader,
                            ingest_pipeline="off").ingest_mode == "off"
    eng.close()


def _checkpointed_leg(side, workdir, cut):
    """A pipelined catchup cut at ``cut`` events with a checkpointer;
    returns (store, the saved offset, events in the snapshot)."""
    cfg = side.config(jax_ingest_pipeline="on")
    r = side.store()
    ckpt = side.checkpointer(os.path.join(workdir, f"ckpt-{side.jax}"))
    eng = side.engine(cfg, r)
    with side.broker().reader(cfg.kafka_topic) as reader:
        runner = side.runner(eng, reader, checkpointer=ckpt)
        runner.run_catchup(max_events=cut)
        folded = runner._reader_position()
        ahead = reader.offset
        eng.close()
    snap = ckpt.load()
    return r, ckpt, snap, folded, ahead


def test_checkpoint_under_live_pipeline_resumes_exactly(tmp_path):
    """Cut a pipelined catchup short, crash, resume a fresh runner from
    its checkpoint: the saved offset is the FOLDED one (equal to the JAX
    runner's, and behind the reader's read-ahead), and the resumed run
    is oracle-exact and equal to the JAX engine's."""
    cfg, broker, _ = setup_run(tmp_path, events=12_000,
                               jax_ingest_pipeline="on")
    results = {}
    for name in ("jax", "torch"):
        side = Side(name, tmp_path)
        r, ckpt, snap, folded, ahead = _checkpointed_leg(side, tmp_path,
                                                         6_000)
        assert snap.offset == folded
        assert folded <= ahead
        cfg = side.config(jax_ingest_pipeline="on")
        eng2 = side.engine(cfg, r)
        with side.broker().reader(cfg.kafka_topic) as reader:
            runner2 = side.runner(eng2, reader, checkpointer=ckpt)
            assert runner2.resume()
            assert runner2._reader_position() == snap.offset
            runner2.run_catchup()
            eng2.close()
        assert eng2.events_processed == 12_000
        results[name] = (snap.offset, int(snap.meta["events_processed"]),
                         side.seen(r))
        if name == "torch":
            oracle_exact(r, tmp_path)
    assert results["torch"][:2] == results["jax"][:2]
    assert results["torch"][2] == results["jax"][2]
    # the offset covers exactly the folded events: re-reading from it
    # yields the rest (nothing skipped, nothing doubled)
    with broker.reader(cfg.kafka_topic,
                       offset=results["torch"][0]) as check:
        rest = sum(len(check.poll()) for _ in range(200))
    assert results["torch"][1] + rest == 12_000


def test_exactly_once_with_the_pipeline_on(tmp_path):
    """A crash after a flush no checkpoint covers, with the pipeline on
    in both legs: engine A checkpoints, flushes more and is abandoned
    without ``close()``; B resumes, reconciles absolute and leaves every
    window exact — in both engines, with equal rows."""
    setup_run(tmp_path, events=12_000)
    rows = {}
    for name in ("jax", "torch"):
        side = Side(name, tmp_path)
        over = {"jax_sink_exactly_once": True, "jax_ingest_pipeline": "on"}
        cfg = side.config(**over)
        r = side.store()
        ckpt = side.checkpointer(str(tmp_path / f"xo-{name}"))
        a = side.engine(cfg, r)
        reader_a = side.broker().reader(cfg.kafka_topic)
        side.runner(a, reader_a, checkpointer=ckpt).run_catchup(
            max_events=4_000)
        side.runner(a, reader_a).run_catchup(max_events=3_000)
        a.drain_writes()
        a._writer.close()                 # stop its thread; no close()
        reader_a.close()
        b = side.engine(cfg, r)
        with side.broker().reader(cfg.kafka_topic) as reader_b:
            runner_b = side.runner(b, reader_b, checkpointer=ckpt)
            assert runner_b.resume()
            runner_b.run_catchup()
            b.close()
        faults = b.faults.snapshot()
        assert faults.get("sink_unfenced_resumes", 0) > 0, (name, faults)
        assert faults.get("reconciled_windows", 0) > 0, (name, faults)
        assert b.events_processed == 12_000
        rows[name] = side.seen(r)
        if name == "torch":
            oracle_exact(r, tmp_path)
    assert rows["torch"] == rows["jax"]


def _stage_threads_torch_calls(tmp_path, **cfg_over):
    """Run a pipelined catchup with a profiler hooked into every thread
    the pipeline starts; returns (torch calls seen off the host loop,
    stats, pipeline telemetry, whether the engine built an encode pool,
    whether it decodes on the device)."""
    cfg, broker, mapping = setup_run(tmp_path, events=6_000, **cfg_over)
    hits: list[str] = []
    main = threading.main_thread()

    def torchy(frame, event, arg):
        if threading.current_thread() is main:
            return
        if event == "call" and f"{os.sep}torch{os.sep}" in \
                frame.f_code.co_filename:
            hits.append(frame.f_code.co_name)
        elif event == "c_call":
            owner = getattr(arg, "__self__", None)
            mod = (owner.__name__ if isinstance(owner, types.ModuleType)
                   else type(owner).__module__ if owner is not None
                   else getattr(arg, "__module__", "") or "")
            if mod.split(".")[0] == "torch":
                hits.append(getattr(arg, "__name__", repr(arg)))

    threading.setprofile(torchy)
    try:
        control = threading.Thread(target=lambda: torch.zeros(1))
        control.start()
        control.join()
        assert hits, "the hook missed a torch call on a thread"
        hits.clear()
        eng = AdAnalyticsEngine(cfg, mapping, redis=fresh_store(tmp_path),
                                device="cpu")
        pooled = eng._encode_pool is not None
        decoded = eng._devdecode is not None
        with broker.reader(cfg.kafka_topic) as reader:
            runner = StreamRunner(eng, reader, ingest_pipeline="on")
            stats = runner.run_catchup()
        tel = runner._pipeline.telemetry()
        eng.close()
    finally:
        threading.setprofile(None)
    return hits, stats, tel, pooled, decoded


def test_encode_thread_creates_no_tensor(tmp_path):
    """Only the host loop's thread may touch torch: a profiler hooked
    into every thread the pipeline starts (reader, encode, and the encode
    pool's workers) sees no call into torch, while the positive control
    shows the hook would."""
    hits, stats, tel, pooled, _ = _stage_threads_torch_calls(
        tmp_path, jax_encode_workers=2)
    assert pooled
    assert stats.events == 6_000 and tel["encode_ms_total"] > 0
    assert hits == []


def test_encode_thread_creates_no_tensor_with_device_decode(tmp_path):
    """With device decode on the encode stage probes raw blocks and keeps
    their padded bytes on the host; the upload happens on the host loop
    at the first fold, so the stage threads still touch no torch."""
    hits, stats, tel, _, decoded = _stage_threads_torch_calls(
        tmp_path, jax_decode_device="on")
    assert decoded
    assert stats.events == 6_000
    assert tel["device_decode"]["rows_decoded"] == 6_000
    assert tel["device_decode"]["rows_fallback"] == 0
    assert hits == []


# ----------------------------------------------------------------------
# the cases of tests/test_ingest_pipeline.py, on the port
# ----------------------------------------------------------------------

def run_mode(cfg, mapping, broker, r, mode, catchup=True, reader=None):
    eng = AdAnalyticsEngine(cfg, mapping, redis=r, device="cpu")
    if reader is None:
        reader = broker.reader(cfg.kafka_topic)
    runner = StreamRunner(eng, reader, ingest_pipeline=mode)
    stats = (runner.run_catchup() if catchup
             else runner.run(idle_timeout_s=0.5))
    eng.close()
    return stats, runner


def test_catchup_pipelined_matches_serial_and_oracle(tmp_path):
    cfg, broker, mapping = setup_run(tmp_path)
    r = fresh_store(tmp_path)
    base_stats, _ = run_mode(cfg, mapping, broker, r, "off")
    r2 = fresh_store(tmp_path)
    stats, runner = run_mode(cfg, mapping, broker, r2, "on")
    assert stats.events == base_stats.events == 20_000
    assert read_seen_counts(r2) == read_seen_counts(r)
    oracle_exact(r2, tmp_path)
    tel = runner._pipeline.telemetry()
    assert tel["records_read"] == tel["records_folded"] == stats.events


def test_streaming_pipelined_matches_serial(tmp_path):
    cfg, broker, mapping = setup_run(tmp_path, events=8_000)
    r = fresh_store(tmp_path)
    run_mode(cfg, mapping, broker, r, "off", catchup=False)
    r2 = fresh_store(tmp_path)
    stats, _ = run_mode(cfg, mapping, broker, r2, "on", catchup=False)
    assert stats.events == 8_000
    assert read_seen_counts(r2) == read_seen_counts(r)


def test_line_mode_pipeline_without_native_encoder(tmp_path):
    cfg, broker, mapping = setup_run(tmp_path, events=8_000,
                                     jax_use_native_encoder=False)
    r = fresh_store(tmp_path)
    run_mode(cfg, mapping, broker, r, "off")
    r2 = fresh_store(tmp_path)
    stats, runner = run_mode(cfg, mapping, broker, r2, "on")
    assert not runner._pipeline.block_mode
    assert stats.events == 8_000
    assert read_seen_counts(r2) == read_seen_counts(r)


def test_multi_partition_pipeline_line_mode(tmp_path):
    """MultiReader has no poll_block, so the pipeline runs line mode and
    tracks the per-partition offsets VECTOR as its folded position."""
    cfg, broker, mapping = setup_run(tmp_path, events=8_000, partitions=3)
    reader = broker.multi_reader(cfg.kafka_topic)
    stats, runner = run_mode(cfg, mapping, broker, fresh_store(tmp_path),
                             "on", reader=reader)
    assert stats.events == 8_000
    pos = runner._pipeline.position()
    assert isinstance(pos, list) and len(pos) == 3
    sizes = [os.path.getsize(broker.topic_path(cfg.kafka_topic, p))
             for p in range(3)]
    assert pos == sizes


def test_quiesce_returns_only_folded_offsets(tmp_path):
    cfg, broker, mapping = setup_run(tmp_path, events=4_000)
    eng = AdAnalyticsEngine(cfg, mapping, redis=fresh_store(tmp_path),
                            device="cpu")
    reader = broker.reader(cfg.kafka_topic)
    pipe = IngestPipeline(eng, reader, batch_size=256, chunk_records=512,
                          catchup=True, block_queue=2, batch_queue=2)
    try:
        assert pipe.quiesce() == 0
        pipe.resume()
        item = None
        while item is None:
            item = pipe.get(timeout_s=0.2)
        assert item is not EOF
        assert pipe.quiesce() == 0        # encoded but not folded
        pipe.resume()
        eng.fold_batches(item.batches)
        pipe.commit(item)
        off = pipe.quiesce()
        pipe.resume()
        assert off == item.end_pos > 0
        with broker.reader(cfg.kafka_topic, offset=off) as check:
            rest = sum(len(check.poll()) for _ in range(50))
        assert item.records + rest == 4_000
    finally:
        pipe.close()
        eng.close()


def test_checkpoint_resume_with_pipeline_is_exact(tmp_path):
    cfg, broker, mapping = setup_run(tmp_path, events=12_000,
                                     jax_ingest_pipeline="on")
    r = fresh_store(tmp_path)
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    eng = AdAnalyticsEngine(cfg, mapping, redis=r, device="cpu")
    StreamRunner(eng, broker.reader(cfg.kafka_topic),
                 checkpointer=ckpt).run_catchup(max_events=6_000)
    eng.close()
    eng2 = AdAnalyticsEngine(cfg, mapping, redis=r, device="cpu")
    runner2 = StreamRunner(eng2, broker.reader(cfg.kafka_topic),
                           checkpointer=ckpt)
    assert runner2.resume()
    runner2.run_catchup()
    eng2.close()
    assert eng2.events_processed == 12_000
    oracle_exact(r, tmp_path)


def test_stage_error_propagates_to_host(tmp_path):
    cfg, broker, mapping = setup_run(tmp_path, events=500)

    class FailingReader:
        offset = 0

        def poll(self, max_records=65536):
            raise ConnectionError("broker gone")

    eng = AdAnalyticsEngine(cfg, mapping, device="cpu")
    runner = StreamRunner(eng, FailingReader(), ingest_pipeline="on")
    with pytest.raises(ConnectionError):
        runner.run_catchup()
    assert runner._pipeline.closed
    eng.close()


def test_stop_drains_and_joins_both_stage_threads(tmp_path):
    """``stop()`` mid-run (the CLI's SIGTERM): the paced loop drains what
    the stages read, the final flush runs, and both stage threads are
    joined — none is left alive to hang the harness's STOP."""
    cfg, broker, mapping = setup_run(tmp_path, events=4_000)
    eng = AdAnalyticsEngine(cfg, mapping, redis=fresh_store(tmp_path),
                            device="cpu")
    reader = broker.reader(cfg.kafka_topic)
    runner = StreamRunner(eng, reader, ingest_pipeline="on")
    threading.Timer(0.5, runner.stop).start()
    stats = runner.run()                  # no duration: only stop() ends it
    eng.close()
    pipe = runner._pipeline
    assert pipe.closed and pipe.drained()
    assert not pipe._reader_thread.is_alive()
    assert not pipe._encode_thread.is_alive()
    assert stats.events == 4_000 and stats.flushes >= 1


# ----------------------------------------------------------------------
# the cases of tests/test_runner_adaptive.py: the serial loop's adaptive
# dispatch target, through both runners
# ----------------------------------------------------------------------

B = 32  # batch size for every case (small so doubling is cheap)
K = 4   # scan_batches -> chunk cap = 128


class StubEngine:
    """Minimal engine surface the runner touches: counts what it folds."""

    scan_batches = K
    supports_block_ingest = False

    def __init__(self, jax):
        self.cfg = (jax_default_config if jax else default_config)(
            jax_batch_size=B, jax_scan_batches=K)
        self.faults = JaxFaultCounters() if jax else FaultCounters()
        self.encoder = types.SimpleNamespace(bad_lines=0, dlq_lines=0)
        self.events_processed = 0
        self.chunks: list[int] = []

    def process_chunk(self, lines):
        self.chunks.append(len(lines))
        self.events_processed += len(lines)

    def process_block(self, data):
        n = data.count(b"\n")
        self.chunks.append(n)
        self.events_processed += n

    def flush(self, final=False):
        return 0


class BlockStubEngine(StubEngine):
    supports_block_ingest = True


class ScriptedReader:
    def __init__(self, supply, short_after=None, short_size=3):
        self.supply = supply
        self.polls: list[int] = []
        self.offset = 0
        self.short_after = short_after
        self.short_size = short_size

    def poll(self, max_records=65536):
        self.polls.append(max_records)
        n = max_records
        if (self.short_after is not None
                and len(self.polls) > self.short_after):
            n = min(n, self.short_size)
        n = min(n, self.supply)
        self.supply -= n
        self.offset += n
        return [b"x"] * n


class ScriptedBlockReader:
    def __init__(self, blocks):
        self.blocks = list(blocks)
        self.budgets: list[int] = []
        self.offset = 0

    def poll_block(self, max_bytes=None):
        self.budgets.append(max_bytes)
        if not self.blocks:
            return b""
        data = self.blocks.pop(0)
        if max_bytes is not None and len(data) > max_bytes:
            cut = data.rfind(b"\n", 0, max_bytes) + 1
            data, rest = data[:cut], data[cut:]
            if rest:
                self.blocks.insert(0, rest)
        self.offset += len(data)
        return data

    def poll(self, max_records=65536):
        raise AssertionError("block-mode case must not fall back to poll")


SIDES = pytest.mark.parametrize("impl", ["jax", "torch"])


def make_runner(impl, engine, reader, **kw):
    kw.setdefault("buffer_timeout_ms", 10_000)
    return (JaxRunner if impl == "jax" else StreamRunner)(engine, reader,
                                                          **kw)


@SIDES
def test_full_reads_double_target_to_chunk_cap(impl):
    eng = StubEngine(impl == "jax")
    reader = ScriptedReader(supply=2 * K * B)
    make_runner(impl, eng, reader).run(max_events=2 * K * B)
    assert reader.polls[:3] == [B, B, 2 * B]
    assert eng.chunks[0] == K * B, eng.chunks
    assert all(c <= K * B for c in eng.chunks)


@SIDES
def test_short_read_snaps_target_back_to_batch_size(impl):
    eng = StubEngine(impl == "jax")
    reader = ScriptedReader(supply=K * B + 10)
    make_runner(impl, eng, reader, buffer_timeout_ms=30).run(
        idle_timeout_s=0.1)
    assert reader.polls[:3] == [B, B, 2 * B]
    assert eng.chunks[0] == K * B
    assert reader.polls[3] == K * B
    assert reader.polls[4] == B - 10, reader.polls[:6]
    assert eng.chunks[1:] == [10], eng.chunks


@SIDES
def test_block_mode_byte_budget_doubles_and_caps(impl):
    est = StreamRunner.EST_EVENT_BYTES
    line = b"y" * (est - 1) + b"\n"
    eng = BlockStubEngine(impl == "jax")
    reader = ScriptedBlockReader([line * (4 * K * B)])
    make_runner(impl, eng, reader).run(max_events=2 * K * B)
    assert reader.budgets[:3] == [B * est, B * est, 2 * B * est]
    assert eng.chunks[0] == K * B


@SIDES
def test_block_mode_room_one_idle_stream_does_not_busy_spin(impl):
    line = b"z" * 99 + b"\n"
    eng = BlockStubEngine(impl == "jax")
    reader = ScriptedBlockReader([line * (B - 1)])
    t0 = time.monotonic()
    make_runner(impl, eng, reader, buffer_timeout_ms=40).run(
        idle_timeout_s=0.08)
    wall = time.monotonic() - t0
    polls = len(reader.budgets)
    assert polls < max(wall, 0.05) * 4000, (
        f"busy-spin: {polls} polls in {wall:.2f}s")
    assert sum(eng.chunks) == B - 1


@SIDES
def test_room_one_empty_read_keeps_target_stable(impl):
    est = StreamRunner.EST_EVENT_BYTES
    line = b"z" * 99 + b"\n"
    eng = BlockStubEngine(impl == "jax")
    reader = ScriptedBlockReader([line * (B - 1)])
    make_runner(impl, eng, reader, buffer_timeout_ms=40).run(
        idle_timeout_s=0.05)
    assert all(b <= B * est for b in reader.budgets), reader.budgets[:5]


# ----------------------------------------------------------------------
# the CLI with the source-side keys, against the JAX engine
# ----------------------------------------------------------------------

@pytest.mark.parametrize("keys", [
    {"jax.ingest.pipeline": "on"},
    {"jax.ingest.pipeline": "auto"},
    {"jax.encode.workers": 4},
    {"jax.ingest.pipeline": "on", "jax.encode.workers": 2,
     "jax.deadletter.enabled": True},
    {"kafka.fake": True, "jax.ingest.pipeline": "on"},
], ids=["pipeline_on", "pipeline_auto", "workers", "pool_pipeline_dlq",
        "fake_kafka"])
def test_cli_source_keys_match_jax(tmp_path, keys):
    """The port CLI accepts each source-side key and, writing to a RESP
    server, leaves every window equal to the JAX engine's catchup of the
    same events."""
    import json
    import subprocess
    import sys

    from streambench_tpu_torch.config import write_local_conf
    from streambench_tpu_torch.io import fakekafka
    from streambench_tpu_torch.io.fakeredis import FakeRedisServer
    from streambench_tpu_torch.io.resp import RespClient

    cfg, broker, _ = setup_run(tmp_path, events=6_000)
    jr, jstats, _ = run_side(Side("jax", tmp_path), "off")
    conf = dict(keys)
    srv = FakeRedisServer(port=0).start()
    kafka_srv = None
    try:
        if keys.get("kafka.fake"):
            kafka_srv = fakekafka.FakeKafkaServer().start()
            kafka_srv.cluster.create_topic(cfg.kafka_topic, 1)
            with broker.reader(cfg.kafka_topic) as rd:
                for line in rd.poll(max_records=1 << 20):
                    kafka_srv.cluster.append(cfg.kafka_topic, 0, line)
            conf["kafka.bootstrap"] = f"{kafka_srv.host}:{kafka_srv.port}"
        with RespClient("127.0.0.1", srv.port) as r:
            seed_campaigns(r, gen.load_ids(str(tmp_path))[0])
        write_local_conf(tmp_path / "conf.yaml", {
            **conf, "redis.host": "127.0.0.1", "redis.port": srv.port,
            "kafka.topic": cfg.kafka_topic, "jax.batch.size": 256,
            "jax.scan.batches": 2})
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        p = subprocess.run(
            [sys.executable, "-m", "streambench_tpu_torch.engine",
             "--confPath", str(tmp_path / "conf.yaml"),
             "--workdir", str(tmp_path), "--device", "cpu",
             "--idleTimeout", "1"],
            capture_output=True, text=True, timeout=120, cwd=repo,
            env=dict(os.environ, PYTHONPATH=repo))
        assert p.returncode == 0, p.stderr[-2000:]
        stats = json.loads(p.stdout.strip().splitlines()[-1])
        with RespClient("127.0.0.1", srv.port) as r:
            got = read_seen_counts(r)
    finally:
        srv.stop()
        if kafka_srv is not None:
            kafka_srv.stop()
    assert stats["events"] == jstats.events == 6_000
    assert stats["dropped"] == 0 and stats["faults"] == {}
    assert got == jax_seen(jr)
    up = next(ln for ln in p.stdout.splitlines() if "engine up:" in ln)
    on = keys.get("jax.ingest.pipeline") == "on" or (
        keys.get("jax.ingest.pipeline") == "auto"
        and (os.cpu_count() or 1) > 1)
    assert f"pipeline={'on' if on else 'off'}" in up
