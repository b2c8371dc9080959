"""Checkpoint/resume of the port's engine, against the JAX engine's.

The port of ``tests/test_checkpoint.py`` (crash and resume against the
oracle, the snapshot round trip, both geometry mismatches, reader seek,
the checkpointer's rotation and torn file, a snapshot taken while drains
are parked, the device watermark's sentinels), with the JAX engine run on the same
seeded journal wherever both can: their Redis window rows must be equal.
Two cross-engine tests hold the npz format to one byte layout: a snapshot
the JAX engine saves mid-journal finishes in the port, and one the port
saves at a large key space (the drain thresholds patched low on both
engine classes) finishes in the JAX engine, each with the rows an
uninterrupted run writes.  All on the CPU; counts compare exactly.
"""

import json
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from streambench_tpu.checkpoint import Checkpointer as JaxCheckpointer
from streambench_tpu.checkpoint import _encode as jax_encode
from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import AdAnalyticsEngine as JaxEngine
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu.io.redis_schema import (
    write_windows_pipelined as jax_write,
)
from streambench_tpu_torch.checkpoint import Checkpointer, Snapshot, _encode
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.io.fakeredis import FakeRedisStore
from streambench_tpu_torch.io.journal import (
    FileBroker,
    JournalReader,
    JournalWriter,
)
from streambench_tpu_torch.io.redis_schema import (
    as_redis,
    read_seen_counts,
    seed_campaigns,
    write_windows_pipelined,
)
from streambench_tpu_torch.ops import windowcount as wc
from tests.test_torch_compact_drain import write_journal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def setup_run(tmp_path, events=12_000, batch=512):
    """The generator's dataset in ``tmp_path`` (seed 7), as the JAX
    package's checkpoint tests lay it out; ``r`` holds the seeded
    campaigns for the port's engine."""
    cfg = default_config(jax_batch_size=batch)
    r = as_redis(FakeRedisStore())
    broker = FileBroker(str(tmp_path / "broker"))
    gen.do_setup(r, cfg, broker=broker, events_num=events,
                 rng=random.Random(7), workdir=str(tmp_path))
    mapping = gen.load_ad_mapping_file(str(tmp_path / gen.AD_TO_CAMPAIGN_FILE))
    return cfg, r, broker, mapping


def port_engine(cfg, mapping, r=None, campaigns=None):
    return AdAnalyticsEngine(cfg, mapping, campaigns=campaigns, redis=r,
                             device="cpu")


def crash_resume(tmp_path, engine_cls, runner_cls, ckpt_cls, broker_cls, r,
                 cfg, mapping, ckpt_dir, first=6000):
    """Catch up ``first`` events with checkpoints, abandon the engine (the
    crash), resume a fresh one from the newest snapshot and finish."""
    ckpt = ckpt_cls(str(ckpt_dir))
    broker = broker_cls(str(tmp_path / "broker"))
    eng1 = engine_cls(cfg, mapping, redis=r)
    reader1 = broker.reader(cfg.kafka_topic)
    runner1_ = runner_cls(eng1, reader1, checkpointer=ckpt)
    runner1_.run_catchup(max_events=first)
    # run_catchup saved a final snapshot after its final flush
    snap = ckpt.load()
    assert snap is not None and snap.offset == reader1.offset
    del eng1, runner1_  # crash
    eng2 = engine_cls(cfg, mapping, redis=r)
    reader2 = broker.reader(cfg.kafka_topic)
    runner2 = runner_cls(eng2, reader2, checkpointer=ckpt)
    assert runner2.resume()
    assert reader2.offset == snap.offset
    runner2.run_catchup()
    eng2.close()
    return eng2


def test_crash_resume_matches_oracle_and_jax_engine(tmp_path):
    """Process half, snapshot, discard the engine, resume a fresh engine
    from the checkpoint and finish: oracle-exact, and the same rows as
    the JAX engine taking the same crash."""
    cfg, r, broker, mapping = setup_run(tmp_path)
    eng = crash_resume(tmp_path, lambda c, m, redis: port_engine(c, m, redis),
                       StreamRunner, Checkpointer, FileBroker, r, cfg,
                       mapping, tmp_path / "ckpt")
    assert eng.events_processed == 12_000
    correct, differ, missing = gen.check_correct(r, str(tmp_path),
                                                 log=lambda s: None)
    assert differ == 0 and missing == 0 and correct > 0

    jr = seeded_jax_store(gen.load_ids(str(tmp_path))[0])
    jcfg = jax_default_config(jax_batch_size=512)
    jeng = crash_resume(tmp_path, JaxEngine, JaxRunner, JaxCheckpointer,
                        JaxBroker, jr, jcfg, mapping, tmp_path / "jckpt")
    assert jeng.events_processed == 12_000
    assert read_seen_counts(r) == jax_seen(jr)


def test_streaming_run_checkpoints_and_resumes(tmp_path):
    """``StreamRunner.run`` (buffer timeout, small flush interval)
    checkpoints on its flush cadence and at exit; a fresh engine resumed
    from the newest snapshot finishes the journal oracle-exact."""
    cfg, r, broker, mapping = setup_run(tmp_path, events=6000, batch=256)
    ckpt = Checkpointer(str(tmp_path / "ckpt"), keep=50)
    eng = port_engine(cfg, mapping, r)
    runner = StreamRunner(eng, broker.reader(cfg.kafka_topic),
                          buffer_timeout_ms=5, flush_interval_ms=1,
                          checkpointer=ckpt, checkpoint_interval_ms=0)
    stats = runner.run(max_events=3000, idle_timeout_s=0.5)
    saved = ckpt._existing()
    assert stats.flushes >= 2 and len(saved) >= 2
    snap = ckpt.load()
    assert snap.meta["events_processed"] == stats.events >= 3000
    del eng, runner  # crash

    eng2 = port_engine(cfg, mapping, r)
    runner2 = StreamRunner(eng2, broker.reader(cfg.kafka_topic),
                           checkpointer=ckpt)
    assert runner2.resume()
    runner2.run_catchup()
    eng2.close()
    assert eng2.events_processed == 6000
    correct, differ, missing = gen.check_correct(r, str(tmp_path),
                                                 log=lambda s: None)
    assert differ == 0 and missing == 0 and correct > 0


def test_snapshot_restore_roundtrip_exact(tmp_path):
    """snapshot() -> restore() onto a fresh engine reproduces device state,
    pending deltas, latency ledger, and encoder base bit-exactly."""
    cfg, r, broker, mapping = setup_run(tmp_path, events=4000, batch=256)
    eng = port_engine(cfg, mapping, r)
    reader = broker.reader(cfg.kafka_topic)
    StreamRunner(eng, reader).run_catchup(max_events=2000)
    # leave undrained device counts AND a pending buffer behind
    lines = reader.poll(max_records=300)
    eng.process_chunk(lines[:150])
    eng._drain_device()
    eng.process_chunk(lines[150:])
    snap = eng.snapshot(reader.offset)
    assert snap.counts.any() and snap.pending

    eng2 = port_engine(cfg, mapping, r)
    eng2.restore(snap)
    assert eng2.encoder.base_time_ms == eng.encoder.base_time_ms
    for name in ("counts", "window_ids", "watermark", "dropped"):
        assert np.array_equal(getattr(eng2.state, name).numpy(),
                              getattr(eng.state, name).numpy()), name
    assert eng2.state.counts.dtype == torch.int32
    assert eng2.pending_counts() == eng.pending_counts() != {}
    assert eng2.window_latency == eng.window_latency
    assert eng2.events_processed == eng.events_processed
    assert eng2._span_start == eng._span_start


def test_campaign_count_mismatch_rejected(tmp_path):
    cfg, r, broker, mapping = setup_run(tmp_path, events=100, batch=64)
    eng = port_engine(cfg, mapping, r)
    snap = eng.snapshot(0)
    snap.meta["num_campaigns"] = 7
    with pytest.raises(ValueError, match="num_campaigns"):
        eng.restore(snap)


@pytest.mark.parametrize("key", ["window_slots", "divisor_ms",
                                 "lateness_ms", "engine_family"])
def test_ring_geometry_mismatch_rejected(tmp_path, key):
    """A snapshot taken under one (W, divisor, lateness) must not restore
    into an engine with another, nor one of another engine family."""
    cfg, r, broker, mapping = setup_run(tmp_path, events=100, batch=64)
    eng = port_engine(cfg, mapping, r)
    snap = eng.snapshot(0)
    if key == "engine_family":
        snap.meta[key] = "hll"
        match = "engine family"
    else:
        snap.meta[key] += 1
        match = key
    with pytest.raises(ValueError, match=match):
        eng.restore(snap)


def test_reader_seek_clears_handle_and_readahead(tmp_path):
    """resume() must physically reposition an already-polled reader: the
    open file handle and the read-ahead buffer both hold the old spot."""
    path = str(tmp_path / "t.jsonl")
    with JournalWriter(path) as w:
        w.append_many([f"line{i}" for i in range(6)])
    r = JournalReader(path)
    assert r.poll(2) == [b"line0", b"line1"]  # rest lands in read-ahead
    mid = r.offset
    assert r.poll(2) == [b"line2", b"line3"]
    r.seek(mid)
    assert r.poll(100) == [b"line2", b"line3", b"line4", b"line5"]
    assert r.offset == os.path.getsize(path)


def multi_partition_seek(tmp_path):
    cfg = default_config(jax_batch_size=256, kafka_partitions=3)
    broker = FileBroker(str(tmp_path / "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=900, partitions=3,
                 rng=random.Random(5), workdir=str(tmp_path))
    return cfg, broker


def test_multi_partition_offsets_seek(tmp_path):
    """``MultiReader.seek_offsets`` repositions every partition: a runner
    resumed from a per-partition vector reads only the unread tails."""
    cfg, broker = multi_partition_seek(tmp_path)
    mr = broker.multi_reader(cfg.kafka_topic)
    first = mr.poll(300)
    mid = list(mr.offsets)
    rest = mr.poll(10_000)
    assert len(first) + len(rest) == 900
    mr2 = broker.multi_reader(cfg.kafka_topic)
    mr2.poll(50)
    mr2.seek_offsets(mid)
    assert sorted(mr2.poll(10_000)) == sorted(rest)
    with pytest.raises(ValueError, match="offsets for"):
        mr2.seek_offsets(mid[:2])


def mk_snapshot(off):
    return Snapshot(
        offset=off, meta=dict(base_time_ms=0, span_start=None,
                              events_processed=off, windows_written=0,
                              started_ms=0, last_event_ms=0,
                              num_campaigns=3),
        counts=np.zeros((3, 4), np.int32),
        window_ids=np.full(4, -1, np.int32), watermark=0, dropped=0,
        pending=[(1, 20_000, 5)], latency=[(20_000, 12)])


def test_checkpointer_rotation_and_torn_file(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    p1 = ck.save(mk_snapshot(100))
    p2 = ck.save(mk_snapshot(200))
    p3 = ck.save(mk_snapshot(300))
    assert not os.path.exists(p1) and os.path.exists(p2)  # pruned to keep=2
    # tear the newest file: load falls back to the previous snapshot
    with open(p3, "wb") as f:
        f.write(b"\x00" * 10)
    snap = ck.load()
    assert snap is not None and snap.offset == 200
    assert snap.pending == [(1, 20_000, 5)]
    assert snap.latency == [(20_000, 12)]

    # a new Checkpointer in the same dir continues the sequence
    ck2 = Checkpointer(str(tmp_path / "ck"), keep=2)
    ck2.save(mk_snapshot(400))
    assert ck2.load().offset == 400


@pytest.mark.parametrize("offset", [123, [4, 5, 6]], ids=["scalar", "vector"])
def test_npz_layout_is_the_jax_packages(offset):
    """Both copies of the format encode one snapshot to the same arrays,
    byte for byte."""
    snap = mk_snapshot(7)
    snap.offset = offset
    snap.extra["xo_totals"] = np.arange(6, dtype=np.int64).reshape(2, 3)
    mine, theirs = _encode(snap), jax_encode(snap)
    assert sorted(mine) == sorted(theirs)
    for name in mine:
        assert mine[name].dtype == theirs[name].dtype, name
        assert mine[name].tobytes() == theirs[name].tobytes(), name


def test_snapshot_mid_deferral_carries_parked_cycle(tmp_path):
    """A snapshot taken while drain cycles are parked (deferred-pull
    rotation forced on the CPU) carries the parked deltas, so crash after
    snapshot + restore writes exactly what an uninterrupted engine
    writes."""
    workdir = str(tmp_path)
    campaigns, mapping = write_journal(workdir, 3000, seed=5,
                                       n_campaigns=10)
    with FileBroker(os.path.join(workdir, "broker")).reader(
            "ad-events") as rd:
        lines = rd.poll(max_records=3000)
    cfg = default_config(jax_batch_size=256, jax_window_slots=16)
    r = as_redis(FakeRedisStore())
    seed_campaigns(r, campaigns)
    src = port_engine(cfg, mapping, r, campaigns)
    src._defer_pull = True
    src.process_chunk(lines[:2000])
    src.flush()  # parks the first cycle (nothing written yet)
    assert src._undrained_ready and not read_seen_counts(r).get(
        campaigns[0])
    src.process_chunk(lines[2000:])
    src.flush()  # materializes+writes cycle 1; parks cycle 2
    assert src._undrained_ready
    snap = src.snapshot(offset=0)
    src.drain_writes()
    del src  # crash: no close(), the parked cycle only lives in snap

    dst = port_engine(cfg, mapping, r, campaigns)
    dst.restore(snap)
    dst.close()  # writes the snapshot-carried pending

    r2 = as_redis(FakeRedisStore())
    seed_campaigns(r2, campaigns)
    ref = port_engine(cfg, mapping, r2, campaigns)
    ref.process_chunk(lines)
    ref.close()
    assert read_seen_counts(r) == read_seen_counts(r2)
    assert sum(sum(v.values()) for v in read_seen_counts(r).values()) > 500


def test_restore_keeps_watermark_sentinels(tmp_path):
    """The device watermark comes back from a snapshot as it was: a
    legitimate relative watermark of 0 stays 0 and the NEG 'no events'
    sentinel stays NEG, so a restored engine that has seen no events
    still has none behind it."""
    cfg, r, broker, mapping = setup_run(tmp_path, events=100, batch=64)
    eng = port_engine(cfg, mapping, r)
    for watermark in (0, 12_345, wc.NEG):
        snap = eng.snapshot(0)
        snap.watermark = watermark
        dst = port_engine(cfg, mapping, r)
        dst.restore(snap)
        assert int(dst.state.watermark) == watermark


# ----------------------------------------------------------------------
# across engines, through checkpoint files


def seeded_jax_store(campaigns, prefix=None):
    """A JAX-package store with the campaigns and, optionally, the window
    rows ``prefix`` (``read_seen_counts`` form) an earlier run wrote."""
    r = jax_as_redis(JaxStore())
    jax_seed(r, campaigns)
    if prefix:
        jax_write(r, rows_of(prefix), time_updated=0)
    return r


def seeded_port_store(campaigns, prefix=None):
    r = as_redis(FakeRedisStore())
    seed_campaigns(r, campaigns)
    if prefix:
        write_windows_pipelined(r, rows_of(prefix), time_updated=0)
    return r


def rows_of(seen):
    return [(camp, ts, n) for camp, per in seen.items()
            for ts, n in per.items()]


def test_jax_snapshot_finishes_in_the_port(tmp_path):
    """The JAX engine catches up part of a journal and checkpoints; the
    port loads that file, restores and finishes: the same rows as the
    JAX engine finishing from the same snapshot."""
    workdir = str(tmp_path)
    campaigns, mapping = write_journal(workdir, 12_000, seed=23,
                                       n_campaigns=100)
    ov = dict(kafka_topic="ad-events", jax_batch_size=512)
    jcfg, cfg = jax_default_config(**ov), default_config(**ov)
    jr = seeded_jax_store(campaigns)
    jeng = JaxEngine(jcfg, mapping, campaigns=campaigns, redis=jr)
    jrd = JaxBroker(os.path.join(workdir, "broker")).reader("ad-events")
    JaxRunner(jeng, jrd, checkpointer=JaxCheckpointer(
        str(tmp_path / "ck"))).run_catchup(max_events=5000)
    jeng.drain_writes()
    del jeng  # stops here; its rows so far are in jr

    snap = Checkpointer(str(tmp_path / "ck")).load()
    assert snap.meta["engine_family"] == "exact" and snap.offset > 0
    tr = seeded_port_store(campaigns, prefix=jax_seen(jr))
    port = port_engine(cfg, mapping, tr, campaigns)
    prd = FileBroker(os.path.join(workdir, "broker")).reader("ad-events")
    runner = StreamRunner(port, prd, checkpointer=Checkpointer(
        str(tmp_path / "ck2")))
    runner.checkpointer.save(snap)
    assert runner.resume() and prd.offset == snap.offset
    runner.run_catchup()
    port.close()

    jeng2 = JaxEngine(jcfg, mapping, campaigns=campaigns, redis=jr)
    jrd2 = JaxBroker(os.path.join(workdir, "broker")).reader("ad-events")
    jrun = JaxRunner(jeng2, jrd2, checkpointer=JaxCheckpointer(
        str(tmp_path / "ck")))
    assert jrun.resume()
    jrun.run_catchup()
    jeng2.close()
    assert read_seen_counts(tr) == jax_seen(jr)
    assert port.events_processed == jeng2.events_processed == 12_000
    correct, differ, missing = gen.check_correct(tr, workdir,
                                                 log=lambda s: None)
    assert differ == 0 and missing == 0 and correct > 0


def test_port_snapshot_at_large_key_space_finishes_in_jax(tmp_path,
                                                          monkeypatch):
    """The port snapshots mid-journal with undrained counts at a large key
    space (thresholds patched low); the JAX engine restores that file,
    marks the live rows dirty and finishes: its rows equal the port's
    finishing from the same file, and an uninterrupted run's."""
    for cls in (JaxEngine, AdAnalyticsEngine):
        monkeypatch.setattr(cls, "COMPACT_DRAIN_MIN_CELLS", 1 << 12)
    workdir = str(tmp_path)
    campaigns, mapping = write_journal(workdir, 20_000, seed=29)
    ov = dict(kafka_topic="ad-events", jax_window_slots=64,
              jax_scan_batches=1, jax_batch_size=1024)
    jcfg, cfg = jax_default_config(**ov), default_config(**ov)

    src = port_engine(cfg, mapping, seeded_port_store(campaigns), campaigns)
    assert src._track_dirty_rows()
    with FileBroker(os.path.join(workdir, "broker")).reader(
            "ad-events") as rd:
        src.process_block(rd.poll_block(2_000_000))
        src.flush()
        src.process_block(rd.poll_block(500_000))
        ckpt = Checkpointer(str(tmp_path / "ck"))
        ckpt.save(src.snapshot(rd.offset))
    snap = ckpt.load()
    assert snap.counts.any() and snap.counts.shape == (1000, 64)
    # the rows src wrote before it stopped, for both finishing stores
    src.drain_writes()
    prefix = read_seen_counts(src.redis)

    # each finishing run checkpoints into its own copy of the directory
    for name in ("ck_jax", "ck_port"):
        shutil.copytree(tmp_path / "ck", tmp_path / name)

    jr = seeded_jax_store(campaigns, prefix)
    jeng = JaxEngine(jcfg, mapping, campaigns=campaigns, redis=jr)
    jrun = JaxRunner(jeng, JaxBroker(os.path.join(workdir, "broker"))
                     .reader("ad-events"),
                     checkpointer=JaxCheckpointer(str(tmp_path / "ck_jax")))
    assert jrun.resume() and jeng._dirty_rows
    jrun.run_catchup()
    jeng.close()

    tr = seeded_port_store(campaigns, prefix)
    port = port_engine(cfg, mapping, tr, campaigns)
    prun = StreamRunner(port, FileBroker(os.path.join(workdir, "broker"))
                        .reader("ad-events"),
                        checkpointer=Checkpointer(str(tmp_path / "ck_port")))
    assert prun.resume() and port._dirty_rows
    prun.run_catchup()
    port.close()

    want = seeded_port_store(campaigns)
    ref = port_engine(cfg, mapping, want, campaigns)
    with FileBroker(os.path.join(workdir, "broker")).reader(
            "ad-events") as rd:
        StreamRunner(ref, rd).run_catchup()
    ref.close()
    assert jax_seen(jr) == read_seen_counts(tr) == read_seen_counts(want)
    correct, differ, missing = gen.check_correct(tr, workdir,
                                                 log=lambda s: None)
    assert differ == 0 and missing == 0 and correct > 5_000


# ----------------------------------------------------------------------
# the CLI


def run_cli(conf, workdir, *extra):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.engine",
         "--confPath", str(conf), "--workdir", workdir, "--catchup",
         "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    return lines, json.loads(lines[-1])


def test_cli_checkpoint_dir_resumes(tmp_path):
    """Two runs over one journal with ``--checkpointDir``: the first stops
    early and checkpoints, the second resumes there and folds the rest."""
    workdir = str(tmp_path)
    write_journal(workdir, 6_000, seed=9, n_campaigns=100)
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\nkafka.topic: "ad-events"\n'
                    "jax.batch.size: 512\n")
    ck = str(tmp_path / "ck")
    lines1, st1 = run_cli(conf, workdir, "--checkpointDir", ck,
                          "--maxEvents", "2000")
    assert not any("resumed" in ln for ln in lines1)
    assert 2000 <= st1["events"] < 6000
    lines2, st2 = run_cli(conf, workdir, "--checkpointDir", ck)
    resumed = [ln for ln in lines2 if ln.startswith("resumed from checkpoint")]
    assert resumed and f"events={st1['events']}" in resumed[0]
    assert st1["events"] + st2["events"] == 6_000
    assert st2["dropped"] == 0 and st2["faults"] == {}
    snap = Checkpointer(ck).load()
    assert snap.meta["events_processed"] == 6_000
    assert snap.offset == os.path.getsize(
        FileBroker(os.path.join(workdir, "broker")).topic_path("ad-events"))


def test_cli_accepts_exactly_once(tmp_path):
    workdir = str(tmp_path)
    write_journal(workdir, 3_000, seed=9, n_campaigns=100)
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\nkafka.topic: "ad-events"\n'
                    "jax.sink.exactly_once: true\n")
    lines, st = run_cli(conf, workdir)
    assert st["events"] == 3_000 and st["windows_written"] > 0
    assert st["faults"] == {}
