"""The sketch engines of the port (BASELINE configs #2 and #3) against the
JAX package's, end to end on the CPU.

One generated journal goes through ``streambench_tpu``'s
``HLLDistinctEngine`` / ``SlidingTDigestEngine`` + ``StreamRunner`` and
through the port's on ``device="cpu"``, each into its own in-process
store, with one injected host clock (both packages' ``now_ms`` patched),
so the latency digests see the same samples.  Tolerances, per quantity:

- HLL: the registers, window ids, watermark and ``dropped`` bit-identical;
  Redis ``seen_count`` rows with the same keys, each within 1 (an
  estimate is a float32 sum truncated to an integer, and the two sums
  may differ in the last place).
- Sliding (sliced and unsliced): the state, ``dropped`` and every Redis
  row bit-identical.
- t-digest: weights exact in total per campaign; quantiles within 3.2 %
  relative (one histogram bin, 2^-5).

Also: the goldens of the reference's own tests (exact distinct users,
each view in its 10 sliding windows), scan equal to per-batch,
absolute re-flushes, checkpoint resume and snapshots across the two
packages both ways, HLL under exactly-once, the CLI against the JAX CLI,
the harness's ``ENGINE`` knob, the sliding method table.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import streambench_tpu.engine.sketches as jax_sketches
from streambench_tpu.checkpoint import Checkpointer as JaxCheckpointer
from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.fakeredis import make_store as jax_make_store
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_fence as jax_read_fence
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import StreamRunner
from streambench_tpu_torch.engine import __main__ as cli
from streambench_tpu_torch.engine import sketches
from streambench_tpu_torch.io.fakeredis import make_store
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    as_redis,
    fence_key,
    read_fence,
    read_seen_counts,
    seed_campaigns,
)
from streambench_tpu_torch.obs.xfer import TransferLedger
from streambench_tpu_torch.ops import methodbench, sliding
from tests.test_torch_engine import REPO, TOPIC, write_journal
from tests.test_torch_harness import (
    _await_window_progress,
    free_port,
    run_harness,
)

torch.set_num_threads(1)

CLOCK_MS = 1_700_000_400_000
QUANTILE_RTOL = 2.0 ** -5
KINDS = {"hll": ("HLLDistinctEngine", {}),
         "sliced": ("SlidingTDigestEngine", {"sliced": "on"}),
         "unsliced": ("SlidingTDigestEngine", {"sliced": "off"})}


@pytest.fixture(autouse=True)
def one_clock(monkeypatch):
    """Both packages' sketch engines read the same fixed host clock."""
    monkeypatch.setattr(jax_sketches, "now_ms", lambda: CLOCK_MS)
    monkeypatch.setattr(sketches, "now_ms", lambda: CLOCK_MS)


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """Two journals: the stock 10 ms spacing (batches halved by the span
    guard, per-batch folds) and 1 ms (stacked scan groups)."""
    out = {}
    for spacing in (10, 1):
        wd = str(tmp_path_factory.mktemp(f"sk{spacing}"))
        campaigns = write_journal(wd, 12_000, spacing, seed=31 + spacing)
        mapping = gen.load_ad_mapping_file(
            os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE))
        out[spacing] = (wd, campaigns, mapping)
    return out


def make(side, kind, cfg_kw, redis, campaigns, mapping):
    name, kw = KINDS[kind]
    if side == "jax":
        cfg = jax_default_config(kafka_topic=TOPIC, **cfg_kw)
        return getattr(jax_sketches, name)(cfg, mapping, campaigns=campaigns,
                                           redis=redis, **kw)
    cfg = default_config(kafka_topic=TOPIC, **cfg_kw)
    return getattr(sketches, name)(cfg, mapping, campaigns=campaigns,
                                   redis=redis, device="cpu", **kw)


def run_side(side, kind, wd, campaigns, mapping, cfg_kw=None, **runner_kw):
    """One catchup of the journal in ``wd``; returns (store, stats,
    engine), the engine closed."""
    if side == "jax":
        r = jax_as_redis(jax_make_store())
        jax_seed(r, campaigns)
        reader = JaxBroker(os.path.join(wd, "broker")).reader(TOPIC)
        runner_cls = JaxRunner
    else:
        r = as_redis(make_store())
        seed_campaigns(r, campaigns)
        reader = FileBroker(os.path.join(wd, "broker")).reader(TOPIC)
        runner_cls = StreamRunner
    eng = make(side, kind, cfg_kw or {}, r, campaigns, mapping)
    stats = runner_cls(eng, reader, **runner_kw).run_catchup()
    eng.close()
    reader.close()
    return r, stats, eng


def rows(seen: dict) -> dict:
    return {(c, w): n for c in seen for w, n in seen[c].items()}


def assert_rows_agree(kind, want: dict, got: dict):
    assert set(got) == set(want)
    if kind == "hll":
        assert max(abs(got[k] - want[k]) for k in want) <= 1
    else:
        assert got == want


def assert_digest_agrees(jeng, teng, r_jax, r_port):
    jw = np.asarray(jeng.digest.weights).sum(1)
    np.testing.assert_array_equal(teng.digest.weights.numpy().sum(1), jw)
    np.testing.assert_allclose(teng.quantiles(), jeng.quantiles(),
                               rtol=QUANTILE_RTOL, atol=1e-3)
    table = f"{teng.cfg.redis_hashtable}_quantiles"
    jq, tq = r_jax.hgetall(table), r_port.hgetall(table)
    assert set(tq) == set(jq)
    assert len(tq) == 3 * teng.encoder.num_campaigns
    for k in jq:
        assert float(tq[k]) == pytest.approx(float(jq[k]),
                                             rel=QUANTILE_RTOL, abs=0.1)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("spacing,cfg_kw", [
    (10, {}), (1, {"jax_batch_size": 1024, "jax_scan_batches": 4})],
    ids=["stock_halved_steps", "stacked_scan_groups"])
def test_catchup_matches_jax_engine(journals, kind, spacing, cfg_kw):
    wd, campaigns, mapping = journals[spacing]
    jr, jstats, jeng = run_side("jax", kind, wd, campaigns, mapping, cfg_kw)
    tr, tstats, teng = run_side("port", kind, wd, campaigns, mapping,
                                cfg_kw)
    assert tstats.events == jstats.events == 12_000
    assert teng.dropped == jeng.dropped
    assert teng.method == "scatter"
    want, got = rows(jax_seen(jr)), rows(read_seen_counts(tr))
    assert len(want) > 50
    assert_rows_agree(kind, want, got)
    if kind == "hll":
        np.testing.assert_array_equal(teng.state.registers.numpy(),
                                      np.asarray(jeng.state.registers))
    else:
        assert teng.sliced == jeng.sliced == (kind == "sliced")
        np.testing.assert_array_equal(teng.state.counts.numpy(),
                                      np.asarray(jeng.state.counts))
        assert_digest_agrees(jeng, teng, jr, tr)
    np.testing.assert_array_equal(teng.state.window_ids.numpy(),
                                  np.asarray(jeng.state.window_ids))
    assert int(teng.state.watermark) == int(jeng.state.watermark)


def _views(wd, mapping):
    with open(os.path.join(wd, gen.KAFKA_JSON_FILE)) as f:
        for line in f:
            ev = json.loads(line)
            if ev["event_type"] == "view":
                yield mapping[ev["ad_id"]], int(ev["event_time"]), ev


def test_hll_estimates_are_close_to_exact_distinct_users(journals):
    """The reference's golden: exact distinct users per (campaign, 10 s
    window) over views; the windows equal, the mean relative error of
    the estimates under 0.1 (``tests/test_sketch_engines.py:58-60``)."""
    wd, campaigns, mapping = journals[10]
    tr, stats, eng = run_side("port", "hll", wd, campaigns, mapping)
    assert eng.dropped == 0
    golden: dict = {}
    for c, t, ev in _views(wd, mapping):
        golden.setdefault((c, t // 10_000 * 10_000), set()).add(
            ev["user_id"])
    got = rows(read_seen_counts(tr))
    assert set(got) == set(golden)
    err = [abs(got[k] - len(u)) / len(u) for k, u in golden.items()]
    assert np.mean(err) < 0.1, np.mean(err)


@pytest.mark.parametrize("kind", ["sliced", "unsliced"])
def test_sliding_windows_equal_the_golden(journals, kind):
    """Each view lands in the 10 sliding windows covering it
    (``tests/test_sketch_engines.py:101-114``); the digest weighs every
    view once."""
    wd, campaigns, mapping = journals[10]
    tr, stats, eng = run_side("port", kind, wd, campaigns, mapping)
    assert eng.dropped == 0
    golden: dict = {}
    views = 0
    for c, t, _ in _views(wd, mapping):
        views += 1
        for k in range(10):
            start = (t // 1000 - k) * 1000
            golden[(c, start)] = golden.get((c, start), 0) + 1
    assert rows(read_seen_counts(tr)) == golden
    assert float(eng.digest.weights.sum()) == views
    q = eng.quantiles()
    assert (q[:, 0] <= q[:, 1] + 1e-3).all()
    assert (q[:, 1] <= q[:, 2] + 1e-3).all()


@pytest.mark.parametrize("kind", ["hll", "sliced"])
def test_scan_equals_per_batch(journals, kind):
    """Folding stacked scan groups gives the state the per-batch path
    gives (the digest's two folds differ, its weights do not)."""
    wd, campaigns, mapping = journals[1]
    with open(os.path.join(wd, gen.KAFKA_JSON_FILE), "rb") as f:
        lines = f.read().splitlines()[:6_000]
    cfg_kw = {"jax_batch_size": 512, "jax_scan_batches": 4}
    a = make("port", kind, cfg_kw, None, campaigns, mapping)
    for off in range(0, len(lines), 512):
        a.fold_batches([a.encoder.encode(lines[off:off + 512], 512)])
    b = make("port", kind, cfg_kw, None, campaigns, mapping)
    assert b.SCAN_SUPPORTED
    b.process_chunk(lines)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    if kind != "hll":
        assert torch.equal(a.digest.weights.sum(1), b.digest.weights.sum(1))


def test_hll_absolute_reflush_matches_jax(journals):
    """A flush at every poll round rewrites still-open windows: HSET, so
    each window exists once and holds an estimate, not a sum of them;
    the port writes what the JAX engine writes."""
    wd, campaigns, mapping = journals[10]
    jr, _, jeng = run_side("jax", "hll", wd, campaigns, mapping,
                           flush_interval_ms=0)
    tr, _, teng = run_side("port", "hll", wd, campaigns, mapping,
                           flush_interval_ms=0)
    want, got = rows(jax_seen(jr)), rows(read_seen_counts(tr))
    assert_rows_agree("hll", want, got)
    exact: dict = {}
    for c, t, ev in _views(wd, mapping):
        exact.setdefault((c, t // 10_000 * 10_000), set()).add(
            ev["user_id"])
    assert all(got[k] <= 2 * len(u) for k, u in exact.items())
    assert teng.windows_written == jeng.windows_written >= len(got)


# ----------------------------------------------------------------------
# checkpoints
def _crash_resume(side, kind, wd, campaigns, mapping, ckdir, crash_after):
    """Catch up ``crash_after`` events with a snapshot after every
    flush, abandon the engine, resume a fresh one from the newest
    snapshot, finish.  Returns (store, resumed engine)."""
    jax = side == "jax"
    r = (jax_as_redis(jax_make_store()) if jax else as_redis(make_store()))
    (jax_seed if jax else seed_campaigns)(r, campaigns)
    broker = (JaxBroker if jax else FileBroker)(os.path.join(wd, "broker"))
    ckpt_cls = JaxCheckpointer if jax else Checkpointer
    runner_cls = JaxRunner if jax else StreamRunner
    cfg_kw = {"jax_batch_size": 512}
    a = make(side, kind, cfg_kw, r, campaigns, mapping)
    runner_cls(a, broker.reader(TOPIC), checkpointer=ckpt_cls(ckdir),
               checkpoint_interval_ms=0).run_catchup(max_events=crash_after)
    a.drain_writes()
    del a                                           # crash: no close()
    b = make(side, kind, cfg_kw, r, campaigns, mapping)
    run = runner_cls(b, broker.reader(TOPIC), checkpointer=ckpt_cls(ckdir),
                     checkpoint_interval_ms=0)
    assert run.resume()
    run.run_catchup()
    b.close()
    return r, b


@pytest.mark.parametrize("kind", ["hll", "sliced", "unsliced"])
def test_crash_resume_equals_uninterrupted_and_jax(journals, tmp_path,
                                                   kind):
    wd, campaigns, mapping = journals[10]
    base_r, _, base = run_side("port", kind, wd, campaigns, mapping,
                               {"jax_batch_size": 512})
    r, eng = _crash_resume("port", kind, wd, campaigns, mapping,
                           str(tmp_path / "ck"), 5_000)
    jr, jeng = _crash_resume("jax", kind, wd, campaigns, mapping,
                             str(tmp_path / "ckj"), 5_000)
    assert eng.dropped == base.dropped == jeng.dropped == 0
    assert read_seen_counts(r) == read_seen_counts(base_r)
    assert_rows_agree(kind, rows(jax_seen(jr)), rows(read_seen_counts(r)))
    if kind == "hll":
        assert torch.equal(eng.state.registers, base.state.registers)
    else:
        assert torch.equal(eng.digest.weights.sum(),
                           base.digest.weights.sum())


@pytest.mark.parametrize("kind", ["hll", "sliced"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_load_across_packages(journals, tmp_path, kind,
                                        direction):
    """A snapshot one package wrote mid-journal finishes in the other;
    the rows equal the writer's own uninterrupted run's (HLL: within 1)."""
    wd, campaigns, mapping = journals[10]
    first, second = direction.split("_to_")
    first = "jax" if first == "jax" else "port"
    second = "jax" if second == "jax" else "port"
    ckdir = str(tmp_path / "ck")
    cfg_kw = {"jax_batch_size": 512}

    def parts(side):
        jax = side == "jax"
        r = jax_as_redis(jax_make_store()) if jax else as_redis(
            make_store())
        (jax_seed if jax else seed_campaigns)(r, campaigns)
        broker = (JaxBroker if jax else FileBroker)(
            os.path.join(wd, "broker"))
        return (r, broker, JaxCheckpointer if jax else Checkpointer,
                JaxRunner if jax else StreamRunner)

    r1, broker1, ck1, run1 = parts(first)
    a = make(first, kind, cfg_kw, r1, campaigns, mapping)
    run1(a, broker1.reader(TOPIC), checkpointer=ck1(ckdir),
         checkpoint_interval_ms=0).run_catchup(max_events=6_000)
    a.drain_writes()
    r2, broker2, ck2, run2 = parts(second)
    b = make(second, kind, cfg_kw, r2, campaigns, mapping)
    runner = run2(b, broker2.reader(TOPIC), checkpointer=ck2(ckdir),
                  checkpoint_interval_ms=0)
    assert runner.resume()
    assert b.events_processed == a.events_processed
    runner.run_catchup()
    b.close()
    # what both stores hold together (the snapshot covers every flush
    # of the first engine): window deltas add, HLL estimates are
    # replaced by the second engine's; against the second package's
    # uninterrupted run
    want_r, _, _ = run_side(second, kind, wd, campaigns, mapping, cfg_kw)
    seen = {"jax": jax_seen, "port": read_seen_counts}
    want = rows(seen[second](want_r))
    got = rows(seen[first](r1))
    later = rows(seen[second](r2))
    assert len(later) > 20
    for k, n in later.items():
        got[k] = n if kind == "hll" else got.get(k, 0) + n
    assert_rows_agree(kind, want, got)


def test_restore_refuses_other_geometry_and_family(journals):
    wd, campaigns, mapping = journals[10]
    h = make("port", "hll", {}, None, campaigns, mapping)
    snap = h.snapshot(offset=0)
    with pytest.raises(ValueError, match="num_registers"):
        sketches.HLLDistinctEngine(default_config(), mapping,
                                   campaigns=campaigns, registers=64,
                                   device="cpu").restore(snap)
    s_on = make("port", "sliced", {}, None, campaigns, mapping)
    s_off = make("port", "unsliced", {}, None, campaigns, mapping)
    with pytest.raises(ValueError, match="sliced"):
        s_off.restore(s_on.snapshot(offset=0))
    with pytest.raises(ValueError, match="engine family"):
        s_on.restore(snap)


# ----------------------------------------------------------------------
def test_hll_exactly_once_resume_writes_absolute_like_jax(journals,
                                                          tmp_path):
    """HLL under ``jax.sink.exactly_once``: a crash after a flush that no
    snapshot covers; the resumed engine reconciles every window it
    flushes absolute (HSET from its ledger, never HINCRBY), so the sink
    ends with the estimates an uninterrupted run writes.  Both packages,
    the same fences."""
    wd, campaigns, mapping = journals[10]
    over = dict(jax_batch_size=512, jax_sink_exactly_once=True,
                jax_sink_retry_base_ms=1, jax_sink_retry_cap_ms=4,
                redis_hashtable="")
    quiet = dict(flush_interval_ms=10**9)

    def scenario(side):
        jax = side == "jax"
        r = jax_as_redis(jax_make_store()) if jax else as_redis(
            make_store())
        (jax_seed if jax else seed_campaigns)(r, campaigns)
        broker = (JaxBroker if jax else FileBroker)(
            os.path.join(wd, "broker"))
        ckpt = (JaxCheckpointer if jax else Checkpointer)(
            str(tmp_path / side))
        runner_cls = JaxRunner if jax else StreamRunner
        fence = (lambda: jax_read_fence(r, fence_key(TOPIC))) if jax else (
            lambda: read_fence(r, fence_key(TOPIC)))
        a = make(side, "hll", over, r, campaigns, mapping)
        reader_a = broker.reader(TOPIC)
        runner_cls(a, reader_a, checkpointer=ckpt,
                   **quiet).run_catchup(max_events=5_000)
        runner_cls(a, reader_a, **quiet).run_catchup(max_events=3_000)
        a.drain_writes()
        assert fence()[1] > ckpt.load().meta["sink_seq"]
        del a                                         # crash: no close()
        b = make(side, "hll", over, r, campaigns, mapping)
        run_b = runner_cls(b, broker.reader(TOPIC), checkpointer=ckpt,
                           **quiet)
        assert run_b.resume()
        stats = run_b.run_catchup()
        b.close()
        assert stats.faults.get("sink_unfenced_resumes", 0) > 0
        assert stats.faults.get("reconciled_windows", 0) > 0
        return fence(), rows((jax_seen if jax else read_seen_counts)(r))

    jfence, jrows = scenario("jax")
    tfence, trows = scenario("port")
    assert tfence == jfence and tfence[0] == 2
    assert_rows_agree("hll", jrows, trows)
    # HSET, not HINCRBY: the estimates an uninterrupted run writes
    base_r, _, _ = run_side("port", "hll", wd, campaigns, mapping,
                            {"jax_batch_size": 512})
    assert_rows_agree("hll", rows(read_seen_counts(base_r)), trows)


# ----------------------------------------------------------------------
# the CLI
def _cli(module, wd, engine, extra=()):
    conf = os.path.join(wd, "conf.yaml")
    with open(conf, "w") as f:
        f.write(f'redis.host: ":inprocess:"\nkafka.topic: "{TOPIC}"\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", module, "--confPath", conf, "--workdir", wd,
         "--catchup", "--engine", engine, *extra],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip().splitlines()


@pytest.mark.parametrize("engine", ["hll", "sliding"])
def test_cli_engine_on_cpu_matches_the_jax_cli(tmp_path, engine):
    wd = str(tmp_path)
    write_journal(wd, 5_000, 10, seed=9)
    port = _cli("streambench_tpu_torch.engine", wd, engine,
                ["--device", "cpu"])
    jax = _cli("streambench_tpu.engine", wd, engine)
    assert any("engine up:" in ln and f"engine={engine}" in ln
               and "device=cpu" in ln for ln in port)
    got, want = json.loads(port[-1]), json.loads(jax[-1])
    assert got["events"] == want["events"] == 5_000
    assert got["dropped"] == want["dropped"] == 0
    assert got["windows_written"] == want["windows_written"] > 0
    assert got["kernel_launches"]["count_cells"] == 0     # CPU: no kernel


@pytest.mark.parametrize("extra", [
    ["--engine", "reach"], ["--engine", "hllx"],
    ["--sharded", "--engine", "hll"], ["--sharded", "--engine", "sliding"]],
    ids=["reach", "hllx", "sharded_hll", "sharded_sliding"])
def test_cli_still_refuses_what_is_not_ported(tmp_path, capsys, extra):
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\n')
    rc = cli.main(["--confPath", str(conf), "--workdir", str(tmp_path),
                   "--device", "cpu", *extra])
    err = capsys.readouterr().err
    assert rc == 2 and "not ported" in err


@pytest.mark.parametrize("name", ["HLLDistinctEngine",
                                  "SlidingTDigestEngine"])
def test_sketch_engines_default_to_cuda_and_raise_without_it(monkeypatch,
                                                             name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls = getattr(sketches, name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(default_config(), {"ad": "camp"})
    assert cls(default_config(), {"ad": "camp"},
               device="cpu").device.type == "cpu"


def test_device_decode_on_keeps_the_host_encode_and_says_so(capsys):
    cfg = dataclasses.replace(default_config(), jax_decode_device="on")
    for cls in (sketches.HLLDistinctEngine, sketches.SlidingTDigestEngine):
        eng = cls(cfg, {"a" * 36: "c1"}, device="cpu")
        assert eng._devdecode is None
        assert "host encode" in capsys.readouterr().err


def test_hll_wire_and_device_memory_accounting(journals):
    """HLL's scans ship the packed word, the user ids and the times: 12
    bytes a row; a CPU engine reports no kernel footprint."""
    wd, campaigns, mapping = journals[1]
    with open(os.path.join(wd, gen.KAFKA_JSON_FILE), "rb") as f:
        lines = f.read().splitlines()[:4_096]
    eng = make("port", "hll", {"jax_batch_size": 512,
                               "jax_scan_batches": 4}, None, campaigns,
               mapping)
    ledger = TransferLedger(sample_every=0)
    eng._obs_xfer = ledger
    eng.process_chunk(lines)
    fmt = ledger.summary()["formats"]["packed"]
    assert fmt["bytes_per_row"] == 12 and fmt["events"] == 4_096
    assert eng._devmem_kernels() == []
    sl = make("port", "sliced", {}, None, campaigns, mapping)
    assert sl._devmem_kernels() == []


# ----------------------------------------------------------------------
# the harness
@pytest.mark.parametrize("engine", ["hll", "sliding"])
def test_harness_engine_knob_on_cpu(tmp_path, engine):
    wd = str(tmp_path / "run")
    port = free_port()
    env = {"WORKDIR": wd, "REDIS_PORT": str(port), "LOAD": "400",
           "STOP_STATS_GRACE": "3", "TOPIC": "ad-events", "DEVICE": "cpu",
           "ENGINE": engine}
    up = run_harness(["SETUP", "START_REDIS", "START_TORCH_PROCESSING",
                      "START_LOAD"], env, timeout=180)
    quantiles = {}
    try:
        assert up.returncode == 0, up.stdout + up.stderr
        _await_window_progress(port, min_windows=3, deadline_s=90)
    finally:
        down = run_harness(["STOP_LOAD", "STOP_TORCH_PROCESSING"], env,
                           timeout=180)
        if engine == "sliding":
            from streambench_tpu_torch.io.resp import RespClient

            with RespClient("127.0.0.1", port, timeout_s=5.0) as c:
                # the harness's conf keeps redis.hashtable's default
                quantiles = c.hgetall("t1_quantiles") or {}
        stop = run_harness(["STOP_REDIS", "STOP_ALL"], env)
    assert down.returncode == 0, down.stdout + down.stderr
    assert stop.returncode == 0, stop.stdout + stop.stderr
    seen = open(os.path.join(wd, "seen.txt")).read().split()
    assert seen and all(int(s) > 0 for s in seen)
    engine_log = open(os.path.join(wd, "logs", "engine.log")).read()
    assert f"engine={engine}" in engine_log and "device=cpu" in engine_log
    stats = json.loads(engine_log.strip().splitlines()[-1])
    load_log = open(os.path.join(wd, "logs", "load.log")).read()
    emitted = int(load_log.split("emitted ")[-1].split()[0])
    assert stats["events"] == emitted > 0 and stats["dropped"] == 0
    if engine == "sliding":
        assert len(quantiles) == 3 * 100


def test_harness_refuses_verify_with_a_sketch_engine(tmp_path):
    env = {"WORKDIR": str(tmp_path / "run"), "ENGINE": "hll", "VERIFY": "1",
           "DEVICE": "cpu"}
    proc = run_harness(["SETUP"], env)
    assert proc.returncode != 0
    assert "VERIFY" in proc.stdout + proc.stderr
    assert "ENGINE=hll" in proc.stdout + proc.stderr


# ----------------------------------------------------------------------
# the sliding method table
@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "method_bench.json"
    monkeypatch.setenv("STREAMBENCH_TORCH_METHOD_CACHE", str(path))
    return path


def test_sliding_keys_and_auto_read_the_ports_cache(cache):
    assert methodbench.sliding_key("cuda", 10) == "cuda/sliding/S10"
    assert methodbench.sliding_winner("cpu", 10) is None
    # unmeasured: sliced wherever the plane fits (2^27 cells)
    assert sketches._sliced_auto("cpu", 10, 100, 2048) is True
    assert sketches._sliced_auto("cpu", 10, 100_000, 2048) is False
    assert sketches._sliced_auto("cpu", 10, 100, 8) is False
    methodbench.record("cpu/sliding/S10", {"winner": "scatter"})
    assert methodbench.sliding_winner("cpu", 10) == "scatter"
    assert sketches._sliced_auto("cpu", 10, 100, 2048) is False
    assert sketches._sliced_auto("cuda", 10, 100, 2048) is True
    eng = sketches.SlidingTDigestEngine(default_config(), {"ad": "camp"},
                                        device="cpu")
    assert eng.sliced is False and eng.W == 2048
    methodbench.record("cpu/sliding/S10", {"winner": "sliced"})
    assert sketches.SlidingTDigestEngine(default_config(), {"ad": "camp"},
                                         device="cpu").sliced is True


def test_sliding_winner_holds_only_at_its_measured_geometry(cache):
    methodbench.record("cpu/sliding/S10", {
        "winner": "scatter", "num_campaigns": 100, "window_slots": 128})
    assert methodbench.sliding_winner("cpu", 10) == "scatter"
    assert methodbench.sliding_winner("cpu", 10, 100, 128) == "scatter"
    assert methodbench.sliding_winner("cpu", 10, 100, 2048) is None
    assert methodbench.sliding_winner("cpu", 10, 8, 128) is None
    # a winner from a 128-slot ring does not decide the 2048-slot one
    assert sketches._sliced_auto("cpu", 10, 100, 128) is False
    assert sketches._sliced_auto("cpu", 10, 100, 2048) is True
    assert sliding.ring_slots(100) == 2048
    assert sliding.ring_slots(1_000_000) == 134
    assert sliding.ring_slots(10_000_000) == 99


def test_measure_sliding_checks_every_arm_on_cpu(cache):
    res = methodbench.measure_sliding(num_campaigns=8, window_slots=128,
                                      batch_size=256, iters=2,
                                      device="cpu")
    assert set(res["methods"]) == set(methodbench.SLIDING_METHODS)
    assert all("ns_per_event" in v for v in res["methods"].values()), res
    assert res["memberships"] == 10 and res["winner"]
    assert res["sliced_count_method"] == "scatter"


def test_cli_family_sliding_smoke_records_the_winner(cache):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.ops.methodbench",
         "--family", "sliding", "--smoke", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout)
    assert set(res) == {"sliding"}
    data = json.loads(cache.read_text())
    assert data["cpu/sliding/S10"]["winner"] == res["sliding"]["winner"]
    # measured at the ring the engine sizes for the smoke's 8 campaigns
    assert res["sliding"]["window_slots"] == sliding.ring_slots(8) == 2048


# ----------------------------------------------------------------------
# chip_smoke.py phase 15, rehearsed on the CPU at a small size
def test_chip_smoke_phase15_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 15 through the smoke's own code (the op check, the goldens,
    the store read-back, the resume) on the CPU at 150,000 events; the
    card runs it at 1,000,000."""
    import chip_smoke

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        return str(path)

    monkeypatch.setattr(chip_smoke, "_workdir", workdir)
    out = chip_smoke.phase_sketches(150_000, device="cpu")
    assert out["ops"]["hll"]["registers_equal"]
    assert out["hll"]["mean_rel_err"] < 0.1
    assert out["hll"]["windows"] > 1_000
    assert out["sliced"]["quantile_fields"] == 300
    assert out["sliced"]["digest_weight"] == out["views"]
    # held against the same engines on the CPU, under one fixed clock
    assert out["hll"]["cpu_rows_max_abs_diff"] <= 1
    assert out["hll"]["cpu_open_windows_equal"] > 0
    assert out["sliced"]["quantiles_ms"]["p50_min"] > 0
    assert out["sliced"]["cpu_quantile_max_rel_err"] <= 2.0 ** -5
    assert out["unsliced"]["cpu_quantile_max_rel_err"] <= 2.0 ** -5
    for run in ("hll", "sliced"):
        res = out["resume"][run]
        assert 0 < res["crashed_at_events"] < 150_000
        assert res["events_after_resume"] == 150_000 - res["crashed_at_events"]
