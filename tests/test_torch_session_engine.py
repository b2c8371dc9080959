"""The port's session engine (BASELINE config #4) against the JAX
package's, end to end on the CPU.

One generated journal (the generator's event source over 300 users, 20
ms apart, so sessions close under a 2 s gap) goes through
``streambench_tpu``'s ``SessionCMSEngine`` + ``StreamRunner`` and through
the port's on ``device="cpu"``, each with its own in-process store, under
one injected host clock (both packages' ``now_ms`` patched) and a flush
after every chunk (``flush_interval_ms=0``), so both drain at the same
points.  Everything compared is integer: the session arrays, the sketch
(fixed, two-stage and SALSA planes), the heavy-hitter ring, the latency
histogram, the counters and the ``<hashtable>_hh`` rows must be
bit-identical; no tolerance.

Also: the reference's golden (every click in some closed session, the
reported estimates at least the exact clicks), checkpoint resume and
snapshots across the two packages both ways, the refusals, the legacy
snapshot's ring reseed, the CLI against the JAX CLI, ``ENGINE=session``
in the harness, the count-min method table and ``jax.cms.mode: auto``.
"""

import dataclasses
import json
import os
import random
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
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.datagen.gen import make_ids
from streambench_tpu_torch.engine import StreamRunner
from streambench_tpu_torch.engine import sketches
from streambench_tpu_torch.io.fakeredis import make_store
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import as_redis
from streambench_tpu_torch.obs.sampler import engine_collector
from streambench_tpu_torch.ops import cms, methodbench, salsa
from tests.test_torch_engine import REPO, TOPIC
from tests.test_torch_harness import free_port, run_harness

torch.set_num_threads(1)

CLOCK_MS = 1_700_000_500_000
GAP_MS = 2_000
EVENTS = 16_000
FAMILIES = {"fixed": {}, "salsa": {"cms_mode": "salsa", "cms_width": 32},
            "twostage": {"cms_stages": 2}}
PATHS = {"scan": {"jax_batch_size": 512, "jax_scan_batches": 4},
         "per_batch": {"jax_batch_size": 512, "jax_scan_batches": 1}}


@pytest.fixture(autouse=True)
def one_clock(monkeypatch):
    """Both packages' sketch engines read the same fixed host clock."""
    monkeypatch.setattr(jax_sketches, "now_ms", lambda: CLOCK_MS)
    monkeypatch.setattr(sketches, "now_ms", lambda: CLOCK_MS)


def write_session_journal(workdir, n, users=300, spacing_ms=20, seed=5):
    """The generator's events over ``users`` users, ``spacing_ms`` apart:
    ids, the ad map, the broker topic and ``kafka-json.txt``."""
    rng = random.Random(seed)
    campaigns = make_ids(10, rng)
    ads = make_ids(100, rng)
    gen.write_ids(campaigns, ads, workdir)
    gen.write_ad_mapping_file(campaigns, ads, workdir)
    src = gen.EventSource(ads=ads, user_ids=make_ids(users, rng),
                          page_ids=make_ids(10, rng), rng=rng)
    start = 1_700_000_000_000
    blob = "".join(src.event_at(start + spacing_ms * i) + "\n"
                   for i in range(n)).encode()
    with open(os.path.join(workdir, gen.KAFKA_JSON_FILE), "wb") as f:
        f.write(blob)
    with FileBroker(os.path.join(workdir, "broker")).writer(
            TOPIC, append=False) as w:
        w.append_bytes(blob)
    return campaigns, gen.load_ad_mapping_file(
        os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE))


@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("session"))
    campaigns, mapping = write_session_journal(wd, EVENTS)
    return wd, campaigns, mapping


def make(side, cfg_kw, redis, campaigns, mapping, **kw):
    kw = {"gap_ms": GAP_MS, "cms_width": 256, "top_k": 8, **kw}
    if side == "jax":
        cfg = jax_default_config(kafka_topic=TOPIC, **cfg_kw)
        return jax_sketches.SessionCMSEngine(cfg, mapping,
                                             campaigns=campaigns,
                                             redis=redis, **kw)
    cfg = default_config(kafka_topic=TOPIC, **cfg_kw)
    return sketches.SessionCMSEngine(cfg, mapping, campaigns=campaigns,
                                     redis=redis, device="cpu", **kw)


def parts(side, wd, campaigns):
    jax = side == "jax"
    r = jax_as_redis(jax_make_store()) if jax else as_redis(make_store())
    broker = (JaxBroker if jax else FileBroker)(os.path.join(wd, "broker"))
    return (r, broker, JaxCheckpointer if jax else Checkpointer,
            JaxRunner if jax else StreamRunner)


def run_side(side, wd, campaigns, mapping, cfg_kw, max_events=None,
             ckdir=None, resume=False, close=True, **kw):
    """One catchup (a flush after every chunk) into a fresh store;
    returns (store, engine, stats)."""
    r, broker, ck_cls, runner_cls = parts(side, wd, campaigns)
    eng = make(side, cfg_kw, r, campaigns, mapping, **kw)
    ck = {} if ckdir is None else {"checkpointer": ck_cls(ckdir),
                                   "checkpoint_interval_ms": 0}
    runner = runner_cls(eng, broker.reader(TOPIC), flush_interval_ms=0,
                        **ck)
    if resume:
        assert runner.resume()
    stats = runner.run_catchup(max_events=max_events)
    if close:
        eng.close()
    return r, eng, stats


def leaves(x):
    out = []
    for v in x:
        out += leaves(v) if isinstance(v, tuple) else [
            v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)]
    return out


def state_of(eng) -> dict:
    return {"session": leaves(eng.state), "sketch": leaves(eng.cms),
            "ring": leaves(eng.topk), "hist": leaves((eng.lat_hist,)),
            "counters": [np.asarray([eng.sessions_closed,
                                     eng.session_clicks, eng.dropped])]}


def assert_states_equal(want: dict, got: dict, parts=None):
    for name in parts or want:
        assert len(got[name]) == len(want[name]), name
        for a, b in zip(want[name], got[name]):
            assert b.dtype == a.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)


def hh_rows(r, eng):
    return r.hgetall(f"{eng.cfg.redis_hashtable}_hh")


# ----------------------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("path", list(PATHS))
def test_catchup_matches_jax_engine(journal, family, path):
    wd, campaigns, mapping = journal
    jr, jeng, jstats = run_side("jax", wd, campaigns, mapping, PATHS[path],
                                **FAMILIES[family])
    tr, teng, tstats = run_side("port", wd, campaigns, mapping,
                                PATHS[path], **FAMILIES[family])
    assert tstats.events == jstats.events == EVENTS
    assert teng.SCAN_SUPPORTED and teng.cms_mode == jeng.cms_mode
    assert_states_equal(state_of(jeng), state_of(teng))
    assert teng.sessions_closed > 1_000 and teng.dropped == 0
    assert hh_rows(tr, teng) == hh_rows(jr, jeng) != {}
    assert teng.heavy_hitters() == jeng.heavy_hitters()
    assert teng.latency_quantile((0.5, 0.99)) == \
        jeng.latency_quantile((0.5, 0.99))
    if family == "salsa":
        assert salsa.stats(teng.cms)["merged_pairs"] > 0


def _clicks_by_user(wd):
    clicks: dict = {}
    with open(os.path.join(wd, gen.KAFKA_JSON_FILE)) as f:
        for line in f:
            ev = json.loads(line)
            if ev["event_type"] == "click":
                clicks[ev["user_id"]] = clicks.get(ev["user_id"], 0) + 1
    return clicks


def _scan_states(family, U=256, D=4, W=256, M=8):
    """(reference, port) initial sketch-fold states of ``family``."""
    from streambench_tpu.ops import cms as jcms
    from streambench_tpu.ops import salsa as jsalsa
    from streambench_tpu.ops import session as jsession
    from streambench_tpu_torch.ops import session as psession

    if family == "fixed":
        jc, pc = jcms.init_state(D, W), cms.init_state(D, W)
    elif family == "twostage":
        jc, pc = jcms.init_two_stage(D, W), cms.init_two_stage(D, W)
    else:
        jc, pc = jsalsa.init_state(D, 32), salsa.init_state(D, 32)
    i32 = np.int32(0)
    ref = [jsession.init_state(U), jc, jcms.init_topk(M), i32, i32,
           np.zeros(sketches.LAT_BINS, np.int32)]
    port = [psession.init_state(U), pc, cms.init_topk(M),
            torch.tensor(0, dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32),
            torch.zeros(sketches.LAT_BINS, dtype=torch.int32)]
    return ref, port


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fused_scan_matches_the_reference_scan(family, monkeypatch):
    """The port's ``_session_cms_scan`` (each closed set's update and
    query through ``cms.update_query``) against the reference's
    ``_session_cms_scan`` on the same seeded ``[N, B]`` chunks, three in
    a row with their own salts: every output bit-identical after each,
    and the sketch reached once a closed set through the fused entry."""
    import jax.numpy as jnp

    fused = []
    inner = cms.update_query

    def counted(*a):
        fused.append(a[1].shape[0])
        return inner(*a)

    monkeypatch.setattr(cms, "update_query", counted)
    rng = np.random.default_rng(12)
    ref, port = _scan_states(family)
    N, B, t = 4, 128, 0
    for chunk in range(3):
        users = rng.integers(-2, 300, (N, B)).astype(np.int32)
        etype = rng.integers(0, 3, (N, B)).astype(np.int32)
        times = (t + np.cumsum(rng.integers(0, 40, (N, B)), axis=1)
                 ).astype(np.int32)
        t = int(times.max()) + 2_500 * (chunk + 1)
        valid = rng.random((N, B)) < 0.9
        cols = (users, etype, times, valid)
        ref = list(jax_sketches._session_cms_scan(
            *ref, 90_000, jnp.int32(chunk + 1), *map(jnp.asarray, cols),
            gap_ms=GAP_MS, lateness_ms=1_000))
        port = list(sketches._session_cms_scan(
            *port, 90_000, chunk + 1, *map(torch.from_numpy, cols),
            gap_ms=GAP_MS, lateness_ms=1_000))
        for name, want, got in zip(("session", "sketch", "ring", "closed",
                                    "clicks", "hist"), ref, port):
            want, got = leaves((want,)), leaves((got,))
            assert len(want) == len(got), name
            for a, b in zip(want, got):
                assert b.dtype == a.dtype, name
                np.testing.assert_array_equal(b, a, err_msg=f"{name}, "
                                                            f"chunk {chunk}")
    assert fused == [B] * (2 * N * 3)
    assert int(port[3]) > 0 and int(port[4]) > 0


def test_heavy_hitters_dominate_the_exact_clicks(journal):
    """The reference's golden (``tests/test_sketch_engines.py:124``):
    after ``close()`` every click is in a closed session, and each
    reported estimate is at least that user's exact clicks."""
    wd, campaigns, mapping = journal
    r, eng, stats = run_side("port", wd, campaigns, mapping, PATHS["scan"])
    clicks = _clicks_by_user(wd)
    assert eng.session_clicks == sum(clicks.values())
    assert eng.sessions_closed >= len(clicks) > 0
    hh = dict(eng.heavy_hitters())
    assert len(hh) == 8 and len(hh_rows(r, eng)) == 8
    assert all(est >= clicks.get(u, 0) for u, est in hh.items())
    assert max(hh.values()) >= max(clicks.values())
    assert int(cms.sk_total(eng.cms)) == sum(clicks.values())


# ----------------------------------------------------------------------
# checkpoints
@pytest.mark.parametrize("family", ["fixed", "salsa", "twostage"])
def test_resume_equals_uninterrupted(journal, tmp_path, family):
    """Abandoned at 7,000 events (no ``close()``), resumed from the newest
    snapshot: every piece of state equals the uninterrupted run's, the
    ring too (the snapshot carries the candidate salt's sequence)."""
    wd, campaigns, mapping = journal
    kw = FAMILIES[family]
    _, base, _ = run_side("port", wd, campaigns, mapping, PATHS["scan"],
                          **kw)
    ckdir = str(tmp_path / "ck")
    r, a, _ = run_side("port", wd, campaigns, mapping, PATHS["scan"],
                       max_events=7_000, ckdir=ckdir, close=False, **kw)
    a.drain_writes()
    crashed_at = a.events_processed
    del a
    _, b, stats = run_side("port", wd, campaigns, mapping, PATHS["scan"],
                           ckdir=ckdir, resume=True, **kw)
    assert 0 < crashed_at < EVENTS
    assert stats.events == EVENTS - crashed_at
    assert_states_equal(state_of(base), state_of(b))


@pytest.mark.parametrize("family", ["fixed", "salsa"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_load_across_packages(journal, tmp_path, family,
                                        direction):
    """A snapshot one package wrote mid-journal finishes in the other;
    the sketch, counters and heavy hitters equal the second package's
    uninterrupted run's (the reference's own resume check)."""
    wd, campaigns, mapping = journal
    first, second = ("jax", "port") if direction == "jax_to_port" else (
        "port", "jax")
    kw = FAMILIES[family]
    ckdir = str(tmp_path / "ck")
    _, a, _ = run_side(first, wd, campaigns, mapping, PATHS["scan"],
                       max_events=8_000, ckdir=ckdir, close=False, **kw)
    a.drain_writes()
    _, b, _ = run_side(second, wd, campaigns, mapping, PATHS["scan"],
                       ckdir=ckdir, resume=True, **kw)
    _, base, _ = run_side(second, wd, campaigns, mapping, PATHS["scan"],
                          **kw)
    assert b.events_processed == base.events_processed == EVENTS
    want, got = state_of(base), state_of(b)
    assert_states_equal(want, got, ["sketch", "counters", "hist"])
    np.testing.assert_array_equal(got["session"][0], want["session"][0])
    assert dict(b.heavy_hitters()) == dict(base.heavy_hitters())


def test_snapshot_arrays_do_not_alias_the_live_state(journal):
    wd, campaigns, mapping = journal
    _, eng, _ = run_side("port", wd, campaigns, mapping, PATHS["scan"],
                         max_events=4_000, close=False)
    snap = eng.snapshot(offset=0)
    table = snap.extra["cms_table"].copy()
    hist = snap.extra["lat_hist"].copy()
    eng.close()
    np.testing.assert_array_equal(snap.extra["cms_table"], table)
    np.testing.assert_array_equal(snap.extra["lat_hist"], hist)
    assert not np.array_equal(eng.cms.table.numpy(), table)


def test_restore_refuses_mode_mismatch_and_other_families():
    cfg = default_config()
    sal = sketches.SessionCMSEngine(cfg, {"a": "c"}, campaigns=["c"],
                                    cms_mode="salsa", device="cpu")
    fixed = sketches.SessionCMSEngine(cfg, {"a": "c"}, campaigns=["c"],
                                      device="cpu")
    with pytest.raises(ValueError, match="cms_mode"):
        fixed.restore(sal.snapshot(offset=0))
    two = sketches.SessionCMSEngine(cfg, {"a": "c"}, campaigns=["c"],
                                    cms_stages=2, device="cpu")
    with pytest.raises(ValueError, match="cms_stages"):
        two.restore(fixed.snapshot(offset=0))
    hll = sketches.HLLDistinctEngine(cfg, {"a": "c"}, campaigns=["c"],
                                     device="cpu")
    with pytest.raises(ValueError, match="engine family"):
        fixed.restore(hll.snapshot(offset=0))
    with pytest.raises(ValueError, match="does not compose"):
        sketches.SessionCMSEngine(cfg, {"a": "c"}, campaigns=["c"],
                                  cms_mode="salsa", cms_stages=2,
                                  device="cpu")
    with pytest.raises(ValueError, match="cms_mode must be"):
        sketches.SessionCMSEngine(cfg, {"a": "c"}, campaigns=["c"],
                                  cms_mode="wide", device="cpu")


def _click_line(user, t):
    return json.dumps({
        "user_id": user, "page_id": "p", "ad_id": "ad", "ad_type": "banner",
        "event_type": "click", "event_time": str(t),
        "ip_address": "1.2.3.4"}).encode()


def test_legacy_snapshot_without_ring_reseeds_it_like_jax():
    """``tests/test_heavy_hitters_scale.py:98``: a snapshot from before
    the candidate ring (no ``hh_keys``) reseeds the ring from the restored
    intern universe, so a pre-crash heavy hitter still reports; the
    reseeded ring equals the JAX engine's."""
    rng = random.Random(5)
    t, lines = 1_700_000_000_000, []
    for i in range(4000):
        u = "star" if i < 1500 and rng.random() < 0.4 else \
            f"u{rng.randrange(2000)}"
        lines.append(_click_line(u, t))
        t += 50
    kw = dict(user_capacity=1 << 12, top_k=4)
    mapping = {"ad": "c"}
    a = sketches.SessionCMSEngine(default_config(jax_batch_size=512),
                                  mapping, device="cpu", **kw)
    ja = jax_sketches.SessionCMSEngine(
        jax_default_config(jax_batch_size=512), mapping, **kw)
    for off in range(0, len(lines), 512):
        a.fold_batches([a.encoder.encode(lines[off:off + 512], 512)])
        ja.process_lines(lines[off:off + 512])
    a.flush()
    ja.flush()
    snap, jsnap = a.snapshot(offset=0), ja.snapshot(offset=0)
    for s in (snap, jsnap):
        del s.extra["hh_keys"], s.extra["hh_ests"]
    b = sketches.SessionCMSEngine(default_config(jax_batch_size=512),
                                  mapping, device="cpu", **kw)
    b.restore(snap)
    jb = jax_sketches.SessionCMSEngine(
        jax_default_config(jax_batch_size=512), mapping, **kw)
    jb.restore(jsnap)
    assert "star" in dict(b.heavy_hitters())
    assert_states_equal(state_of(jb), state_of(b), ["ring", "sketch"])


def test_latency_quantile_reads_the_histogram():
    eng = sketches.SessionCMSEngine(default_config(), {"a": "c"},
                                    device="cpu")
    assert eng.latency_quantile((0.5, 0.99)) == ([], 0)
    hist = np.zeros(sketches.LAT_BINS, np.int32)
    hist[0], hist[3] = 50, 50
    eng.lat_hist = torch.from_numpy(hist)
    jeng = jax_sketches.SessionCMSEngine(jax_default_config(), {"a": "c"})
    jeng.lat_hist = jax_sketches.jnp.asarray(hist)
    assert eng.latency_quantile((0.25, 0.5, 0.75, 1.0)) == \
        jeng.latency_quantile((0.25, 0.5, 0.75, 1.0))
    vals, n = eng.latency_quantile((0.5,))
    assert n == 100 and 0 <= vals[0] <= 250


def test_session_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sketches.SessionCMSEngine(default_config(), {"ad": "camp"})
    eng = sketches.SessionCMSEngine(default_config(), {"ad": "camp"},
                                    device="cpu")
    assert eng.device.type == "cpu" and eng.NEEDS_INTERNED_IDS
    assert eng._span_guard == 2**31 - 1 and eng._pack_ok is False
    assert eng._devdecode is None


def test_config_keys_reach_the_engine(tmp_path):
    from streambench_tpu_torch.config import find_and_read_config_file

    for lines, mode, stages, bits, plane in (
            ("jax.cms.mode: salsa\njax.cms.cell.bits: 16\n", "salsa", 1,
             16, salsa.SalsaState),
            ("jax.cms.stages: 2\n", "fixed", 2, 8, cms.CMS2State),
            ("", "fixed", 1, 8, cms.CMSState)):
        conf = tmp_path / "c.yaml"
        conf.write_text('redis.host: ":inprocess:"\n' + lines)
        eng = sketches.SessionCMSEngine(find_and_read_config_file(str(conf)),
                                        {"a": "c"}, device="cpu")
        assert (eng.cms_mode, eng.cms_stages, eng.cms_cell_bits) == (
            mode, stages, bits)
        assert isinstance(eng.cms, plane)
    assert int(eng.cms.table.shape[1]) == 2048


def test_sketch_summary_reaches_the_sampler(journal):
    wd, campaigns, mapping = journal
    _, eng, _ = run_side("port", wd, campaigns, mapping, PATHS["scan"],
                         max_events=4_000, cms_mode="salsa")
    s = eng.sketch_summary(merges=True)
    assert s["mode"] == "salsa" and s["stages"] == 1
    assert s["state_bytes"] == 4 * 256 + 4 * 16 + 4 * 8 + 4
    assert s["cells"] == 1024 and s["total"] == eng.session_clicks
    rec: dict = {}
    engine_collector(eng)(rec, 1.0)
    assert rec["sketch"] == eng.sketch_summary()
    fixed = make("port", {}, None, campaigns, mapping)
    assert fixed.sketch_summary()["state_bytes"] == 4 * 4 * 256 + 4


# ----------------------------------------------------------------------
# the CLI, the harness, the method table
def _cli(module, wd, extra=()):
    conf = os.path.join(wd, "conf.yaml")
    with open(conf, "w") as f:
        f.write(f'redis.host: ":inprocess:"\nkafka.topic: "{TOPIC}"\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", module, "--confPath", conf, "--workdir", wd,
         "--catchup", "--engine", "session", *extra],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip().splitlines()


def test_cli_engine_session_on_cpu_matches_the_jax_cli(tmp_path):
    wd = str(tmp_path)
    write_session_journal(wd, 5_000)
    port = _cli("streambench_tpu_torch.engine", wd, ["--device", "cpu"])
    jax = _cli("streambench_tpu.engine", wd)
    assert any("engine up:" in ln and "engine=session" in ln
               and "device=cpu" in ln for ln in port)
    got, want = json.loads(port[-1]), json.loads(jax[-1])
    assert got["events"] == want["events"] == 5_000
    assert got["dropped"] == want["dropped"] == 0
    assert got["windows_written"] == want["windows_written"] == 0
    assert got["kernel_launches"] == {"count_cells": 0, "decode_rows": 0,
                                      "cms_rows": 0}   # CPU: no kernel


def test_harness_torch_test_with_engine_session_on_cpu(tmp_path):
    """``TORCH_TEST`` with ``ENGINE=session``: the engine writes no window
    rows, so the composite's evidence is its final stats line's events,
    as in the reference harness."""
    wd = str(tmp_path / "run")
    env = {"WORKDIR": wd, "REDIS_PORT": str(free_port()), "LOAD": "400",
           "TEST_TIME": "6", "STOP_STATS_GRACE": "2", "TOPIC": "ad-events",
           "DEVICE": "cpu", "ENGINE": "session"}
    try:
        proc = run_harness(["TORCH_TEST"], env, timeout=240)
    finally:
        run_harness(["STOP_ALL"], env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout + proc.stderr
    assert "TORCH_TEST evidence:" in out and '"events"' in out
    engine_log = open(os.path.join(wd, "logs", "engine.log")).read()
    assert "engine=session" in engine_log and "device=cpu" in engine_log
    stats = json.loads(engine_log.strip().splitlines()[-1])
    load_log = open(os.path.join(wd, "logs", "load.log")).read()
    emitted = int(load_log.split("emitted ")[-1].split()[0])
    assert stats["events"] == emitted > 0 and stats["dropped"] == 0


def test_sigterm_folds_what_the_topic_holds(tmp_path):
    """The cause of the unsteady composite above, made deterministic: an
    engine that has fallen behind its producer (held here with SIGSTOP
    while 20,000 events land) and then gets the harness's SIGTERM folds
    the whole backlog before its final stats line, instead of stopping
    at the events it had read."""
    import signal
    import time

    wd = str(tmp_path)
    rng = random.Random(7)
    campaigns = make_ids(10, rng)
    ads = make_ids(100, rng)
    gen.write_ids(campaigns, ads, wd)
    gen.write_ad_mapping_file(campaigns, ads, wd)
    src = gen.EventSource(ads=ads, user_ids=make_ids(300, rng),
                          page_ids=make_ids(10, rng), rng=rng)
    lines = [(src.event_at(1_700_000_000_000 + 2 * i) + "\n").encode()
             for i in range(22_000)]
    broker = FileBroker(os.path.join(wd, "broker"))
    with broker.writer(TOPIC, append=False) as w:
        w.append_bytes(b"".join(lines[:2_000]))
    conf = os.path.join(wd, "conf.yaml")
    with open(conf, "w") as f:
        f.write(f'redis.host: ":inprocess:"\nkafka.topic: "{TOPIC}"\n')
    proc = subprocess.Popen(
        [sys.executable, "-m", "streambench_tpu_torch.engine", "--confPath",
         conf, "--workdir", wd, "--engine", "session", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    try:
        deadline = time.monotonic() + 120
        for line in proc.stdout:
            if line.startswith("engine up:"):
                break
            assert time.monotonic() < deadline
        time.sleep(1.0)                    # the first 2,000 fold
        proc.send_signal(signal.SIGSTOP)   # the engine falls behind
        with broker.writer(TOPIC, append=True) as w:
            w.append_bytes(b"".join(lines[2_000:]))
        proc.send_signal(signal.SIGTERM)   # handled first thing on resume
        proc.send_signal(signal.SIGCONT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["events"] == 22_000 and stats["dropped"] == 0


def test_harness_refuses_verify_with_engine_session(tmp_path):
    env = {"WORKDIR": str(tmp_path / "run"), "ENGINE": "session",
           "VERIFY": "1", "DEVICE": "cpu"}
    proc = run_harness(["SETUP"], env)
    assert proc.returncode != 0
    assert "ENGINE=session" in proc.stdout + proc.stderr


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "method_bench.json"
    monkeypatch.setenv("STREAMBENCH_TORCH_METHOD_CACHE", str(path))
    return path


def test_measure_cms_checks_every_arm_on_cpu(cache):
    res = methodbench.measure_cms(width=256, batch_size=512, iters=2,
                                  device="cpu")
    assert set(res["methods"]) == set(methodbench.CMS_METHODS)
    assert all("ns_per_event" in v for v in res["methods"].values()), res
    assert res["winner"] in methodbench.CMS_METHODS
    assert (res["depth"], res["width"]) == (4, 256)


def test_cms_auto_reads_the_ports_winner(cache):
    assert methodbench.cms_key("cuda", 2048) == "cuda/cms/W2048"
    assert methodbench.cms_winner("cpu", 2048) is None
    assert sketches._cms_auto("cpu", 2048) == "fixed"
    methodbench.record("cpu/cms/W2048", {"winner": "salsa"})
    assert sketches._cms_auto("cpu", 2048) == "salsa"
    assert sketches._cms_auto("cpu", 1024) == "fixed"
    assert sketches._cms_auto("cuda", 2048) == "fixed"
    eng = sketches.SessionCMSEngine(default_config(), {"a": "c"},
                                    cms_mode="auto", device="cpu")
    assert eng.cms_mode == "salsa"
    methodbench.record("cpu/cms/W2048", {"winner": "flat"})
    eng = sketches.SessionCMSEngine(default_config(), {"a": "c"},
                                    cms_mode="auto", device="cpu")
    assert eng.cms_mode == "fixed"


def test_cli_family_cms_smoke_records_the_winner(cache):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.ops.methodbench",
         "--family", "cms", "--smoke", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout)
    assert set(res) == {"cms"} and res["cms"]["width"] == 256
    data = json.loads(cache.read_text())
    assert data["cpu/cms/W256"]["winner"] == res["cms"]["winner"]


def test_device_decode_on_keeps_the_host_encode(capsys):
    cfg = dataclasses.replace(default_config(), jax_decode_device="on")
    eng = sketches.SessionCMSEngine(cfg, {"a" * 36: "c1"}, device="cpu")
    assert eng._devdecode is None
    assert "host encode" in capsys.readouterr().err


# ----------------------------------------------------------------------
# chip_smoke.py phase 16, rehearsed on the CPU at a small size
def test_chip_smoke_phase16_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 16 through the smoke's own code (the journal and its truth,
    the four runs and their checks, the time expiry of every session of
    the body, the CPU comparisons, the resume, the profile) on the CPU at
    60,000 events of 6,000 users and the 20,000-event tail on a 64-cell
    sketch; the card runs it at 3,000,000 events of 400,000 users, Wd =
    2048."""
    import chip_smoke

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        return str(path)

    monkeypatch.setattr(chip_smoke, "_workdir", workdir)
    out = chip_smoke.phase_session(60_000, 6_000, device="cpu",
                                   two_stage_events=20_000, cms_width=64)
    assert out["user_capacity"] == 1 << 16
    assert out["events"] == 60_000 + chip_smoke.SESSION_TAIL_EVENTS
    for run in ("fixed", "salsa", "two_stage", "resume"):
        res = out[run]
        assert res["dropped"] == 0 and res["sessions_closed"] > 0
    assert out["fixed"]["session_clicks"] == out["fixed"]["journal_clicks"]
    assert out["fixed"]["hh_rows"] == 16
    assert out["fixed"]["cpu_equal_arrays"] == 11
    # one drain, where the catchup ends, expired every user of the body
    fixed = out["fixed"]
    assert 5_900 < fixed["expired"] == fixed["expired_want"] <= 6_000
    assert fixed["expired_bins_equal"] and fixed["drains_closing"] == 1
    assert fixed["cpu_expired"] == fixed["expired"]
    assert out["salsa"]["expired"] == fixed["expired"]
    assert (out["resume"]["expired_before_crash"]
            + out["resume"]["expired"]) == fixed["expired"]
    assert out["salsa"]["salsa"]["merged_pairs"] > 0
    assert out["salsa"]["cpu_equal_arrays"] == 13
    assert out["two_stage"]["small_min_margin"] >= 0
    assert out["two_stage"]["cpu_equal_arrays"] == 12
    assert out["resume"]["equal_arrays"] == 11
    assert 0 < out["resume"]["crashed_at_events"] < out["events"]
    assert out["profile"]["batches"] == -(-out["events"] // 8192)
