"""Query-path latency attribution in the port (``streambench_tpu_torch/
obs/queryattr.py`` and its wiring into ``reach/serve.py``, the engine
CLI's ``jax.obs.query`` and ``obs serve``), on the CPU.

``QueryLifecycle`` is host code: driven through the same seeded sequence
of admissions, queue exits, replies, sheds and ingest-busy windows under
one injected clock, the port's and the JAX package's give JSON
byte-identical summaries, server blocks and segment quantiles.
``summarize_serve`` / ``render_serve`` / ``render_serve_diff`` are pure
and equal on seeded records.  The server cases are the reference's
``tests/test_queryattr.py`` on the port's server: segments partition the
e2e, shed records reconcile with ``streambench_reach_shed_total``, the
slow log is bounded, the contention ratio reads measured busy windows,
replies are byte-identical with the layer off, and the reach objective's
breach event names the segments."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from streambench_tpu.obs import MetricsRegistry as JaxRegistry
from streambench_tpu.obs import queryattr as jax_qa
from streambench_tpu.obs import report as jax_report
from streambench_tpu_torch.obs import MetricsRegistry, SpanTracer
from streambench_tpu_torch.obs import queryattr as qa
from streambench_tpu_torch.obs import report
from streambench_tpu_torch.obs.queryattr import (
    SEGMENTS,
    QueryLifecycle,
    _interval_overlap_ns,
)
from streambench_tpu_torch.obs.slo import SloTracker
from streambench_tpu_torch.ops import minhash
from streambench_tpu_torch.reach.serve import ReachQueryServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    """``perf_counter_ns`` / ``monotonic`` from one scripted counter."""

    def __init__(self):
        self.ns = 10_000_000_000

    def perf_counter_ns(self):
        return self.ns

    def monotonic(self):
        return self.ns / 1e9

    def advance(self, ns):
        self.ns += int(ns)


def _drive(mod, registry, clock, seed):
    """One seeded lifecycle script through ``mod.QueryLifecycle``; returns
    every observable output as one JSON string."""
    rng = np.random.default_rng(seed)
    ql = mod.QueryLifecycle(registry, slo_ms=int(rng.integers(0, 40)),
                            slowlog_max=int(rng.integers(1, 6)),
                            sample_every=int(rng.integers(1, 4)))
    out = {"blocks": [], "shed_ms": []}
    pending = []
    for step in range(int(rng.integers(20, 60))):
        clock.advance(rng.integers(0, 5_000_000))
        r = rng.random()
        if r < 0.45:
            pending.append(ql.admit(trace=(f"t{step}" if rng.random() < 0.3
                                           else None),
                                    qid=step, client_ms=step * 10))
        elif r < 0.55 and pending:
            out["shed_ms"].append(round(ql.note_shed(pending.pop(0)), 6))
        elif r < 0.65:
            s = clock.ns - int(rng.integers(0, 20_000_000))
            ql.note_ingest_busy(s, s + int(rng.integers(-1_000, 9_000_000)))
        elif r < 0.7:
            if ql.device_sample_due(step):
                ql.note_device_sample(float(rng.uniform(0.01, 5.0)))
        elif pending:
            batch = pending[:int(rng.integers(1, 5))]
            del pending[:len(batch)]
            for rec in batch:
                rec.t_exit = clock.ns
            ql.note_queue_exit(batch)
            clock.advance(rng.integers(0, 300_000))
            t_submit = clock.ns
            clock.advance(rng.integers(0, 8_000_000))
            t_done = clock.ns
            for rec in batch:
                clock.advance(rng.integers(0, 200_000))
                out["blocks"].append(ql.server_block(rec, t_submit, t_done))
                ql.note_reply(rec, t_submit, t_done)
    out["summary"] = ql.summary()
    out["quantiles"] = ql.segment_quantiles()
    out["ratio"] = ql.contention_ratio()
    out["slowlog"] = ql.slowlog()
    return json.dumps(out, sort_keys=True)


@pytest.mark.parametrize("seed", range(6))
def test_lifecycle_equals_the_jax_package_under_one_injected_clock(
        monkeypatch, seed):
    outs = []
    for mod, reg in ((qa, MetricsRegistry()), (jax_qa, JaxRegistry())):
        clock = FakeClock()
        monkeypatch.setattr(mod, "time", clock)
        monkeypatch.setattr(mod, "now_ms", lambda: 1_700_000_000_000)
        outs.append(_drive(mod, reg, clock, seed))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("seed", range(4))
def test_interval_overlap_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    raw = sorted(rng.integers(0, 10_000, (20, 2)).tolist())
    merged = []
    for s, e in raw:
        s, e = min(s, e), max(s, e)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for lo, hi in rng.integers(0, 12_000, (30, 2)).tolist():
        assert _interval_overlap_ns(lo, hi, merged) == \
            jax_qa._interval_overlap_ns(lo, hi, merged)


def _serve_records(seed: int) -> list:
    """Seeded ``reach_query`` journal records (the sampler's shape)."""
    rng = np.random.default_rng(seed)

    def summ():
        c = int(rng.integers(0, 500))
        p = sorted(float(round(x, 3)) for x in rng.uniform(0, 50, 3))
        return {"count": c, "sum": round(float(rng.uniform(0, 1e4)), 3),
                "p50": p[0], "p95": p[1], "p99": p[2]}

    recs = []
    for i in range(int(rng.integers(1, 4))):
        rq = {"served": int(rng.integers(0, 1000)),
              "shed": int(rng.integers(0, 50)),
              "rejected": int(rng.integers(0, 3)),
              "dispatches": int(rng.integers(0, 100)),
              "queue_high_water": int(rng.integers(0, 64)),
              "queue_depth": 64, "plane_epoch": int(rng.integers(0, 5)),
              "staleness_ms": float(round(rng.uniform(0, 900), 1)),
              "max_staleness_ms": 10_000,
              "shed_stale": int(rng.integers(0, 3)),
              "cache": {"hit_ratio": float(round(rng.random(), 4)),
                        "hits": 3, "misses": 4, "entries": 5,
                        "capacity": 64, "evictions": 0,
                        "invalidations": 1},
              "freshness": {"hops": {h: summ() for h in (
                  "fold_lag", "ship_wait", "tail_lag", "serve", "total")},
                  "high_water_ms": 12.5},
              "query_obs": {
                  "served_records": 10, "shed_records": 2,
                  "segments": {s: summ() for s in SEGMENTS},
                  "e2e_ms": summ(), "shed_queue_ms": summ(),
                  "contention": {"queue_wait_ms": 5.0,
                                 "ingest_overlap_ms": 1.25,
                                 "ratio": 0.25, "busy_intervals": 3},
                  "slow_queries": 2, "slo_ms": 20, "slowlog_evicted": 1,
                  "slowlog": [{"id": 1, "e2e_ms": 30.0, "queue_ms": 10.0,
                               "batch_ms": 1.0, "dispatch_ms": 18.0,
                               "reply_ms": 1.0}]}}
        if rng.random() < 0.3:
            rq.pop("query_obs")
        recs.append({"kind": "snapshot", "seq": i, "reach_query": rq})
    return recs


@pytest.mark.parametrize("seed", range(3))
def test_serve_report_equals_the_jax_package(seed):
    a, b = _serve_records(seed), _serve_records(seed + 10)
    sa, sb = (report.summarize_serve(a, path="A"),
              report.summarize_serve(b, path="B"))
    assert json.dumps(sa, sort_keys=True) == json.dumps(
        jax_report.summarize_serve(a, path="A"), sort_keys=True)
    assert report.render_serve(sa) == jax_report.render_serve(sa)
    assert report.render_serve_diff(sa, sb) == \
        jax_report.render_serve_diff(sa, sb)
    empty = report.summarize_serve([], path="")
    assert report.render_serve(empty) == jax_report.render_serve(empty)


# ------------------------------------------------------ server wiring
def tiny_state(C=4, k=16, R=16, seed=0):
    rng = np.random.default_rng(seed)
    st = minhash.init_state(C, k, R)
    B = 64
    return minhash.step(
        st, torch.arange(C, dtype=torch.int32),
        torch.from_numpy(rng.integers(0, C, B).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 1 << 20, B).astype(np.int32)),
        torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32),
        torch.ones(B, dtype=torch.bool))


def make_server(campaigns=("a", "b", "c", "d"), *, depth=64, batch=8,
                hold=False, slo_ms=0, slowlog_max=16, spans=None,
                flightrec=None, registry=None, queryattr=True):
    reg = registry if registry is not None else MetricsRegistry()
    ql = (QueryLifecycle(reg, slo_ms=slo_ms, slowlog_max=slowlog_max,
                         spans=spans) if queryattr else None)
    srv = ReachQueryServer(list(campaigns), depth=depth, batch=batch,
                           hold=hold, registry=reg, queryattr=ql,
                           spans=spans, flightrec=flightrec)
    st = tiny_state(C=len(campaigns))
    srv.update_state(st.mins, st.registers, epoch=1)
    return srv, ql, reg


def drain(got, n, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while len(got) < n and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(got) >= n, (len(got), n)


def test_segments_sum_to_e2e_exactly():
    srv, ql, _ = make_server()
    got = []
    try:
        for i in range(40):
            srv.submit(["a", "b"], "overlap" if i % 2 else "union",
                       lambda d: got.append(d), query_id=i)
        drain(got, 40)
    finally:
        srv.close()
    s = ql.summary()
    assert s["served_records"] == 40 and s["shed_records"] == 0
    seg_sum = sum(s["segments"][seg]["sum"] for seg in SEGMENTS)
    assert s["e2e_ms"]["count"] == 40
    assert seg_sum == pytest.approx(s["e2e_ms"]["sum"], abs=3e-3)
    assert all(s["segments"][seg]["count"] == 40 for seg in SEGMENTS)
    # every answer carries the server-side split
    assert all({"queue_ms", "batch_ms", "dispatch_ms", "total_ms"}
               <= set(d["server"]) for d in got)


def test_shed_records_reconcile_with_shed_counter():
    srv, ql, reg = make_server(depth=5, batch=4, hold=True)
    got = []
    try:
        for i in range(17):
            srv.submit(["a"], "union", lambda d: got.append(d),
                       query_id=i)
        assert srv.shed == 12
        srv.resume()
        drain(got, 17)
    finally:
        srv.close()
    s = ql.summary()
    assert s["shed_records"] == 12 == srv.shed
    assert s["served_records"] == 5 == srv.served
    assert s["shed_queue_ms"]["count"] == 12
    assert reg.counter("streambench_reach_shed_total").value == 12
    shed_replies = [d for d in got if d.get("shed")]
    assert len(shed_replies) == 12
    assert all("queue_ms" in d["server"] for d in shed_replies)


def test_slowlog_is_bounded_and_counts_evictions():
    srv, ql, _ = make_server(slo_ms=0, slowlog_max=3)
    ql.slo_ms = 1e-9      # every query is "slow"
    got = []
    try:
        for i in range(10):
            srv.submit(["c"], "union", lambda d: got.append(d),
                       query_id=i)
        drain(got, 10)
    finally:
        srv.close()
    s = ql.summary()
    assert len(s["slowlog"]) == 3 and s["slow_queries"] == 3
    assert s["slowlog_evicted"] == 7
    assert {e["id"] for e in s["slowlog"]} <= set(range(10))


def test_contention_ratio_reads_measured_busy_windows():
    """A busy window fed through ``note_ingest_busy`` that covers the
    whole queue wait puts the ratio at 1; with no evidence it stays 0."""
    srv, ql, _ = make_server(hold=True)
    got = []
    try:
        t0 = time.perf_counter_ns()
        for i in range(6):
            srv.submit(["a"], "union", lambda d: got.append(d),
                       query_id=i)
        time.sleep(0.02)
        ql.note_ingest_busy(t0 - 1_000_000, time.perf_counter_ns()
                            + 10_000_000_000)
        srv.resume()
        drain(got, 6)
    finally:
        srv.close()
    c = ql.summary()["contention"]
    assert c["busy_intervals"] == 1 and c["queue_wait_ms"] > 0
    assert c["ratio"] == pytest.approx(1.0, abs=1e-3)
    srv2, ql2, _ = make_server()
    got2 = []
    try:
        srv2.submit(["a"], "union", lambda d: got2.append(d), query_id=0)
        drain(got2, 1)
    finally:
        srv2.close()
    assert ql2.contention_ratio() == 0.0


def test_contention_from_ingest_spans_in_the_ring():
    spans = SpanTracer(capacity=256)
    srv, ql, _ = make_server(hold=True, spans=spans)
    got = []
    try:
        t0 = time.perf_counter_ns()
        for i in range(4):
            srv.submit(["b"], "union", lambda d: got.append(d),
                       query_id=i)
        time.sleep(0.02)
        spans.add("device_step", t0 - 1_000,
                  time.perf_counter_ns() - t0 + 10_000_000_000,
                  cat="stage")
        srv.resume()
        drain(got, 4)
    finally:
        srv.close()
    c = ql.summary()["contention"]
    assert c["spans_wired"] is True and c["ratio"] > 0.9


def test_replies_byte_identical_with_the_layer_off():
    on, _, _ = make_server()
    off, _, _ = make_server(queryattr=False)
    got_on, got_off = [], []
    try:
        for srv, got in ((on, got_on), (off, got_off)):
            for i in range(4):
                srv.submit(["a", "c"], "union", lambda d, g=got: g.append(d),
                           query_id=i)
            drain(got, 4)
    finally:
        on.close()
        off.close()
    for a, b in zip(sorted(got_on, key=lambda d: d["id"]),
                    sorted(got_off, key=lambda d: d["id"])):
        assert "server" in a and "server" not in b
        a = dict(a)
        a.pop("server")
        assert json.dumps(a, sort_keys=True) == json.dumps(b,
                                                           sort_keys=True)


def test_reach_slo_breach_event_names_the_segments():
    """The reach objective's breach event and verdict carry the
    per-segment attribution and the contention ratio."""
    reg = MetricsRegistry()
    events = []
    clock = {"t": 0.0}
    ql = QueryLifecycle(reg, slo_ms=1)
    slo = SloTracker(reg, reach_p99_ms=1, fast_s=1.0, slow_s=2.0,
                     annotate=lambda ev, **kw: events.append((ev, kw)),
                     queryattr=ql, clock=lambda: clock["t"])
    srv = ReachQueryServer(["a", "b"], registry=reg, queryattr=ql)
    st = tiny_state(C=2)
    srv.update_state(st.mins, st.registers, epoch=1)
    slo.collect({}, 1.0)
    got = []
    try:
        for i in range(20):
            srv.submit(["a"], "union", lambda d: got.append(d), query_id=i)
            time.sleep(0.002)
        drain(got, 20)
    finally:
        srv.close()
    # every served query took well over 1 ms (the slowest bucket edge),
    # so the burn reads far past the breach gate on both windows
    reg.histogram("streambench_reach_latency_ms").observe(50.0)
    for _ in range(3):
        clock["t"] += 1.0
        slo.collect({}, 1.0)
    breaches = [kw for ev, kw in events if ev == "slo_breach"]
    assert breaches, events
    assert set(breaches[0]["reach_segments"]) <= set(SEGMENTS)
    assert "reach_contention_ratio" in breaches[0]
    v = slo.verdict()
    assert "reach_segments" in v and "reach_contention_ratio" in v


# ------------------------------------------------ the CLI and obs serve
def _journal(tmp_path, n=3_000, C=4):
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.io.journal import FileBroker

    import random
    from streambench_tpu_torch.utils.ids import make_ids

    rng = random.Random(5)
    campaigns = make_ids(C, rng)
    ads = make_ids(C * 10, rng)
    gen.write_ids(campaigns, ads, str(tmp_path))
    gen.write_ad_mapping_file(campaigns, ads, str(tmp_path))
    src = gen.EventSource(ads=ads, user_ids=make_ids(300, rng),
                          page_ids=make_ids(10, rng), rng=rng)
    broker = FileBroker(str(tmp_path / "broker"))
    with broker.writer("ad-events") as w:
        for t in range(n):
            w.append_bytes(src.event_at(1_700_000_000_000 + 5 * t).encode()
                           + b"\n")
    return campaigns


def test_cli_reach_with_query_obs_and_fleet_then_obs_serve(tmp_path):
    """``--engine reach`` with ``jax.obs.query`` and ``jax.obs.fleet`` on
    the CPU: the journal is role-stamped ``writer``, its records carry
    the segment decomposition, and ``obs serve`` renders it."""
    _journal(tmp_path)
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\nkafka.topic: "ad-events"\n'
                    "jax.metrics.interval.ms: 200\njax.obs.query: true\n"
                    "jax.obs.fleet: true\njax.obs.spans: true\n"
                    "jax.reach.slo.p99.ms: 5000\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.engine",
         "--confPath", str(conf), "--workdir", str(tmp_path), "--catchup",
         "--engine", "reach", "--device", "cpu"],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert any(ln.startswith("reach: pubsub=") and "query_obs=on" in ln
               for ln in proc.stdout.splitlines())
    recs = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert recs and all(r.get("role") == "writer" for r in recs)
    assert any("query_obs" in (r.get("reach_query") or {}) for r in recs)
    out = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.obs", "serve",
         str(tmp_path / "metrics.jsonl")],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "reach serving attribution" in out.stdout
    assert "segment" in out.stdout and "contention ratio" in out.stdout
