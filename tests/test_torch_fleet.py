"""Fleet observability in the port (``streambench_tpu_torch/obs/fleet.py``,
the freshness ledger of ``reach/serve.py``, the replica's ``--fleet``
mode, the role-stamped sampler, ``obs fleet`` and ``obs trace --merge``),
on the CPU.

The read side is pure: ``freshness_hops``, ``FleetCollector`` +
``summarize_fleet`` + ``render_fleet``, ``discover_roles`` and
``merge_traces`` give JSON byte-identical outputs to the JAX package's
on the same seeded journals and traces, and the ``obs fleet`` CLI prints
what the JAX CLI prints.  The live cases are the reference's
``tests/test_fleet.py`` on the port: a fleet replica's hops sum to every
reply's staleness, cache hits carry the plane's reply-time freshness,
fleet-off replies keep their shape, the writer-attached stamps, and a
writer CLI run beside a ``--fleet`` replica process whose journals and
traces ``obs fleet`` and ``obs trace --merge`` read."""

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from streambench_tpu.obs import fleet as jax_fleet
from streambench_tpu.reach import serve as jax_serve
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.dimensions.pubsub import (
    PubSubClient,
    PubSubServer,
)
from streambench_tpu_torch.dimensions.store import DurableDimensionStore
from streambench_tpu_torch.obs import fleet
from streambench_tpu_torch.obs.fleet import (
    FleetCollector,
    merge_traces,
    parse_role_spec,
    render_fleet,
    summarize_fleet,
    trace_process_names,
)
from streambench_tpu_torch.obs.spans import validate_chrome_trace
from streambench_tpu_torch.ops import minhash
from streambench_tpu_torch.reach.replica import ReachReplica, SnapshotShipper
from streambench_tpu_torch.reach.serve import (
    FRESHNESS_HOPS,
    ReachQueryServer,
    freshness_hops,
)
from streambench_tpu_torch.utils.ids import make_ids, now_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["c0", "c1", "c2"]


def fold_state(users, C=3, k=16, R=16):
    st = minhash.init_state(C, k, R)
    B = len(users)
    return minhash.step(
        st, torch.arange(C, dtype=torch.int32),
        torch.zeros(B, dtype=torch.int32),
        torch.tensor(users, dtype=torch.int32),
        torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32),
        torch.ones(B, dtype=torch.bool))


def ask(host, port, campaigns, qid, op="union"):
    c = PubSubClient(host, port, timeout_s=20)
    c.request({"type": "reach", "campaigns": campaigns, "op": op,
               "id": qid})
    out = c.recv()["data"]
    c.close()
    return out


def _dump(x) -> str:
    return json.dumps(x, sort_keys=True)


# ------------------------------------------------- freshness partition
@pytest.mark.parametrize("seed", range(4))
def test_freshness_hops_equal_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        base = float(rng.uniform(1e12, 2e12))
        fresh = {k: (base - float(rng.uniform(-50, 2_000))
                     if rng.random() > 0.15 else None)
                 for k in ("folded_ms", "submit_ms", "shipped_ms",
                           "loaded_ms")}
        hops = freshness_hops(fresh, reply_ms=base)
        assert _dump(hops) == _dump(jax_serve.freshness_hops(
            fresh, reply_ms=base))
        assert all(hops[h] >= 0 for h in FRESHNESS_HOPS)
        assert sum(hops[h] for h in FRESHNESS_HOPS) == pytest.approx(
            hops["total"])


def test_writer_to_replica_freshness_partition(tmp_path):
    """A writer ships stamped records (origin: a live pub/sub endpoint
    for the clock ping), a fleet replica loads them, and every served
    reply, misses and cache hits, carries hops that sum to its
    staleness within rounding."""
    origin_ps = PubSubServer(port=0).start()
    o_host, o_port = origin_ps.address
    store = DurableDimensionStore(str(tmp_path))
    ship = SnapshotShipper(store, NAMES, interval_ms=1,
                           origin={"addr": f"{o_host}:{o_port}",
                                   "pid": os.getpid(), "role": "writer"})
    st = fold_state([10, 20, 30])
    folded_at = now_ms()
    ship.note_state(minhash.mins_numpy(st.mins), st.registers.numpy(), 2,
                    70_000, folded_ms=folded_at)
    rep = ReachReplica(store.path, poll_ms=20_000, fleet=True,
                       device="cpu")
    rep.pubsub.start()
    try:
        assert rep.poll_once()
        assert rep.clock is not None and "error" not in rep.clock
        applied = rep.clock["applied"]
        if applied:
            assert abs(rep.clock["offset_ms"]) <= 50.0
        host, port = rep.address
        replies = [ask(host, port, ["c0", "c1"], i) for i in range(4)]
        for i, d in enumerate(replies):
            assert "estimate" in d, d
            fr = d["freshness"]
            hop_sum = sum(fr[f"{h}_ms"] for h in FRESHNESS_HOPS)
            assert hop_sum == pytest.approx(fr["staleness_ms"], abs=0.25)
            assert d["staleness_ms"] == fr["staleness_ms"]
            assert fr["clock"]["applied"] is applied
            if i > 0:
                assert d.get("cached") is True
                assert fr["staleness_ms"] >= \
                    replies[0]["freshness"]["staleness_ms"]
        t_before = now_ms()
        d_last = ask(host, port, ["c0", "c2"], "anchor")
        off = abs(rep.clock["offset_ms"]) if applied else 0.0
        assert d_last["freshness"]["staleness_ms"] >= \
            (t_before - folded_at) - off - 1
        served = len(replies) + 1
        fr_sum = rep.server.summary()["freshness"]
        assert fr_sum["hops"]["total"]["count"] == served
        for hop in FRESHNESS_HOPS:
            assert fr_sum["hops"][hop]["count"] == served
        s = rep.summary()
        assert s["fleet"] is True and s["clock"] == rep.clock
    finally:
        rep.close()
        store.close()
        origin_ps.close()
    # the closed replica let go of its planes
    assert rep.server._state is None


def test_off_flag_replies_keep_their_shape(tmp_path):
    store = DurableDimensionStore(str(tmp_path))
    ship = SnapshotShipper(store, NAMES, interval_ms=1,
                           origin={"addr": "127.0.0.1:1", "pid": 1})
    st = fold_state([1, 2, 3])
    ship.note_state(minhash.mins_numpy(st.mins), st.registers.numpy(), 0,
                    1, folded_ms=now_ms() - 60_000)
    rep = ReachReplica(store.path, poll_ms=20_000, device="cpu")
    rep.pubsub.start()
    try:
        assert rep.poll_once()
        d = ask(*rep.address, ["c0"], 1)
        assert set(d) == {"op", "estimate", "union", "jaccard", "bound",
                          "epoch", "plane_epoch", "id", "staleness_ms"}
        assert d["staleness_ms"] < 30_000      # ship-anchored, not fold
        assert rep.clock is None
    finally:
        rep.close()
        store.close()


def test_freshness_high_water_flightrec():
    from streambench_tpu_torch.obs import FlightRecorder, MetricsRegistry

    fr = FlightRecorder(".")
    srv = ReachQueryServer(NAMES, registry=MetricsRegistry(), flightrec=fr,
                           max_staleness_ms=60_000)
    st = fold_state([5, 6])
    base = now_ms()
    srv.update_state(st.mins, st.registers, 0, shipped_ms=base,
                     freshness={"folded_ms": base - 20_000,
                                "submit_ms": base - 19_000,
                                "shipped_ms": base - 18_000,
                                "loaded_ms": base - 100})
    got = []
    srv.submit(["c0"], "union", lambda d: got.append(d))
    deadline = time.monotonic() + 10
    while not got and time.monotonic() < deadline:
        time.sleep(0.01)
    srv.close()
    assert got and "freshness" in got[0]
    recs = [r for r in fr.snapshot()
            if r["kind"] == "fleet_freshness_high_water"]
    assert recs and recs[-1]["staleness_ms"] >= 20_000 - 100
    assert all(f"{h}_ms" in recs[-1] for h in FRESHNESS_HOPS)
    assert srv.freshness_high_water >= 20_000 - 100
    assert "freshness" in srv.summary()


def test_writer_attached_fleet_stamps():
    """``jax.obs.fleet`` on the writer: the attached server's replies
    carry the degenerate decomposition (fold_lag + serve only)."""
    from streambench_tpu_torch.engine.sketches import ReachSketchEngine

    mapping = {f"ad{i}": NAMES[i % 3] for i in range(9)}
    cfg = default_config(jax_num_campaigns=3)
    object.__setattr__(cfg, "jax_obs_fleet", True)
    eng = ReachSketchEngine(cfg, mapping, campaigns=NAMES, redis=None,
                            k=16, registers=16, device="cpu")
    lines = b"".join(
        json.dumps({"user_id": f"u{i}", "page_id": "p", "ad_id": "ad0",
                    "ad_type": "banner", "event_type": "view",
                    "event_time": str(1_700_000_000_000 + i)}).encode()
        + b"\n" for i in range(50))
    eng.process_block(lines)
    srv = ReachQueryServer(NAMES)
    eng.attach_reach(srv)
    got = []
    srv.submit(["c0"], "union", lambda d: got.append(d))
    deadline = time.monotonic() + 10
    while not got and time.monotonic() < deadline:
        time.sleep(0.01)
    srv.close()
    fr = got[0]["freshness"]
    assert fr["tail_lag_ms"] == 0.0 and fr["ship_wait_ms"] == 0.0
    assert sum(fr[f"{h}_ms"] for h in FRESHNESS_HOPS) == pytest.approx(
        fr["staleness_ms"], abs=0.25)


# -------------------------------------------------- metrics federation
def _write_journal(path, role, pid, records, ts_base=1_000):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for i, rec in enumerate(records):
            out = {"kind": "snapshot", "seq": i,
                   "ts_ms": ts_base + i * 100, "uptime_ms": i * 100,
                   "pid": pid}
            if role:
                out["role"] = role
            out.update(rec)
            f.write(json.dumps(out) + "\n")


def _seeded_fleet(tmp_path, seed: int) -> list:
    """Seeded journals of a writer, replicas, a router and a controller
    (every block ``summarize_fleet`` folds); returns (role, path) specs."""
    rng = np.random.default_rng(seed)

    def hops():
        return {h: {"count": int(rng.integers(1, 90)),
                    "p99": float(round(rng.uniform(0, 900), 1))}
                for h in FRESHNESS_HOPS + ("total",)}

    specs = []
    w = str(tmp_path / f"s{seed}" / "writer" / "metrics.jsonl")
    _write_journal(w, "writer", 100, [
        {"events": int(rng.integers(0, 10**6)),
         "events_per_s": float(round(rng.uniform(1, 9e4), 1)),
         "ship": {"mode": "delta", "ships": 4, "bytes_per_tick": 123,
                  "rows_per_tick": 3, "ship_ms_per_tick": 0.5,
                  "bytes_total": 999, "bases": 1, "deltas": 3,
                  "cutovers": 0},
         "faults": {"net_faults": int(rng.integers(0, 9))}}
        for _ in range(int(rng.integers(1, 4)))]
        + [{"kind": "event", "event": "restart"}], ts_base=int(
            rng.integers(0, 500)))
    specs.append((None, w))
    for i in range(int(rng.integers(1, 4))):
        p = str(tmp_path / f"s{seed}" / f"replica_{i}" / "metrics.jsonl")
        _write_journal(p, "replica", 200 + i, [
            {"reach_query": {
                "served": int(rng.integers(0, 500)),
                "shed": int(rng.integers(0, 20)),
                "qps": float(round(rng.uniform(0, 900), 1)),
                "plane_epoch": int(rng.integers(0, 9)),
                "staleness_ms": float(round(rng.uniform(0, 900), 1)),
                "cache": {"hit_ratio": float(round(rng.random(), 4))},
                "freshness": {"hops": hops(), "high_water_ms": 5.0}},
             "clock": {"offset_ms": float(round(rng.normal(), 3)),
                       "uncertainty_ms": 0.7,
                       "applied": bool(rng.random() < 0.7)}}
            for _ in range(int(rng.integers(1, 4)))],
            ts_base=int(rng.integers(0, 500)))
        specs.append((None, p))
    r = str(tmp_path / f"s{seed}" / "router" / "metrics.jsonl")
    _write_journal(r, "router", 300, [
        {"router": {"routed": 50, "answered": 44, "shed": 6,
                    "failovers": 3, "shed_ratio": 0.12,
                    "failover_p99_ms": 12.5, "qps": 80.0,
                    "replicas": [{"suspect": True}, {"suspect": False}]}},
        {"kind": "event", "event": "autoscale_decision",
         "decision": "scale_up", "verdict": "serve",
         "knob": "replica_count", "replicas": 2},
        {"autoscale": {"replicas": 2, "decisions": 1, "scale_ups": 1,
                       "scale_downs": 0, "ship_tunes": 0, "holds": 2,
                       "shed_redirects": 1,
                       "last": {"decision": "scale_up", "verdict": "serve",
                                "knob": "replica_count", "replicas": 2}}}])
    specs.append(("router", r))
    return specs


@pytest.mark.parametrize("seed", range(3))
def test_fleet_collector_summary_and_table_equal_the_jax_package(
        tmp_path, seed):
    specs = _seeded_fleet(tmp_path, seed)
    out_p = str(tmp_path / f"fleet_p{seed}.jsonl")
    out_j = str(tmp_path / f"fleet_j{seed}.jsonl")
    coll = FleetCollector(specs, out_path=out_p)
    merged = coll.collect()
    jcoll = jax_fleet.FleetCollector(specs, out_path=out_j)
    jmerged = jcoll.collect()
    assert _dump(merged) == _dump(jmerged)
    assert open(out_p).read() == open(out_j).read()
    assert _dump(coll.sources) == _dump(jcoll.sources)
    s = summarize_fleet(merged, path="F")
    assert _dump(s) == _dump(jax_fleet.summarize_fleet(jmerged, path="F"))
    assert render_fleet(s) == jax_fleet.render_fleet(s)
    d = str(tmp_path / f"s{seed}")
    assert fleet.discover_roles(d) == jax_fleet.discover_roles(d)


def test_fleet_collector_merges_roles_and_stitches_rotation(tmp_path):
    wpath = str(tmp_path / "writer" / "metrics.jsonl")
    rpath = str(tmp_path / "replica" / "metrics.jsonl")
    _write_journal(wpath, "writer", 100, [
        {"events": 1000, "events_per_s": 500.0},
        {"events": 2000, "events_per_s": 600.0},
        {"kind": "event", "event": "restart", "restarts": 1}])
    _write_journal(rpath, "replica", 200, [{"reach_query": {
        "served": 40, "qps": 80.0, "staleness_ms": 450.0,
        "cache": {"hit_ratio": 0.75}}}])
    os.replace(wpath, wpath + ".1")
    _write_journal(wpath, "writer", 100, [
        {"events": 3000, "events_per_s": 700.0}], ts_base=2_000)
    records = FleetCollector([(None, wpath), (None, rpath)]).collect()
    assert {r["role"] for r in records} == {"writer", "replica"}
    assert sum(r.get("kind") == "snapshot" and r["role"] == "writer"
               for r in records) == 3
    ts = [r["ts_ms"] for r in records]
    assert ts == sorted(ts)
    s = summarize_fleet(records)
    by_role = {a["role"]: a for a in s["roles"]}
    assert by_role["writer"]["events"] == 3000
    assert by_role["writer"]["restarts"] == 1
    assert by_role["replica"]["cache_hit_ratio"] == 0.75


def test_fleet_cli_prints_what_the_jax_cli_prints(tmp_path, capsys):
    from streambench_tpu.obs.__main__ import main as jax_main
    from streambench_tpu_torch.obs.__main__ import main

    specs = _seeded_fleet(tmp_path, 7)
    args = ["fleet"] + [f"{r}={p}" if r else p for r, p in specs]
    assert main(args + ["--json"]) == 0
    ours = capsys.readouterr().out
    assert jax_main(args + ["--json"]) == 0
    assert ours == capsys.readouterr().out
    assert main(args) == 0
    table = capsys.readouterr().out
    assert "writer" in table and "replica" in table and "router:" in table
    # directory discovery, and a --watch that stops after two renders
    d = str(tmp_path / "s7")
    assert main(["fleet", d, "--watch", "--interval-s", "0.01",
                 "--iterations", "2"]) == 0
    assert capsys.readouterr().out.count("fleet report:") == 2


# ----------------------------------------------------- trace stitching
def _trace_doc(pid, wall0_ms, names):
    events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": 1,
               "args": {"name": "main"}}]
    for i, name in enumerate(names):
        events.append({"name": name, "cat": "stage", "ph": "X",
                       "ts": 1000.0 * i, "dur": 500.0, "pid": pid,
                       "tid": 1})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"run": "t", "wall0_ms": wall0_ms,
                          "spans": len(names), "spans_dropped": 0}}


@pytest.mark.parametrize("seed", range(2))
def test_merge_traces_equals_the_jax_package(tmp_path, seed):
    rng = random.Random(seed)
    inputs = []
    for i in range(4):
        p = str(tmp_path / f"trace_{i}.json")
        pid = rng.choice([11, 22, 33])        # shared pids get remapped
        with open(p, "w") as f:
            json.dump(_trace_doc(pid, rng.randint(1_000, 9_000),
                                 rng.sample(["encode", "drain",
                                             "query_reply", "device_step"],
                                            2)), f)
        inputs.append((rng.choice(["writer", "replica", None]), p))
    doc = merge_traces(inputs)
    assert _dump(doc) == _dump(jax_fleet.merge_traces(inputs))
    assert validate_chrome_trace(doc) == []
    assert trace_process_names(doc) == jax_fleet.trace_process_names(doc)
    assert len(trace_process_names(doc)) == 4


def test_merge_traces_aligns_clocks_and_names_lanes(tmp_path):
    a = str(tmp_path / "trace_100.json")
    b = str(tmp_path / "trace_200.json")
    json.dump(_trace_doc(100, 50_000, ["device_scan", "drain"]),
              open(a, "w"))
    json.dump(_trace_doc(200, 50_250, ["query_dispatch"]), open(b, "w"))
    doc = merge_traces([("writer", a), ("replica", b)])
    assert trace_process_names(doc) == {100: "writer", 200: "replica"}
    xs = {(e["pid"], e["name"]): e["ts"]
          for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert xs[(100, "device_scan")] == 0.0
    assert xs[(200, "query_dispatch")] == pytest.approx(250_000.0)


def test_trace_merge_cli(tmp_path, capsys):
    from streambench_tpu_torch.obs.__main__ import main

    a = str(tmp_path / "trace_1.json")
    b = str(tmp_path / "trace_2.json")
    json.dump(_trace_doc(11, 1_000, ["encode"]), open(a, "w"))
    json.dump(_trace_doc(22, 2_000, ["query_reply"]), open(b, "w"))
    out = str(tmp_path / "merged.json")
    assert main(["trace", f"writer={a}", f"replica={b}", "--merge",
                 "--out", out, "--json"]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["processes"] == {"11": "writer", "22": "replica"}
    merged = json.load(open(out))
    assert validate_chrome_trace(merged) == []
    assert main(["trace", a, b]) == 2


def test_parse_role_spec(tmp_path):
    p = tmp_path / "x=weird.json"
    p.write_text("{}")
    assert parse_role_spec(str(p)) == (None, str(p))
    assert parse_role_spec("writer=/tmp/m.jsonl") == (
        "writer", "/tmp/m.jsonl")
    assert parse_role_spec("writer=/tmp/m.jsonl") == \
        jax_fleet.parse_role_spec("writer=/tmp/m.jsonl")


def test_sampler_role_and_pid_stamps(tmp_path):
    from streambench_tpu_torch.obs import MetricsSampler

    path = str(tmp_path / "metrics.jsonl")
    s = MetricsSampler(path, interval_ms=10_000, role="replica")
    s.annotate("restart", restarts=1)
    s.close(final={"ok": True})
    recs = [json.loads(line) for line in open(path)]
    assert all(r["pid"] == os.getpid() for r in recs)
    assert all(r["role"] == "replica" for r in recs)
    assert recs[0]["kind"] == "event" and recs[-1]["kind"] == "final"


# ------------------------------- writer CLI + fleet replica process
def test_writer_and_fleet_replica_read_by_obs_fleet_and_trace_merge(
        tmp_path):
    """The writer CLI (``--engine reach``, ``jax.obs.fleet``, spans, a
    ship dir) and a ``--fleet --device cpu`` replica process with its
    own metrics dir: ``obs fleet`` over the run directory renders both
    roles, and ``obs trace --merge`` of their traces validates."""
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.io.journal import FileBroker

    rng = random.Random(9)
    campaigns = make_ids(4, rng)
    ads = make_ids(40, rng)
    gen.write_ids(campaigns, ads, str(tmp_path))
    gen.write_ad_mapping_file(campaigns, ads, str(tmp_path))
    src = gen.EventSource(ads=ads, user_ids=make_ids(300, rng),
                          page_ids=make_ids(10, rng), rng=rng)
    with FileBroker(str(tmp_path / "broker")).writer("ad-events") as w:
        for t in range(2_000):
            w.append_bytes(src.event_at(1_700_000_000_000 + 5 * t).encode()
                           + b"\n")
    ship_dir = tmp_path / "ship"
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\nkafka.topic: "ad-events"\n'
                    "jax.metrics.interval.ms: 200\njax.obs.fleet: true\n"
                    f"jax.obs.spans: true\njax.reach.ship.dir: {ship_dir}\n"
                    "jax.reach.ship.interval.ms: 10\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.engine",
         "--confPath", str(conf), "--workdir", str(tmp_path), "--catchup",
         "--engine", "reach", "--device", "cpu"],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rep_dir = tmp_path / "replica_0"
    rep = subprocess.Popen(
        [sys.executable, "-m", "streambench_tpu_torch.reach.replica",
         "--ship", str(ship_dir), "--device", "cpu", "--fleet",
         "--poll-ms", "20", "--max-staleness-ms", "600000",
         "--metrics-dir", str(rep_dir), "--metrics-interval-ms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        line = rep.stdout.readline()
        assert line.startswith("replica: pubsub=") and "fleet=on" in line
        host, port = line.split()[1].split("=")[1].rsplit(":", 1)
        d = {}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            d = ask(host, int(port), campaigns[:2], "f")
            if "estimate" in d:
                break
            time.sleep(0.05)
        assert "freshness" in d and d["staleness_ms"] == \
            d["freshness"]["staleness_ms"]
        # the writer is gone: its clock estimate is recorded, unapplied
        assert d["freshness"]["clock"]["applied"] is False
        rep.terminate()
        out, err = rep.communicate(timeout=60)
    finally:
        if rep.poll() is None:
            rep.kill()
            rep.communicate()
    assert rep.returncode == 0, err[-2000:]
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["fleet"] is True and "clock" in stats
    obs = [sys.executable, "-m", "streambench_tpu_torch.obs"]
    table = subprocess.run(obs + ["fleet", str(tmp_path)],
                           capture_output=True, text=True, timeout=120,
                           env=env, cwd=REPO)
    assert table.returncode == 0, table.stderr
    assert "writer" in table.stdout and "replica" in table.stdout
    assert "freshness p99 (ms)" in table.stdout
    traces = sorted(str(p) for p in tmp_path.glob("trace_*.json"))
    traces += sorted(str(p) for p in rep_dir.glob("trace_*.json"))
    assert len(traces) == 2, traces
    merged = str(tmp_path / "merged.json")
    m = subprocess.run(obs + ["trace", f"writer={traces[0]}",
                              f"replica={traces[1]}", "--merge", "--out",
                              merged], capture_output=True, text=True,
                       timeout=120, env=env, cwd=REPO)
    assert m.returncode == 0, m.stderr
    doc = json.load(open(merged))
    assert validate_chrome_trace(doc) == []
    assert sorted(trace_process_names(doc).values()) == ["replica",
                                                         "writer"]


# ----------------------------------------- phase 20 (a) on the CPU
def test_chip_smoke_scaleout_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 20 (a) through the smoke's own code on the CPU at a small
    size: the writer folds and ships while 1, then 2 ``--fleet`` replica
    processes (``cli_spawn``, ``--device cpu``) answer a storm; every
    reply's hops sum to its staleness, each replica reports its clock,
    replica 0 is SIGKILLed and respawned at its port, the final answers
    equal the oracle's, and ``obs fleet`` / ``obs trace --merge`` read
    the run.  Its own time limit of 150 s."""
    import threading

    import chip_smoke

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        return str(path)

    monkeypatch.setattr(chip_smoke, "_workdir", workdir)
    box: dict = {}

    def run():
        try:
            box["out"] = chip_smoke._fleet_scaleout(
                "cpu", events=20_000, users=5_000, queries_n=60,
                ingest_gap_s=0.3, agree_queries=16)
        except BaseException as e:      # reported below, in this thread
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=150)
    assert not t.is_alive(), "the scale-out rung outran its limit"
    if "err" in box:
        raise box["err"]
    out = box["out"]
    assert out["agree_equal_oracle"] == [True, True]
    assert [r["served"] + r["shed"] for r in out["ladder"].values()] == \
        [60, 120]
    assert all(len(r["clock"]) == r["replicas"]
               for r in out["ladder"].values())
    assert out["memory"]["respawn_to_answer_s"] > 0
    assert out["obs_fleet"]["roles"].count("writer") == 1
    assert sorted(set(out["trace_merge"]["processes"].values())) == [
        "replica", "writer"]
