"""The port's observability modules against the JAX package's, on the CPU.

The pure modules (registry exposition, report and diff rendering, the
regression comparator, span Chrome JSON, flight-recorder dumps, SLO
burn-rate transitions, the window lifecycle, the sampler's journal) run
the same scripted calls, with the same seeded numbers and injected
clocks, through ``streambench_tpu.obs`` and ``streambench_tpu_torch.obs``;
their outputs must be byte-identical.  The device modules (occupancy's
build watcher, the transfer ledger, the device-memory ledger, the
profiler capture) are checked for what they compute on the CPU.
"""

import importlib
import json
import os
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import streambench_tpu.obs  # noqa: F401
import streambench_tpu_torch.obs  # noqa: F401
from streambench_tpu_torch.obs import capture as port_capture
from streambench_tpu_torch.utils import build as port_build

torch.set_num_threads(1)

PKGS = ("streambench_tpu", "streambench_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.obs.{name}")


def both(scenario, *args):
    """``scenario(pkg, *args)`` through each package; the two results."""
    return [scenario(pkg, *args) for pkg in PKGS]


def seeded_values(seed: int, n: int = 400) -> list[float]:
    rng = np.random.default_rng(seed)
    return [float(v) for v in
            np.round(rng.lognormal(3.0, 1.5, size=n), 3)]


# ----------------------------------------------------------------------
# registry + the Prometheus endpoint
def _exposition(pkg: str, seed: int) -> str:
    reg = mod(pkg, "registry").MetricsRegistry()
    vals = seeded_values(seed)
    c = reg.counter("streambench_events_total", "events folded")
    c.inc(int(sum(vals)))
    reg.counter("streambench_stage_calls_total", "calls",
                labels={"stage": "encode"}).inc(7)
    reg.counter("streambench_stage_calls_total", "calls",
                labels={"stage": "drain"}).inc(3)
    reg.gauge("streambench_events_per_s", "rate").set(vals[0])
    reg.predeclare("counter", "streambench_kafka_redeliveries_total",
                   "redeliveries")
    h = reg.histogram("streambench_window_latency_ms", "latency")
    seg = reg.histogram("streambench_window_segment_ms", "segments",
                        lo=0.1, hi=1e7, growth=2 ** 0.125,
                        labels={"segment": "ingest"})
    for v in vals:
        h.observe(v)
        seg.observe(v * 3)
    return reg.render_prometheus()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_exposition_is_byte_identical(seed):
    ref, port = both(_exposition, seed)
    assert ref == port and "streambench_window_segment_ms_bucket" in port


def _histogram_numbers(pkg: str, seed: int) -> tuple:
    h = mod(pkg, "registry").StreamingHistogram("h")
    for v in seeded_values(seed):
        h.observe(v)
    return (h.summary(), h.quantiles((0.1, 0.5, 0.9, 0.999)),
            h.count_le(50.0))


@pytest.mark.parametrize("seed", [3, 4])
def test_histogram_summaries_and_quantiles_identical(seed):
    ref, port = both(_histogram_numbers, seed)
    assert ref == port


def test_metrics_server_serves_the_same_text():
    texts = []
    for pkg in PKGS:
        reg = mod(pkg, "registry").MetricsRegistry()
        reg.counter("streambench_events_total", "events").inc(12345)
        reg.histogram("streambench_window_latency_ms", "lat").observe(7.5)
        srv = mod(pkg, "httpd").MetricsServer(reg, port=0)
        try:
            with urllib.request.urlopen(srv.url, timeout=10) as r:
                texts.append(r.read())
        finally:
            srv.close()
    assert texts[0] == texts[1] and b"streambench_events_total" in texts[1]


# ----------------------------------------------------------------------
# report / diff / attribution rendering and the regression comparator
def make_records(seed: int, final: bool = True) -> list[dict]:
    """A run's metrics.jsonl records (snapshots, an event, a final)."""
    rng = np.random.default_rng(seed)
    recs, events = [], 0
    for i in range(12):
        d = int(rng.integers(50_000, 150_000))
        events += d
        lat = seeded_values(seed + i, 20)
        segs = {s: {"count": 20, "sum": round(sum(lat) * f, 3),
                    "min": 0.0, "max": max(lat) * f,
                    "p50": float(np.median(lat)) * f,
                    "p95": float(np.percentile(lat, 95)) * f,
                    "p99": float(np.percentile(lat, 99)) * f}
                for s, f in (("ingest", 0.8), ("encode", 0.01),
                             ("fold", 0.01), ("flush", 0.15),
                             ("sink", 0.03))}
        recs.append({
            "kind": "snapshot", "seq": i, "ts_ms": 1_700_000_000_000 + i,
            "uptime_ms": 1000 * i, "pid": 1, "events": events,
            "events_per_s": float(d), "windows_written": 10 * i,
            "watermark_lag_ms": int(rng.integers(0, 5000)),
            "sink_dirty_rows": 0, "pending_rows": int(rng.integers(0, 99)),
            "backlog_bytes": int(rng.integers(0, 10 ** 6)),
            "rss_bytes": int(rng.integers(10 ** 8, 10 ** 9)),
            "latency_ms": {"count": 20 * i + 1, "p50": lat[0],
                           "p95": lat[1], "p99": lat[2], "max": lat[3]},
            "stages": {"encode": {"calls": 3, "ms": lat[4]},
                       "device_step": {"calls": 9, "ms": lat[5]}},
            "faults": {"flush_stalls": i // 5},
            "fault_deltas": {},
            "attribution": {"writes_observed": 20 * i,
                            "writes_untracked": 0, "open_windows": 3,
                            "windows_evicted": 0,
                            "e2e_ms": {"count": 20, "p50": lat[0],
                                       "p95": lat[1], "p99": lat[2]},
                            "arrival_span_ms": {"count": 20},
                            "segments": segs},
            "occupancy": {"dispatches": 9 * i, "sampled": i,
                          "device_busy_ratio": round(lat[6] / 1e4, 4)},
            "xfer": {"dispatches": 9 * i, "formats": {"packed": {
                "dispatches": 9 * i, "events": events,
                "wire_bytes": 8 * events, "col_bytes": 8 * events,
                "bytes_per_event": 8.0, "col_bytes_per_event": 8.0}}},
            "devmem": {"state_bytes": 6472, "peak_footprint_bytes": 82000,
                       "kernels": {}},
            "slo": {"burn": {"latency": {"fast": 0.0, "slow": 0.0}},
                    "bad_windows": 0, "total_windows": 20 * i,
                    "breaches": 0, "in_breach": False},
        })
        if i == 6:
            recs.append({"kind": "event", "event": "profiler_capture",
                         "uptime_ms": 6500, "dir": "xprof_1_oneshot",
                         "reason": "oneshot"})
    if final:
        recs.append(dict(recs[-1], kind="final",
                         run_stats={"events": events, "dropped": 0}))
    return recs


def _renderings(pkg: str, tmp: str, seed: int) -> dict:
    rep = mod(pkg, "report")
    paths = []
    for k, s in (("a", seed), ("b", seed + 100)):
        p = os.path.join(tmp, f"{pkg}_{k}.jsonl")
        with open(p, "w") as f:
            for r in make_records(s, final=(k == "a")):
                f.write(json.dumps(r) + "\n")
        paths.append(p)
    a = rep.summarize(rep.load_records(paths[0]), path="A")
    b = rep.summarize(rep.load_records(paths[1]), path="B")
    att_a = rep.summarize_attribution(rep.load_records(paths[0]), path="A")
    att_b = rep.summarize_attribution(rep.load_records(paths[1]), path="B")
    return {"summary": json.dumps([a, b], sort_keys=True),
            "report": rep.render_report(a), "diff": rep.render_diff(a, b),
            "attribution": rep.render_attribution(att_a),
            "attribution_diff": rep.render_attribution_diff(att_a, att_b)}


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("output", ["summary", "report", "diff",
                                    "attribution", "attribution_diff"])
def test_report_and_diff_output_is_byte_identical(tmp_path, seed, output):
    ref, port = both(_renderings, str(tmp_path), seed)
    assert ref[output] == port[output] and port[output]


def _regress(pkg: str, a: dict, b: dict, tols: dict) -> tuple:
    reg = mod(pkg, "regress")
    res = reg.compare(reg.normalize_bench(a), reg.normalize_bench(b),
                      tolerances=tols, strict_missing=True)
    return json.dumps(res, sort_keys=True), reg.render(res)


def _bench_doc(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"catchup_events_per_s": float(rng.uniform(1e6, 2e6)),
            "occupancy": {"device_busy_ratio": float(rng.uniform(0, 1))},
            "paced": {"p50_ms": float(rng.uniform(1e4, 1.2e4)),
                      "p99_ms": float(rng.uniform(1.1e4, 1.3e4))},
            "xfer": {"formats": {"packed": {"bytes_per_event": 8.0}},
                     "packed_unpacked_ratio": 0.5},
            "devmem": {"peak_footprint_bytes": int(rng.integers(1, 9e6))}}


@pytest.mark.parametrize("seed,tols", [
    (7, {}), (8, {"catchup_events_per_s": 0.01}),
    (9, {"paced_p99_ms": 0.0, "device_busy_ratio": 0.0})],
    ids=["defaults", "tight_throughput", "tight_latency"])
def test_regress_verdicts_are_identical(seed, tols):
    a, b = _bench_doc(seed), _bench_doc(seed + 1)
    ref, port = both(_regress, a, b, tols)
    assert ref == port


def test_regress_cli_exit_codes_match(tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(_bench_doc(10)))
    worse = _bench_doc(10)
    worse["catchup_events_per_s"] /= 4
    b.write_text(json.dumps(worse))
    out = {pkg: [] for pkg in PKGS}
    rcs = {pkg: mod(pkg, "regress").run_cli(str(a), str(b),
                                            out=out[pkg].append)
           for pkg in PKGS}
    assert rcs == {pkg: 1 for pkg in PKGS}
    assert out[PKGS[0]] == out[PKGS[1]]


# ----------------------------------------------------------------------
# span Chrome JSON, flight-recorder dumps
def _chrome(pkg: str) -> str:
    sp = mod(pkg, "spans").SpanTracer(capacity=16)
    sp.wall0_ms = 1_700_000_000_000
    t0 = sp._t0_ns
    for i, name in enumerate(("encode", "device_step", "drain",
                              "redis_flush", "ingest_read",
                              "ingest_encode", "journal_read", "encode",
                              "device_scan", "drain") * 2):
        sp.add(name, t0 + 1_000_000 * i, 250_000 + 1_000 * i,
               cat="ingest" if name.startswith(("ingest", "journal"))
               else "stage", args={"records": i} if i % 2 else None)
    return json.dumps(sp.chrome_trace(run="ad-events"), sort_keys=True)


def test_span_chrome_json_is_byte_identical():
    ref, port = both(_chrome)
    assert ref == port
    doc = json.loads(port)
    assert doc["otherData"]["spans_dropped"] == 4
    assert mod(PKGS[1], "spans").validate_chrome_trace(doc) == []


def _flight_dump(pkg: str, tmp: str, monkeypatch) -> bytes:
    fr_mod = mod(pkg, "flightrec")
    clock = iter(range(1_000, 2_000))
    monkeypatch.setattr(fr_mod, "now_ms", lambda: next(clock))
    fr = fr_mod.FlightRecorder(os.path.join(tmp, pkg), capacity=8)
    fr.span_source = lambda n: [{"name": "drain", "dur_us": 1.5}][:n]
    for i in range(12):
        fr.record("tick", events=1000 * i, windows_written=i,
                  fault_deltas={"sink_errors": 1} if i == 9 else {})
    fr.record("signal", event="sigterm")
    path = fr.dump("sigterm", terminal={"kind": "fault", "event": "x"})
    with open(path, "rb") as f:
        return f.read()


def test_flight_recorder_dumps_are_byte_identical(tmp_path, monkeypatch):
    ref, port = both(_flight_dump, str(tmp_path), monkeypatch)
    assert ref == port
    last = json.loads(port.splitlines()[-1])
    assert last["event"] == "x"


# ----------------------------------------------------------------------
# SLO burn-rate transitions
def _slo_run(pkg: str, tmp: str, monkeypatch, objective: str) -> dict:
    reg = mod(pkg, "registry").MetricsRegistry()
    clock = {"t": 0.0}
    events, journal = [], []
    fr_mod = mod(pkg, "flightrec")
    monkeypatch.setattr(fr_mod, "now_ms", lambda: 5)
    fr = fr_mod.FlightRecorder(os.path.join(tmp, pkg))
    trk = mod(pkg, "slo").SloTracker(
        reg, p99_ms=1000 if objective == "latency" else 0,
        rate_evps=500 if objective == "rate" else 0,
        fast_s=5, slow_s=20, use_lifecycle=True,
        annotate=lambda ev, **kw: events.append((ev, kw)), flightrec=fr,
        clock=lambda: clock["t"])
    e2e = reg.histogram("streambench_window_e2e_ms", "e2e", lo=0.1,
                        hi=1e7, growth=2 ** 0.125)
    vals = seeded_values(11, 120)
    total = 0
    for tick in range(40):
        clock["t"] = float(tick)
        bad = 10 <= tick < 22           # an incident, then recovery
        for v in vals[tick % 100:tick % 100 + 3]:
            e2e.observe(v * (50 if bad else 1))
        rate = 100 if bad else 900
        total += rate
        rec = {"events": total, "events_per_s": float(rate)}
        trk.collect(rec, 1.0)
        journal.append(rec["slo"])
    return {"journal": json.dumps(journal, sort_keys=True),
            "events": json.dumps(events, sort_keys=True),
            "flight": json.dumps(list(fr._buf), sort_keys=True),
            "verdict": json.dumps(trk.verdict(), sort_keys=True)}


@pytest.mark.parametrize("objective", ["latency", "rate"])
def test_slo_burn_rate_transitions_are_identical(tmp_path, monkeypatch,
                                                 objective):
    ref, port = both(_slo_run, str(tmp_path), monkeypatch, objective)
    assert ref == port
    kinds = [e[0] for e in json.loads(port["events"])]
    assert kinds == ["slo_breach", "slo_recovered"]
    assert json.loads(port["verdict"])["pass"] is False


# ----------------------------------------------------------------------
# the window lifecycle and the sampler's journal
class _Batch:
    """The EncodedBatch surface ``note_fold`` reads."""

    def __init__(self, times, base, valid):
        self.event_time = np.asarray(times, np.int32)
        self.valid = np.asarray(valid, bool)
        self.n = len(times)
        self.base_time_ms = base


def _lifecycle_run(pkg: str, monkeypatch, seed: int) -> str:
    lc_mod = mod(pkg, "lifecycle")
    clock = {"t": 1_000_000}
    monkeypatch.setattr(lc_mod, "now_ms", lambda: clock["t"])
    reg = mod(pkg, "registry").MetricsRegistry()
    lc = lc_mod.WindowLifecycle(reg, divisor_ms=10_000, lateness_ms=20_000,
                                max_windows=32)
    rng = np.random.default_rng(seed)
    base = 1_700_000_000_000
    for step in range(60):
        times = np.sort(rng.integers(step * 2_000, step * 2_000 + 9_000,
                                     size=64))
        b = _Batch(times, base, rng.random(64) > 0.2)
        lc.stamp_encoded([b], read_ms=clock["t"] - int(rng.integers(0, 50)))
        clock["t"] += int(rng.integers(1, 30))
        lc.note_fold(b)
        clock["t"] += int(rng.integers(1, 300))
        if step % 5 == 4:
            ws = [base + w * 10_000 for w in range(step // 5 + 1)]
            lc.note_flush(ws)
            clock["t"] += int(rng.integers(1, 40))
            lc.note_written(ws + [base - 10_000], clock["t"])
    return json.dumps(lc.summary(), sort_keys=True)


@pytest.mark.parametrize("seed", [12, 13])
def test_lifecycle_attribution_is_identical(monkeypatch, seed):
    ref, port = both(_lifecycle_run, monkeypatch, seed)
    assert ref == port
    s = json.loads(port)
    assert s["writes_observed"] > 0 and s["writes_untracked"] > 0


@pytest.mark.parametrize("seed", [12, 13])
def test_lifecycle_clamps_recover_the_unclamped_sums(monkeypatch, seed):
    lc_mod = mod("streambench_tpu_torch", "lifecycle")
    base = 1_700_000_000_000
    clock = {"t": base + 40_000}     # every event read after its time
    monkeypatch.setattr(lc_mod, "now_ms", lambda: clock["t"])
    lc = lc_mod.WindowLifecycle(
        mod("streambench_tpu_torch", "registry").MetricsRegistry(),
        divisor_ms=10_000, lateness_ms=20_000)
    rng = np.random.default_rng(seed)
    late_total = 0
    for step in range(40):
        b = _Batch(np.full(8, step * 1_000), base, np.ones(8, bool))
        lc.stamp_encoded([b])
        clock["t"] += 5
        lc.note_fold(b)
        ts = base + (step * 1_000 // 10_000) * 10_000
        clock["t"] += 20
        lc.note_flush([ts])
        submit = clock["t"]
        # a fold lands while the write is in flight, on every other step
        late = int(rng.integers(1, 50)) if step % 2 else 0
        if late:
            clock["t"] += late
            lc.note_fold(b)
        clock["t"] += int(rng.integers(1, 10))
        stamp = submit + 1        # the writer stamped before the fold
        lc.note_written([ts], stamp)
        late_total += late
    s, c = lc.summary(), lc.clamps()
    # flush = submit - last fold = -late; nothing else goes negative
    assert c["segments_ms"] == {"ingest": 0, "encode": 0, "fold": 0,
                                "flush": late_total, "sink": 0}
    assert c["e2e_ms"] == 0 and c["writes_clamped"] == 20
    assert 0 < c["max_write_ms"] < 50
    seg_sum = sum(v["sum"] for v in s["segments"].values())
    assert seg_sum - sum(c["segments_ms"].values()) == s["e2e_ms"]["sum"]


class _Engine:
    """The host fields ``engine_collector`` reads."""

    def __init__(self, pkg: str):
        trace = importlib.import_module(f"{pkg}.trace")
        metrics = importlib.import_module(f"{pkg}.metrics")
        self.tracer = trace.Tracer()
        self.faults = metrics.FaultCounters()
        self._obs_hist = None
        self.events = 0

    def telemetry(self) -> dict:
        return {"events": self.events, "windows_written": self.events // 7,
                "watermark_lag_ms": 1234, "sink_dirty_rows": 0,
                "pending_rows": 5}


def _journal(pkg: str, tmp: str, monkeypatch) -> list:
    s_mod = mod(pkg, "sampler")
    monkeypatch.setattr(s_mod, "now_ms", lambda: 42)
    monkeypatch.setattr(s_mod, "rss_sample", lambda: (1 << 20, "rss_bytes"))
    reg = mod(pkg, "registry").MetricsRegistry()
    eng = _Engine(pkg)
    path = os.path.join(tmp, f"{pkg}.jsonl")
    smp = s_mod.MetricsSampler(path, interval_ms=10 ** 6, registry=reg)
    smp.add_collector(s_mod.engine_collector(eng, registry=reg))
    for i in range(5):
        eng.events += 1000 * (i + 1)
        eng.tracer.add("encode", 1_000_000 * (i + 1))
        eng.faults.inc("sink_retries", i % 2)
        smp.collect_now()
        smp._write(smp._snapshot_record())
    smp.annotate("profiler_capture", dir="d", reason="oneshot")
    smp.close(final={"events": eng.events})
    out = []
    with open(path) as f:
        for ln in f:
            rec = json.loads(ln)
            # wall-clock fields of the sampler's own monotonic clock
            for k in ("uptime_ms", "events_per_s", "pid"):
                rec.pop(k, None)
            out.append(rec)
    return [json.dumps(out, sort_keys=True), reg.render_prometheus()]


def test_sampler_journal_and_instruments_identical(tmp_path, monkeypatch):
    ref, port = both(_journal, str(tmp_path), monkeypatch)
    assert ref == port


# ----------------------------------------------------------------------
# the device modules, on the CPU
def test_compile_watcher_counts_library_builds(tmp_path, monkeypatch):
    from streambench_tpu_torch.obs import CompileWatcher, MetricsRegistry

    monkeypatch.setattr(port_build, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "src.txt"
    src.write_text("x")

    def copy(out):
        return [sys.executable, "-c",
                f"import shutil; shutil.copy({str(src)!r}, {out!r})"]

    reg = MetricsRegistry()
    w = CompileWatcher(reg)
    try:
        port_build.build_library("obs_a", [str(src)], copy)
        port_build.build_library("obs_a", [str(src)], copy)   # cached
        assert w.summary()["compiles_total"] == 1
        w.mark_steady()
        assert w.summary()["compiles_steady"] == 0
        src.write_text("y")                  # a new hash: a fresh build
        port_build.build_library("obs_a", [str(src)], copy)
        s = w.summary()
        assert (s["compiles_total"], s["compiles_steady"]) == (2, 1)
        assert "streambench_compiles_steady_total 1" in \
            reg.render_prometheus()
    finally:
        w.close()
    port_build.build_library("obs_b", [str(src)], copy)
    assert w.summary()["compiles_total"] == 2    # closed: not counted


@pytest.mark.parametrize("sample_every", [1, 3, 32])
def test_occupancy_samples_one_in_n_on_cpu(sample_every):
    from streambench_tpu_torch.obs import MetricsRegistry, OccupancySampler
    from streambench_tpu_torch.ops import windowcount as wc

    occ = OccupancySampler(MetricsRegistry(), sample_every=sample_every)
    state = wc.init_state(10, 16)
    for _ in range(40):
        occ.note_dispatch(state)
    s = occ.summary()
    occ.close()
    assert s["dispatches"] == 40 and s["sampled"] == 40 // sample_every
    assert 0.0 <= s["device_busy_ratio"] < 1.0


def _ledger(pkg: str) -> dict:
    reg = mod(pkg, "registry").MetricsRegistry()
    led = mod(pkg, "xfer").TransferLedger(reg, sample_every=0)
    rng = np.random.default_rng(14)
    for _ in range(25):
        n = int(rng.integers(1, 4096))
        led.note_dispatch("packed", n, 8 * 4096)
        led.note_dispatch("unpacked", n, 13 * 4096, 16 * 4096)
    s = led.summary()
    for f in s["formats"].values():       # the port's row count
        f.pop("rows", None)
        f.pop("bytes_per_row", None)
    return s


def test_transfer_ledger_accounting_identical():
    ref, port = both(_ledger)
    assert ref == port and port["packed_unpacked_ratio"] == 0.5


def test_transfer_ledger_times_nothing_on_the_cpu():
    from streambench_tpu_torch.obs import TransferLedger

    led = TransferLedger(sample_every=1)
    cols = [np.zeros(64, np.int32), np.zeros(64, np.int32)]
    led.note_dispatch("packed", 60, 512, rows=64, sample_arrays=cols,
                      device=torch.device("cpu"))
    s = led.summary()
    assert "sampled" not in s
    assert s["formats"]["packed"]["bytes_per_row"] == 8.0


def test_devmem_census_says_cpu_has_no_allocator():
    from streambench_tpu_torch.obs import DeviceMemoryLedger
    from streambench_tpu_torch.obs.devmem import state_nbytes
    from streambench_tpu_torch.ops import windowcount as wc

    led = DeviceMemoryLedger()
    led.device = torch.device("cpu")
    led.state_bytes = state_nbytes(wc.init_state(100, 16))
    led.poll()
    rec = {}
    led.collect(rec, 1.0)
    assert rec["devmem"]["state_bytes"] == 100 * 16 * 4 + 16 * 4 + 8
    assert rec["devmem"]["live"]["supported"] is False


def test_capture_records_a_chrome_trace_on_the_host_loop(tmp_path):
    from streambench_tpu_torch.obs import CaptureManager, MetricsRegistry

    clock = {"t": 0.0}
    events = []
    reg = MetricsRegistry()
    cap = CaptureManager(str(tmp_path), cooldown_s=10, max_captures=2,
                         window_s=1, registry=reg,
                         annotate=lambda ev, **kw: events.append(ev),
                         device=torch.device("cpu"),
                         clock=lambda: clock["t"])
    # from another thread, as the sampler's SLO collector calls it
    got = []
    t = threading.Thread(target=lambda: got.append(cap.trigger("slo")))
    t.start()
    t.join(timeout=10)
    assert got[0] and cap.active is None      # claimed, not started
    assert cap.trigger("again") is None       # one pending at a time
    cap.poll()                                # host loop: starts
    assert cap.active == got[0]
    torch.ones(8).add(1).sum()
    clock["t"] = 0.5
    cap.poll()                                # window not over
    assert cap.active == got[0]
    clock["t"] = 1.5
    cap.poll()                                # over: stopped + exported
    assert cap.active is None
    with open(os.path.join(got[0], port_capture.TRACE_FILE)) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    clock["t"] = 5.0
    assert cap.trigger("cooling") is None     # within the cooldown
    clock["t"] = 12.0
    second = cap.trigger("sigusr2")
    with port_capture.profiler_window(str(tmp_path / "whole"),
                                      torch.device("cpu")):
        cap.poll()                # the profiler is taken: suppressed
    assert cap.active is None and not os.path.exists(second)
    s = cap.summary()
    assert [c["reason"] for c in s["captures"]] == ["slo"]
    assert s["suppressed"] == 3 and events == ["profiler_capture"] * 2
    assert os.path.exists(tmp_path / "whole" / port_capture.TRACE_FILE)
    assert "streambench_captures_total 1" in reg.render_prometheus()
    cap.close()
