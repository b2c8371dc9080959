"""Tolerance-driven regression comparison of two run artifacts.

Six committed ``BENCH_*.json`` artifacts exist with no machine-checked
comparison between them — every "did this PR regress the bench?" answer
has been a human eyeballing numbers.  ``obs regress A B`` makes the
comparison executable: A is the baseline, B the candidate; each metric
is judged against a per-metric relative tolerance with a declared
direction (throughput regresses DOWN, latency/RSS regress UP), and the
exit code is the CI gate (0 = within tolerance, 1 = regressed,
2 = unusable input).  ``--advisory`` reports but always exits 0 — the
right mode on hosts whose run-to-run variance exceeds any honest
tolerance (this repo's 1-core container shows 2-4x swings; see
ADVICE.md).

Inputs are auto-detected per file:

- a **bench artifact** (``bench_latency.json`` / committed ``BENCH_*``
  shape): one JSON object — catchup throughput, sweep, config rows,
  occupancy;
- a **metrics journal** (``metrics.jsonl``): line-JSON; summarized via
  ``obs.report`` (rotated ``.1`` stitched in), compared on its final
  throughput/latency/RSS numbers.

Both normalize into one flat metric dict, so a bench artifact can even
be compared against a telemetry journal where their metrics overlap.
Metrics present in A but missing in B are reported (``missing``) and
count as regressions only with ``--strict-missing``.
"""

from __future__ import annotations

import json
import os

#: metric -> (direction, default relative tolerance).  direction
#: "higher" = bigger is better (regression when B < A*(1-tol));
#: "lower" = smaller is better (regression when B > A*(1+tol)).
#: Tolerances are deliberately generous: the gate exists to catch
#: collapses (a 2x loss), not noise (see module docstring).
DEFAULT_TOLERANCES: dict = {
    "catchup_events_per_s": ("higher", 0.5),
    "max_sustained_rate": ("higher", 0.5),
    "events_per_s_mean": ("higher", 0.5),
    "events_per_s_max": ("higher", 0.5),
    "paced_p50_ms": ("lower", 1.0),
    "paced_p99_ms": ("lower", 1.0),
    "latency_p50_ms": ("lower", 1.0),
    "latency_p99_ms": ("lower", 1.0),
    "device_busy_ratio": ("higher", 0.8),
    "windows_written": ("higher", 0.5),
    "rss_bytes_max": ("lower", 1.0),
    # data-path obs: measured host->device bytes per event
    # are near-deterministic for a fixed config (padding is the only
    # nondeterminism), so tolerances are tighter than the timing rows;
    # direction-aware — MORE bytes per event is the regression.
    "xfer_packed_bytes_per_event": ("lower", 0.25),
    "xfer_unpacked_bytes_per_event": ("lower", 0.25),
    "xfer_devdecode_bytes_per_event": ("lower", 0.25),
    # col-basis packed/unpacked ratio: 0.5 by construction; drifting UP
    # means the packed word stopped halving the wire
    "packed_unpacked_ratio": ("lower", 0.15),
    "devmem_peak_footprint_bytes": ("lower", 1.0),
    # reach serving: query throughput regresses DOWN, query
    # latency UP; generous like the other timing rows (1-core variance)
    "reach_qps": ("higher", 0.5),
    "reach_p99_ms": ("lower", 1.0),
    # query-path attribution: per-segment p50s regress UP
    # (more time in any segment is worse), as does the fraction of
    # query queue-wait spent behind ingest dispatches.  Generous: the
    # timing rows share the 1-core host's 2-4x variance, and the
    # contention ratio depends on the concurrent-ingest pacing.
    "reach_segment_queue_ms": ("lower", 1.0),
    "reach_segment_batch_ms": ("lower", 1.0),
    "reach_segment_dispatch_ms": ("lower", 1.0),
    "reach_segment_reply_ms": ("lower", 1.0),
    "reach_contention_ratio": ("lower", 1.0),
    # reach scale-out: the cache's hit ratio on the repeated
    # -query mix regresses DOWN (near-deterministic for a fixed mix:
    # tight); replica staleness regresses UP (bounded by cadence + poll
    # when healthy, but wall-timing on the 1-core host: generous), as
    # does the off-writer contention ratio the replica rung re-measures
    "reach_cache_hit_ratio": ("higher", 0.1),
    "reach_staleness_ms": ("lower", 1.0),
    "reach_offwriter_contention_ratio": ("lower", 1.0),
    # fleet freshness ledger: the end-to-end age of the
    # evidence behind replica replies regresses UP, as does each hop's
    # p99 — generous like every wall-timing row on the 1-core host
    # (cadence waits dominate and the ship interval is a config knob)
    "fleet_freshness_ms": ("lower", 1.0),
    "fleet_fold_lag_p99_ms": ("lower", 1.0),
    "fleet_ship_wait_p99_ms": ("lower", 1.0),
    "fleet_tail_lag_p99_ms": ("lower", 1.0),
    "fleet_serve_p99_ms": ("lower", 1.0),
    # fleet chaos router: the failover episode tail and the
    # honest-shed fraction of the seeded chaos rung both regress UP.
    # Advisory-by-tolerance like every wall-timing row here: the
    # failover episode is dominated by connect/timeout wall time on
    # the 1-core host, and the shed ratio by where the seeded faults
    # land relative to the storm's pacing.
    "router_failover_p99_ms": ("lower", 2.0),
    "router_shed_ratio": ("lower", 2.0),
    # SLO autopilot: the controller-on arm's breach fraction
    # under the seeded QPS ramp regresses UP (the autopilot's whole job
    # is keeping it low), the decision count regresses DOWN (a
    # controller that stopped deciding stopped controlling).  Both
    # advisory-by-tolerance: where the ramp's bursts land vs the
    # 1-core wall clock moves both run to run.
    "autoscale_breach_ratio_on": ("lower", 2.0),
    "autoscale_decisions": ("higher", 0.75),
    # sliding A/B: both arms' catchup throughput regresses
    # DOWN; generous like every timing row on the 1-core host
    "sliding_evps": ("higher", 0.5),
    "sliding_sliced_evps": ("higher", 0.5),
    # sketch memory: bytes of device state per distinct key
    # at the top cardinality rung regress UP (the whole point of the
    # SALSA plane is fewer of them), as does the p99 point-query count
    # error at matched device-memory budget.  bytes/key is
    # near-deterministic for a fixed geometry (tight tolerance); the
    # error row is statistical across the rung's hash draw (looser).
    "sketch_bytes_per_key": ("lower", 0.1),
    "sketch_p99_err": ("lower", 0.5),
    "sketch_salsa_evps": ("higher", 0.5),
    "sketch_fixed_evps": ("higher", 0.5),
    # delta shipping: writer-side ship cost per cadence
    # tick.  bytes/tick is near-deterministic for a fixed journal
    # (encoded size of the touched rows: tight-ish); ship wall ms is
    # 1-core wall timing (generous); the full/delta bytes ratio is the
    # headline O(C)->O(ΔC) claim and regresses DOWN.
    "ship_bytes_per_tick": ("lower", 0.5),
    "ship_ms_per_tick": ("lower", 2.0),
    "ship_bytes_ratio": ("higher", 0.5),
    # multi-tenant admission (baseline MTEN_r01): the
    # admission-ON arm's victim breach fraction under the seeded flash
    # crowd regresses UP (the controller's whole job), as does the
    # blame matrix's off-diagonal share in the OFF arm (more of the
    # victim's wait attributed to other tenants).  Advisory-by-
    # tolerance: both are wall-timing on the 1-core host — where
    # queries land relative to the aggressor's fold dispatches moves
    # run to run.
    "tenant_victim_breach_ratio": ("lower", 2.0),
    "tenant_blame_offdiag_ratio": ("lower", 2.0),
    # Kafka ingest edge: broker-surface delivery accounting
    # from the adapter's shared ledger.  Redeliveries/retries regress
    # UP (more faults surviving to the reader means the broker edge got
    # flakier for the same plan); consumer lag regresses UP (a consumer
    # that stopped draining).  All advisory-by-tolerance: fault
    # placement is plan-seeded but the op interleaving under wall-clock
    # pacing moves counts run to run.
    "kafka_redeliveries": ("lower", 2.0),
    "kafka_produce_retries": ("lower", 2.0),
    "kafka_consumer_lag": ("lower", 2.0),
}


def _first(d: dict, *keys, default=None):
    for k in keys:
        v = d.get(k)
        if v is not None:
            return v
    return default


def _num(v):
    return float(v) if isinstance(v, (int, float)) else None


def normalize_bench(doc: dict, path: str = "") -> dict:
    """Flatten a bench artifact into the comparable metric dict."""
    out: dict = {"kind": "bench", "path": path}
    out["catchup_events_per_s"] = _num(
        _first(doc, "catchup_events_per_s", "value"))
    out["max_sustained_rate"] = _num(doc.get("max_sustained_rate"))
    out["device_busy_ratio"] = _num(
        (doc.get("occupancy") or {}).get("device_busy_ratio")
        if isinstance(doc.get("occupancy"), dict)
        else doc.get("device_busy_ratio"))
    # the exact-count row's paced run (first sustained sweep rung falls
    # back to the exact config row's paced block)
    paced = None
    for row in doc.get("configs") or []:
        if row.get("config") == "exact_count":
            paced = row.get("paced")
            break
    if paced is None:
        sustained = [x for x in (doc.get("rates") or [])
                     if x.get("sustained")]
        paced = sustained[-1] if sustained else None
    if isinstance(paced, dict):
        out["paced_p50_ms"] = _num(paced.get("p50_ms"))
        out["paced_p99_ms"] = _num(paced.get("p99_ms"))
        slo = paced.get("slo")
        if isinstance(slo, dict):
            out["slo_pass"] = bool(slo.get("pass"))
    # data-path obs blocks: per-format measured bytes/event
    # + the packed/unpacked ratio + the devmem peak footprint
    xfer = doc.get("xfer")
    if isinstance(xfer, dict):
        for fmt, d in (xfer.get("formats") or {}).items():
            if isinstance(d, dict):
                out[f"xfer_{fmt}_bytes_per_event"] = _num(
                    d.get("bytes_per_event"))
        out["packed_unpacked_ratio"] = _num(
            xfer.get("packed_unpacked_ratio"))
    dm = doc.get("devmem")
    if isinstance(dm, dict):
        out["devmem_peak_footprint_bytes"] = _num(
            dm.get("peak_footprint_bytes"))
    # sliding A/B block: legacy vs sliced fold ev/s
    sab = doc.get("sliding_ab")
    if isinstance(sab, dict):
        out["sliding_evps"] = _num(sab.get("sliding_evps"))
        out["sliding_sliced_evps"] = _num(sab.get("sliding_sliced_evps"))
    # sketch-memory block (bench_sketch.py artifact): the
    # headline rung's bytes/key + p99 error + per-arm fold throughput
    sketch = doc.get("sketch")
    if isinstance(sketch, dict):
        out["sketch_bytes_per_key"] = _num(sketch.get("bytes_per_key"))
        out["sketch_p99_err"] = _num(sketch.get("p99_err"))
        out["sketch_salsa_evps"] = _num(sketch.get("salsa_evps"))
        out["sketch_fixed_evps"] = _num(sketch.get("fixed_evps"))
    # reach serving block (bench_reach.py artifact / engine stats line)
    reach = doc.get("reach")
    if isinstance(reach, dict):
        out["reach_qps"] = _num(reach.get("qps"))
        out["reach_p99_ms"] = _num(reach.get("p99_ms"))
        # per-segment p50s + contention ratio from the
        # attribution phase (segments values are p50 scalars, or full
        # summaries when an engine stats line is compared directly)
        for seg, v in (reach.get("segments") or {}).items():
            if isinstance(v, dict):
                v = v.get("p50")
            out[f"reach_segment_{seg}_ms"] = _num(v)
        out["reach_contention_ratio"] = _num(
            reach.get("contention_ratio"))
        # scale-out keys (bench_reach REACH_r03 schema, or an
        # engine/replica stats line's nested cache block)
        cache = reach.get("cache")
        out["reach_cache_hit_ratio"] = _num(
            cache.get("hit_ratio") if isinstance(cache, dict)
            else reach.get("cache_hit_ratio"))
        out["reach_staleness_ms"] = _num(reach.get("staleness_ms"))
        out["reach_offwriter_contention_ratio"] = _num(
            reach.get("offwriter_contention_ratio"))
        # fleet freshness keys (bench_reach replica rung with
        # --fleet replicas: total reply-age p99 + per-hop p99s)
        fresh = reach.get("freshness")
        if isinstance(fresh, dict):
            out["fleet_freshness_ms"] = _num(fresh.get("total_p99_ms"))
            for hop in ("fold_lag", "ship_wait", "tail_lag", "serve"):
                out[f"fleet_{hop}_p99_ms"] = _num(
                    fresh.get(f"{hop}_p99_ms"))
        # fleet chaos keys (bench_reach fleet_chaos rung, or a
        # router stats line / metrics record compared directly)
        rt = reach.get("router")
        if isinstance(rt, dict):
            out["router_failover_p99_ms"] = _num(
                rt.get("failover_p99_ms"))
            out["router_shed_ratio"] = _num(rt.get("shed_ratio"))
        # autopilot keys (bench_reach run_autoscale rung):
        # controller-on breach fraction + decision count
        asc = reach.get("autoscale")
        if isinstance(asc, dict):
            out["autoscale_breach_ratio_on"] = _num(
                asc.get("breach_ratio_on"))
            out["autoscale_decisions"] = _num(asc.get("decisions"))
        # delta-ship keys (bench_reach run_deltaship rung):
        # the delta arm's per-tick ship cost + the full/delta ratio
        ds = reach.get("deltaship")
        if isinstance(ds, dict):
            out["ship_bytes_per_tick"] = _num(
                ds.get("ship_bytes_per_tick"))
            out["ship_ms_per_tick"] = _num(ds.get("ship_ms_per_tick"))
            out["ship_bytes_ratio"] = _num(ds.get("bytes_ratio"))
    # multi-tenant keys (bench_multitenant MTEN_r01 schema):
    # the admission-ON arm's victim breach fraction + the OFF arm's
    # blame-matrix off-diagonal share
    mt = doc.get("multitenant")
    if isinstance(mt, dict):
        out["tenant_victim_breach_ratio"] = _num(
            mt.get("victim_breach_ratio_on"))
        out["tenant_blame_offdiag_ratio"] = _num(
            mt.get("blame_offdiag_ratio"))
    # kafka-edge keys (engine stats line / metrics summary
    # "kafka" block: the adapter ledger kafka_collector journals)
    kf = doc.get("kafka")
    if isinstance(kf, dict):
        out["kafka_redeliveries"] = _num(kf.get("redeliveries"))
        out["kafka_produce_retries"] = _num(kf.get("produce_retries"))
        out["kafka_consumer_lag"] = _num(kf.get("consumer_lag"))
    return {k: v for k, v in out.items() if v is not None}


def normalize_metrics(records: list, path: str = "") -> dict:
    """Flatten a metrics.jsonl record stream (obs.report summary)."""
    from streambench_tpu_torch.obs.report import summarize

    s = summarize(records, path=path)
    lat = s.get("latency_ms") or {}
    out = {
        "kind": "metrics", "path": path,
        "events_per_s_mean": _num(s.get("events_per_s_mean")),
        "events_per_s_max": _num(s.get("events_per_s_max")),
        "windows_written": _num(s.get("windows_written")),
        "latency_p50_ms": _num(lat.get("p50")),
        "latency_p99_ms": _num(lat.get("p99")),
        "rss_bytes_max": _num(s.get("rss_bytes_max")),
    }
    xfer = s.get("xfer")
    if isinstance(xfer, dict):
        for fmt, d in (xfer.get("formats") or {}).items():
            if isinstance(d, dict):
                out[f"xfer_{fmt}_bytes_per_event"] = _num(
                    d.get("bytes_per_event"))
        out["packed_unpacked_ratio"] = _num(
            xfer.get("packed_unpacked_ratio"))
    dm = s.get("devmem")
    if isinstance(dm, dict):
        out["devmem_peak_footprint_bytes"] = _num(
            dm.get("peak_footprint_bytes"))
    rs = s.get("run_stats")
    if isinstance(rs, dict):
        if rs.get("events_per_s") is not None:
            out["catchup_events_per_s"] = _num(rs["events_per_s"])
        if rs.get("device_busy_ratio") is not None:
            out["device_busy_ratio"] = _num(rs["device_busy_ratio"])
        if isinstance(rs.get("slo"), dict):
            out["slo_pass"] = bool(rs["slo"].get("pass"))
    # the kafka_collector's broker-edge ledger block
    kf = s.get("kafka")
    if isinstance(kf, dict):
        out["kafka_redeliveries"] = _num(kf.get("redeliveries"))
        out["kafka_produce_retries"] = _num(kf.get("produce_retries"))
        out["kafka_consumer_lag"] = _num(kf.get("consumer_lag"))
    return {k: v for k, v in out.items() if v is not None}


def load_artifact(path: str) -> dict:
    """Load + normalize one input, auto-detecting its shape."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        doc = json.loads(text)
        if isinstance(doc, dict):
            return normalize_bench(doc, path=path)
    except json.JSONDecodeError:
        pass
    # line-JSON journal: reuse the report loader (stitches .1 rotation)
    from streambench_tpu_torch.obs.report import load_records

    records = load_records(path)
    if not records:
        raise ValueError(f"{path}: neither a JSON artifact nor a "
                         "metrics.jsonl journal")
    return normalize_metrics(records, path=path)


# ----------------------------------------------------------------------
def compare(a: dict, b: dict,
            tolerances: "dict | None" = None,
            strict_missing: bool = False) -> dict:
    """Judge candidate ``b`` against baseline ``a``.

    Returns {"rows": [...], "regressions": n, "missing": n,
    "pass": bool}; each row is {metric, a, b, delta_pct, tol_pct,
    direction, verdict} with verdict in OK / IMPROVED / REGRESSED /
    MISSING.  ``slo_pass`` is boolean-compared: True -> False is a
    regression outright.
    """
    tols = dict(DEFAULT_TOLERANCES)
    for k, v in (tolerances or {}).items():
        direction = tols.get(k, ("higher", None))[0]
        tols[k] = (direction, float(v))
    rows: list[dict] = []
    regressions = missing = 0
    keys = [k for k in a if k not in ("kind", "path")]
    for k in keys:
        va = a[k]
        vb = b.get(k)
        if k == "slo_pass":
            if vb is None:
                continue
            bad = bool(va) and not bool(vb)
            rows.append({"metric": k, "a": va, "b": vb,
                         "verdict": "REGRESSED" if bad else "OK"})
            regressions += bad
            continue
        direction, tol = tols.get(k, ("higher", 0.5))
        if vb is None:
            missing += 1
            rows.append({"metric": k, "a": va, "b": None,
                         "tol_pct": round(tol * 100, 1),
                         "direction": direction, "verdict": "MISSING"})
            if strict_missing:
                regressions += 1
            continue
        delta = (vb - va) / va if va else 0.0
        if direction == "higher":
            verdict = ("REGRESSED" if delta < -tol
                       else "IMPROVED" if delta > tol else "OK")
        else:
            verdict = ("REGRESSED" if delta > tol
                       else "IMPROVED" if delta < -tol else "OK")
        regressions += verdict == "REGRESSED"
        rows.append({"metric": k, "a": va, "b": vb,
                     "delta_pct": round(delta * 100, 1),
                     "tol_pct": round(tol * 100, 1),
                     "direction": direction, "verdict": verdict})
    return {"a": a.get("path"), "b": b.get("path"), "rows": rows,
            "regressions": regressions, "missing": missing,
            "pass": regressions == 0}


def render(result: dict) -> str:
    lines = ["regression gate:",
             f"  A (baseline):  {result['a']}",
             f"  B (candidate): {result['b']}",
             f"  {'metric':<24} {'A':>14} {'B':>14} {'delta':>9} "
             f"{'tol':>7}  verdict"]

    def fmt(v):
        if v is None:
            return "-"
        if isinstance(v, bool):
            return str(v)
        return f"{v:,.1f}" if isinstance(v, float) else str(v)

    for r in result["rows"]:
        delta = (f"{r['delta_pct']:+.1f}%"
                 if r.get("delta_pct") is not None else "-")
        tol = (f"{r['tol_pct']:.0f}%"
               if r.get("tol_pct") is not None else "-")
        lines.append(f"  {r['metric']:<24} {fmt(r.get('a')):>14} "
                     f"{fmt(r.get('b')):>14} {delta:>9} {tol:>7}  "
                     f"{r['verdict']}")
    lines.append(f"  => {'PASS' if result['pass'] else 'FAIL'} "
                 f"({result['regressions']} regressed, "
                 f"{result['missing']} missing)")
    return "\n".join(lines)


def run_cli(path_a: str, path_b: str, tol_args: "list[str] | None" = None,
            as_json: bool = False, advisory: bool = False,
            strict_missing: bool = False, out=print) -> int:
    """The ``obs regress`` entry: load, compare, render, gate."""
    tols: dict = {}
    for spec in tol_args or []:
        if "=" not in spec:
            out(f"error: --tol expects metric=frac, got {spec!r}")
            return 2
        k, _, v = spec.partition("=")
        try:
            tols[k.strip()] = float(v)
        except ValueError:
            out(f"error: --tol {spec!r}: not a number")
            return 2
    try:
        a = load_artifact(path_a)
        b = load_artifact(path_b)
    except (OSError, ValueError) as e:
        out(f"error: {e}")
        return 2
    result = compare(a, b, tolerances=tols,
                     strict_missing=strict_missing)
    out(json.dumps(result) if as_json else render(result))
    if advisory and not result["pass"]:
        out("advisory mode: regressions reported, exit forced 0")
        return 0
    return 0 if result["pass"] else 1

