"""Run reports from ``metrics.jsonl`` time series: summarize and diff.

The reporting half of the telemetry subsystem: ``summarize`` folds one
run's snapshot stream into a scalar summary, ``render_report`` prints it
human-readable, and ``render_diff`` lines two runs up column-for-column
with absolute and relative deltas — the before/after reading every perf
PR needs (the reference has nothing like it; its numbers are read off
scattered engine logs by hand).
"""

from __future__ import annotations

import json


def load_records(path: str, stitch_rotated: bool = True) -> list[dict]:
    """Parse a metrics.jsonl file, skipping torn/blank lines (a killed
    run can leave a partial last record; the series before it is still
    a valid report).

    ``jax.metrics.max.bytes`` rotation moves the OLDER half of a long
    run to ``<path>.1`` — when that file exists its records are
    stitched in FIRST, so ``report``/``diff`` cover the whole run
    instead of silently summarizing only the post-rotation tail
    (events/s means and fault totals were wrong for exactly the long
    chaos sweeps the rotation exists for)."""
    import os

    paths = [path]
    if stitch_rotated and os.path.exists(path + ".1"):
        paths.insert(0, path + ".1")
    out: list[dict] = []
    for p in paths:
        with open(p, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    return out


def summarize(records: list[dict], path: str = "") -> dict:
    """Fold one run's records into the scalar summary the renderers use."""
    snaps = [r for r in records if r.get("kind") in ("snapshot", "final")]
    final = next((r for r in reversed(records)
                  if r.get("kind") == "final"), None)
    last = final or (snaps[-1] if snaps else {})
    events_ann = [r for r in records if r.get("kind") == "event"]
    rates = [r["events_per_s"] for r in snaps
             if isinstance(r.get("events_per_s"), (int, float))
             and r["events_per_s"] > 0]

    def col_max(key):
        vals = [r[key] for r in snaps
                if isinstance(r.get(key), (int, float))]
        return max(vals) if vals else None

    stages: dict[str, dict] = {}
    for r in snaps:
        for name, d in (r.get("stages") or {}).items():
            agg = stages.setdefault(name, {"calls": 0, "ms": 0.0})
            agg["calls"] += d.get("calls", 0)
            agg["ms"] = round(agg["ms"] + d.get("ms", 0.0), 3)
    latency = None
    for r in reversed(snaps):
        if r.get("latency_ms"):
            latency = r["latency_ms"]
            break

    def last_block(key):
        for r in reversed(snaps):
            if isinstance(r.get(key), dict):
                return r[key]
        return None

    return {
        "path": path,
        "snapshots": len(snaps),
        "duration_s": round(last.get("uptime_ms", 0) / 1000.0, 1),
        "events": last.get("events"),
        "windows_written": last.get("windows_written"),
        "events_per_s_mean": (round(sum(rates) / len(rates), 1)
                              if rates else None),
        "events_per_s_max": max(rates) if rates else None,
        "backlog_bytes_max": col_max("backlog_bytes"),
        "watermark_lag_ms_max": col_max("watermark_lag_ms"),
        "sink_dirty_rows_max": col_max("sink_dirty_rows"),
        "rss_bytes_max": col_max("rss_bytes"),
        # the ru_maxrss fallback path journals PEAK rss under its own
        # key (obs.sampler.rss_sample) — keep the two apart here too
        "rss_peak_bytes_max": col_max("rss_peak_bytes"),
        "latency_ms": latency,
        # data-path obs: newest transfer / device-memory /
        # shard-skew blocks, when those ledgers were armed
        "xfer": last_block("xfer"),
        "devmem": last_block("devmem"),
        "shard_skew": last_block("shard_skew"),
        # sketch-memory census: counter-plane family + state
        # bytes, journaled by engines exposing sketch_summary()
        "sketch": last_block("sketch"),
        # serving-tier obs (jax.obs.query): newest per-query
        # attribution block the reach collector journals
        "reach_query": last_block("reach_query"),
        # multi-tenant host: per-tenant namespaces, burn
        # gauges, the device-time blame matrix, and the admission
        # controller's decision counters
        "tenants": last_block("tenants"),
        "slo_tenants": last_block("slo_tenants"),
        "multitenant": last_block("multitenant"),
        "admission": last_block("admission"),
        # Kafka delivery ledger: the broker-edge accounting
        # block the kafka_collector journals (produced/delivered/
        # redeliveries/retries + consumer lag)
        "kafka": last_block("kafka"),
        "faults": last.get("faults") or {},
        "stages": stages,
        "annotations": [{k: r.get(k) for k in ("event", "uptime_ms")}
                        | {k: v for k, v in r.items()
                           if k not in ("kind", "ts_ms")}
                        for r in events_ann],
        "run_stats": (final or {}).get("run_stats"),
    }


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:,.1f}"
    if isinstance(v, int):
        return f"{v:,}"
    return str(v)


# (label, summary key) rows shared by report and diff so the two views
# never drift apart
_SCALAR_ROWS = (
    ("duration_s", "duration_s"),
    ("snapshots", "snapshots"),
    ("events", "events"),
    ("events/s mean", "events_per_s_mean"),
    ("events/s max", "events_per_s_max"),
    ("windows written", "windows_written"),
    ("backlog bytes max", "backlog_bytes_max"),
    ("watermark lag ms max", "watermark_lag_ms_max"),
    ("sink dirty rows max", "sink_dirty_rows_max"),
    ("rss bytes max", "rss_bytes_max"),
    ("rss PEAK bytes max", "rss_peak_bytes_max"),
)


def _latency_rows(s: dict) -> list[tuple[str, object]]:
    lat = s.get("latency_ms") or {}
    return [(f"latency {k}", lat.get(k))
            for k in ("p50", "p95", "p99", "max", "count")]


def render_report(s: dict) -> str:
    lines = [f"telemetry report: {s['path'] or '(records)'}"]
    for label, key in _SCALAR_ROWS:
        lines.append(f"  {label:<22} {_fmt(s.get(key))}")
    for label, v in _latency_rows(s):
        lines.append(f"  {label:<22} {_fmt(v)}")
    xfer = s.get("xfer")
    if xfer and xfer.get("formats"):
        lines.append("  transfer (host->device bytes, measured):")
        for fmt, d in sorted(xfer["formats"].items()):
            lines.append(
                f"    {fmt:<10} {_fmt(d.get('dispatches')):>8} disp "
                f"{_fmt(d.get('events')):>12} ev "
                f"{_fmt(d.get('bytes_per_event')):>10} B/ev "
                f"({_fmt(d.get('col_bytes_per_event'))} B/ev int32)")
        if xfer.get("packed_unpacked_ratio") is not None:
            lines.append(f"    packed/unpacked ratio  "
                         f"{xfer['packed_unpacked_ratio']} "
                         f"({xfer.get('ratio_basis')})")
        if xfer.get("xfer_mb_s") is not None:
            lines.append(f"    sampled link rate      "
                         f"{_fmt(xfer['xfer_mb_s'])} MB/s over "
                         f"{_fmt(xfer.get('sampled'))} timed transfers")
    dm = s.get("devmem")
    if dm:
        lines.append("  memory (device, measured):")
        lines.append(f"    state bytes            "
                     f"{_fmt(dm.get('state_bytes'))}")
        lines.append(f"    peak footprint bytes   "
                     f"{_fmt(dm.get('peak_footprint_bytes'))}")
        for name, k in sorted((dm.get("kernels") or {}).items()):
            if k.get("supported"):
                lines.append(f"    kernel {name:<16} "
                             f"{_fmt(k.get('total_bytes')):>12} B "
                             f"(arg {_fmt(k.get('argument_bytes'))} + "
                             f"out {_fmt(k.get('output_bytes'))} + "
                             f"tmp {_fmt(k.get('temp_bytes'))})")
        live = dm.get("live")
        if live and live.get("supported"):
            lines.append(f"    live arrays            "
                         f"{_fmt(live.get('count'))} holding "
                         f"{_fmt(live.get('bytes'))} B")
    sk = s.get("shard_skew")
    if sk:
        lines.append("  shard skew (routed rows per campaign shard):")
        lines.append(f"    rows {sk.get('rows')}  dropped "
                     f"{sk.get('dropped')}  imbalance "
                     f"{_fmt(sk.get('imbalance_ratio'))}")
    sm = s.get("sketch")
    if sm:
        lines.append("  sketch memory (counter plane, measured):")
        lines.append(f"    mode {sm.get('mode')}  stages "
                     f"{sm.get('stages')}  state bytes "
                     f"{_fmt(sm.get('state_bytes'))}")
        if sm.get("merged_pairs") is not None:
            lines.append(f"    merged pairs {_fmt(sm.get('merged_pairs'))}"
                         f"  quads {_fmt(sm.get('merged_quads'))} of "
                         f"{_fmt(sm.get('cells'))} cells")
    rqf = (s.get("reach_query") or {}).get("freshness")
    if rqf and rqf.get("hops"):
        # fleet freshness ledger: per-hop p99 of the age of
        # the evidence behind every served reply
        lines.append("  reply freshness (age by hop, p99 ms):")
        lines.append("    " + "  ".join(
            f"{hop} {_fmt((rqf['hops'].get(hop) or {}).get('p99'))}"
            for hop in ("fold_lag", "ship_wait", "tail_lag", "serve",
                        "total")))
        clock = rqf.get("clock")
        if clock:
            lines.append(
                f"    clock offset {_fmt(clock.get('offset_ms'))} ms "
                f"+-{_fmt(clock.get('uncertainty_ms'))} "
                f"({'applied' if clock.get('applied') else 'NOT applied'})")
    rqo = (s.get("reach_query") or {}).get("query_obs")
    if rqo:
        lines.append("  reach query attribution (submit -> reply):")
        lines.append(f"    tracked {_fmt(rqo.get('served_records'))}  "
                     f"shed {_fmt(rqo.get('shed_records'))}  "
                     f"slow {_fmt(rqo.get('slow_queries'))}")
        for seg, summ in (rqo.get("segments") or {}).items():
            if summ.get("count"):
                lines.append(
                    f"    seg {seg:<9} p50 {_fmt(summ.get('p50')):>10} "
                    f"ms  p99 {_fmt(summ.get('p99')):>10} ms")
        e2e = rqo.get("e2e_ms") or {}
        if e2e.get("count"):
            lines.append(
                f"    e2e           p50 {_fmt(e2e.get('p50')):>10} ms  "
                f"p99 {_fmt(e2e.get('p99')):>10} ms")
        cont = rqo.get("contention") or {}
        if cont:
            lines.append(
                f"    contention ratio {_fmt(cont.get('ratio'))} "
                f"(queue wait {_fmt(cont.get('queue_wait_ms'))} ms, "
                f"ingest overlap {_fmt(cont.get('ingest_overlap_ms'))} "
                "ms)")
    tn = s.get("tenants")
    if tn:
        mt = s.get("multitenant") or {}
        slo_t = s.get("slo_tenants") or {}
        busy = mt.get("busy_ms") or {}
        wait = mt.get("wait_ms") or {}
        lines.append("  tenants (disjoint namespaces, one device):")
        lines.append(f"    {'tenant':<8} {'kind':<8} {'events':>10} "
                     f"{'folded':>7} {'busy ms':>11} {'wait ms':>11} "
                     f"{'burn':>6}")
        for name in sorted(tn):
            t = tn[name] if isinstance(tn[name], dict) else {}
            fast = [b.get("fast")
                    for b in ((slo_t.get(name) or {}).get("burn")
                              or {}).values()
                    if isinstance(b, dict)
                    and isinstance(b.get("fast"), (int, float))]
            lines.append(
                f"    {name:<8} {t.get('kind') or '-':<8} "
                f"{_fmt(t.get('events')):>10} "
                f"{_fmt(t.get('folded_batches')):>7} "
                f"{_fmt(busy.get(name)):>11} "
                f"{_fmt(wait.get(name)):>11} "
                f"{_fmt(round(max(fast), 2) if fast else None):>6}")
        if mt.get("offdiag_ratio") is not None:
            ok = (mt.get("partition") or {}).get("ok")
            lines.append(
                f"    blame offdiag {_fmt(mt['offdiag_ratio'])}  "
                f"partition {'ok' if ok else 'FAIL' if ok is False else '-'}")
        adm = s.get("admission")
        if adm:
            lines.append(
                f"    admission: defers {_fmt(adm.get('defers'))}  "
                f"sheds {_fmt(adm.get('sheds'))}  "
                f"releases {_fmt(adm.get('releases'))}  "
                f"deferred {_fmt(adm.get('batches_deferred'))}  "
                f"shed {_fmt(adm.get('batches_shed'))}")
    kf = s.get("kafka")
    if kf:
        lines.append(
            "  kafka edge (broker delivery ledger):")
        lines.append(
            f"    produced {_fmt(kf.get('produced'))}  "
            f"delivered {_fmt(kf.get('delivered'))}  "
            f"redeliveries {_fmt(kf.get('redeliveries'))}  "
            f"lag {_fmt(kf.get('consumer_lag'))}")
        lines.append(
            f"    produce retries {_fmt(kf.get('produce_retries'))}  "
            f"consume retries {_fmt(kf.get('consume_retries'))}  "
            f"dr failures {_fmt(kf.get('dr_failures'))}  "
            f"backoff ms {_fmt(kf.get('broker_down_ms'))}")
    if s["faults"]:
        lines.append("  faults:")
        for k in sorted(s["faults"]):
            lines.append(f"    {k:<26} {_fmt(s['faults'][k])}")
    if s["stages"]:
        lines.append("  stages (calls, total_ms):")
        width = max(len(n) for n in s["stages"])
        for name, agg in sorted(s["stages"].items(),
                                key=lambda kv: -kv[1]["ms"]):
            lines.append(f"    {name:<{width}}  {agg['calls']:>8}  "
                         f"{agg['ms']:>12.1f}")
    if s["annotations"]:
        lines.append("  events:")
        for a in s["annotations"]:
            extras = {k: v for k, v in a.items()
                      if k not in ("event", "uptime_ms")}
            lines.append(f"    +{(a.get('uptime_ms') or 0) / 1000.0:.1f}s "
                         f"{a.get('event')} {extras or ''}".rstrip())
    if s.get("run_stats"):
        lines.append(f"  run_stats: {json.dumps(s['run_stats'])}")
    return "\n".join(lines)


# ----------------------------------------------------------------------
# serving-layer query attribution (obs.queryattr): the "reach_query"
# block each snapshot carries, rendered by `obs serve A [B]`
def summarize_serve(records: list[dict], path: str = "") -> dict:
    """Newest ``reach_query`` block out of one run's records (final
    record first, torn tail falls back to the last intact snapshot)."""
    rq = None
    for r in reversed(records):
        if isinstance(r.get("reach_query"), dict):
            rq = r["reach_query"]
            break
    return {"path": path, "reach_query": rq}


def render_serve(s: dict) -> str:
    """One run's serving-layer table: admission/shed counters, the
    segment decomposition, contention, and the slow-query log tail."""
    rq = s.get("reach_query") or {}
    qobs = rq.get("query_obs")
    lines = [f"reach serving attribution: {s['path'] or '(records)'}"]
    if not qobs:
        lines.append("  no reach_query records "
                     "(run --engine reach with jax.obs.query: true)")
        return "\n".join(lines)
    lines.append(f"  served {_fmt(rq.get('served'))}  "
                 f"shed {_fmt(rq.get('shed'))}  "
                 f"rejected {_fmt(rq.get('rejected'))}  "
                 f"dispatches {_fmt(rq.get('dispatches'))}  "
                 f"queue high-water {_fmt(rq.get('queue_high_water'))}"
                 f"/{_fmt(rq.get('queue_depth'))}")
    # scale-out rows: planes epoch/staleness + cache hit mix
    if rq.get("plane_epoch") is not None:
        stale = rq.get("staleness_ms")
        lines.append(
            f"  plane epoch {_fmt(rq['plane_epoch'])}"
            + (f"  staleness {_fmt(stale)} ms"
               f"/{_fmt(rq.get('max_staleness_ms'))} bound"
               if stale is not None else "")
            + (f"  stale sheds {_fmt(rq['shed_stale'])}"
               if rq.get("shed_stale") else ""))
    cache = rq.get("cache")
    if isinstance(cache, dict):
        lines.append(
            f"  cache hit ratio {_fmt(cache.get('hit_ratio'))} "
            f"({_fmt(cache.get('hits'))} hits / "
            f"{_fmt(cache.get('misses'))} misses; "
            f"{_fmt(cache.get('entries'))}/{_fmt(cache.get('capacity'))}"
            f" entries, {_fmt(cache.get('evictions'))} evicted, "
            f"{_fmt(cache.get('invalidations'))} epoch invalidations)")
    fr = rq.get("freshness")
    if isinstance(fr, dict) and fr.get("hops"):
        lines.append("  reply freshness p99 (ms): " + "  ".join(
            f"{hop} {_fmt((fr['hops'].get(hop) or {}).get('p99'))}"
            for hop in ("fold_lag", "ship_wait", "tail_lag", "serve",
                        "total"))
            + f"  (high water {_fmt(fr.get('high_water_ms'))})")
    lines.append(f"  lifecycle records: {_fmt(qobs.get('served_records'))}"
                 f" served + {_fmt(qobs.get('shed_records'))} shed")
    segs = qobs.get("segments") or {}
    p50_sum = sum(_p50(v) for v in segs.values())
    lines.append(f"  {'segment':<10} {'count':>8} {'p50_ms':>12} "
                 f"{'p95_ms':>12} {'p99_ms':>12} {'share':>7}")
    for name, summ in segs.items():
        share = (f"{_p50(summ) / p50_sum * 100:.1f}%" if p50_sum else "-")
        lines.append(
            f"  {name:<10} {_fmt(summ.get('count') or 0):>8} "
            f"{_fmt(summ.get('p50')):>12} {_fmt(summ.get('p95')):>12} "
            f"{_fmt(summ.get('p99')):>12} {share:>7}")
    e2e = qobs.get("e2e_ms") or {}
    lines.append(f"  {'e2e':<10} {_fmt(e2e.get('count') or 0):>8} "
                 f"{_fmt(e2e.get('p50')):>12} {_fmt(e2e.get('p95')):>12} "
                 f"{_fmt(e2e.get('p99')):>12}")
    if _p50(e2e):
        cov = p50_sum / _p50(e2e) * 100
        lines.append(f"  segment p50 sum {p50_sum:,.1f} ms = {cov:.1f}% "
                     "of e2e p50")
    shed_q = qobs.get("shed_queue_ms") or {}
    if shed_q.get("count"):
        lines.append(f"  shed queue wait    p50 {_fmt(shed_q.get('p50'))}"
                     f" ms over {_fmt(shed_q['count'])} shed records")
    cont = qobs.get("contention") or {}
    lines.append(f"  contention ratio {_fmt(cont.get('ratio'))} "
                 f"(ingest overlap {_fmt(cont.get('ingest_overlap_ms'))}"
                 f" ms of {_fmt(cont.get('queue_wait_ms'))} ms queue "
                 f"wait; busy evidence: "
                 f"{_fmt(cont.get('busy_intervals'))} windows)")
    if qobs.get("slow_queries"):
        lines.append(f"  slow queries {_fmt(qobs['slow_queries'])} "
                     f"(> {_fmt(qobs.get('slo_ms'))} ms; "
                     f"{_fmt(qobs.get('slowlog_evicted'))} evicted)")
        for e in (qobs.get("slowlog") or [])[-5:]:
            lines.append(
                f"    id={e.get('id')} e2e {_fmt(e.get('e2e_ms'))} ms = "
                f"queue {_fmt(e.get('queue_ms'))} + batch "
                f"{_fmt(e.get('batch_ms'))} + dispatch "
                f"{_fmt(e.get('dispatch_ms'))} + reply "
                f"{_fmt(e.get('reply_ms'))}")
    return "\n".join(lines)


def render_serve_diff(a: dict, b: dict) -> str:
    """Two runs' serving segment p50/p99 side by side (B vs A)."""
    lines = ["reach serving diff:",
             f"  A: {a['path']}",
             f"  B: {b['path']}"]
    qa = (a.get("reach_query") or {}).get("query_obs")
    qb = (b.get("reach_query") or {}).get("query_obs")
    if not qa or not qb:
        lines.append("  missing reach_query records in "
                     + ("both runs" if not (qa or qb)
                        else ("A" if not qa else "B")))
        return "\n".join(lines)
    lines.append(f"  {'segment':<10} {'A p50':>12} {'B p50':>12} "
                 f"{'delta':>12} {'A p99':>12} {'B p99':>12}")
    segs = list((qa.get("segments") or {}).keys())
    for extra in (qb.get("segments") or {}):
        if extra not in segs:
            segs.append(extra)
    rows = [(name, (qa.get("segments") or {}).get(name),
             (qb.get("segments") or {}).get(name)) for name in segs]
    rows.append(("e2e", qa.get("e2e_ms"), qb.get("e2e_ms")))
    for name, sa, sb in rows:
        pa, pb = _p50(sa), _p50(sb)
        lines.append(
            f"  {name:<10} {_fmt((sa or {}).get('p50')):>12} "
            f"{_fmt((sb or {}).get('p50')):>12} "
            f"{_fmt(round(pb - pa, 3)):>12} "
            f"{_fmt((sa or {}).get('p99')):>12} "
            f"{_fmt((sb or {}).get('p99')):>12}")
    ca = (qa.get("contention") or {}).get("ratio")
    cb = (qb.get("contention") or {}).get("ratio")
    lines.append(f"  contention ratio: A {_fmt(ca)}  B {_fmt(cb)}")
    ha = ((a.get("reach_query") or {}).get("cache") or {}).get(
        "hit_ratio")
    hb = ((b.get("reach_query") or {}).get("cache") or {}).get(
        "hit_ratio")
    if ha is not None or hb is not None:
        lines.append(f"  cache hit ratio:  A {_fmt(ha)}  B {_fmt(hb)}")
    return "\n".join(lines)


# ----------------------------------------------------------------------
# per-window latency attribution (obs.lifecycle): the "attribution"
# block each snapshot carries, summarized from the run's last word
def summarize_attribution(records: list[dict], path: str = "") -> dict:
    """Pull the newest ``attribution`` block out of one run's records
    (the final record normally carries the complete picture; a torn
    tail falls back to the last intact snapshot)."""
    att = None
    for r in reversed(records):
        if isinstance(r.get("attribution"), dict):
            att = r["attribution"]
            break
    return {"path": path, "attribution": att}


def _p50(summary: "dict | None") -> float:
    v = (summary or {}).get("p50")
    return float(v) if isinstance(v, (int, float)) else 0.0


def render_attribution(s: dict) -> str:
    """One run's segment table: counts, percentiles, and each segment's
    share of the summed p50 — where the window latency actually went."""
    att = s.get("attribution")
    lines = [f"window latency attribution: {s['path'] or '(records)'}"]
    if not att:
        lines.append("  no attribution records "
                     "(run with jax.obs.lifecycle: true)")
        return "\n".join(lines)
    lines.append(f"  writes observed        {_fmt(att.get('writes_observed'))}")
    lines.append(f"  writes untracked       {_fmt(att.get('writes_untracked'))}")
    lines.append(f"  open windows           {_fmt(att.get('open_windows'))}")
    if att.get("windows_evicted"):
        lines.append(f"  windows evicted        "
                     f"{_fmt(att['windows_evicted'])}")
    segs = att.get("segments") or {}
    p50_sum = sum(_p50(v) for v in segs.values())
    lines.append(f"  {'segment':<10} {'count':>8} {'p50_ms':>12} "
                 f"{'p95_ms':>12} {'p99_ms':>12} {'share':>7}")
    for name, summ in segs.items():
        share = (f"{_p50(summ) / p50_sum * 100:.1f}%" if p50_sum else "-")
        lines.append(
            f"  {name:<10} {_fmt(summ.get('count') or 0):>8} "
            f"{_fmt(summ.get('p50')):>12} {_fmt(summ.get('p95')):>12} "
            f"{_fmt(summ.get('p99')):>12} {share:>7}")
    e2e = att.get("e2e_ms") or {}
    lines.append(f"  {'e2e':<10} {_fmt(e2e.get('count') or 0):>8} "
                 f"{_fmt(e2e.get('p50')):>12} {_fmt(e2e.get('p95')):>12} "
                 f"{_fmt(e2e.get('p99')):>12}")
    if _p50(e2e):
        cov = p50_sum / _p50(e2e) * 100
        lines.append(f"  segment p50 sum {p50_sum:,.1f} ms = {cov:.1f}% "
                     "of e2e p50")
    return "\n".join(lines)


def render_attribution_diff(a: dict, b: dict) -> str:
    """Two runs' segment p50/p99 side by side (B vs A) — which stage a
    perf change actually moved."""
    lines = ["attribution diff:",
             f"  A: {a['path']}",
             f"  B: {b['path']}"]
    aa, ab = a.get("attribution") or {}, b.get("attribution") or {}
    if not aa or not ab:
        lines.append("  missing attribution records in "
                     + ("both runs" if not (aa or ab)
                        else ("A" if not aa else "B")))
        return "\n".join(lines)
    lines.append(f"  {'segment':<10} {'A p50':>12} {'B p50':>12} "
                 f"{'delta':>12} {'A p99':>12} {'B p99':>12}")
    segs = list((aa.get("segments") or {}).keys())
    for extra in (ab.get("segments") or {}):
        if extra not in segs:
            segs.append(extra)
    rows = [(name, (aa.get("segments") or {}).get(name),
             (ab.get("segments") or {}).get(name)) for name in segs]
    rows.append(("e2e", aa.get("e2e_ms"), ab.get("e2e_ms")))
    for name, sa, sb in rows:
        pa, pb = _p50(sa), _p50(sb)
        lines.append(
            f"  {name:<10} {_fmt((sa or {}).get('p50')):>12} "
            f"{_fmt((sb or {}).get('p50')):>12} "
            f"{_fmt(round(pb - pa, 3)):>12} "
            f"{_fmt((sa or {}).get('p99')):>12} "
            f"{_fmt((sb or {}).get('p99')):>12}")
    return "\n".join(lines)


def render_diff(a: dict, b: dict) -> str:
    """Two runs side-by-side with absolute + relative deltas (B vs A)."""
    rows = list(_SCALAR_ROWS)
    lines = ["telemetry diff:",
             f"  A: {a['path']}",
             f"  B: {b['path']}",
             f"  {'metric':<22} {'A':>14} {'B':>14} "
             f"{'delta':>14} {'pct':>8}"]

    def emit(label, va, vb):
        delta = pct = None
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            delta = round(vb - va, 3)
            if va:
                pct = f"{(vb - va) / va * 100:+.1f}%"
        lines.append(f"  {label:<22} {_fmt(va):>14} {_fmt(vb):>14} "
                     f"{_fmt(delta):>14} {pct or '-':>8}")

    for label, key in rows:
        emit(label, a.get(key), b.get(key))
    la = dict(_latency_rows(a))
    lb = dict(_latency_rows(b))
    for label in la:
        emit(label, la[label], lb.get(label))
    xa = (a.get("xfer") or {}).get("formats") or {}
    xb = (b.get("xfer") or {}).get("formats") or {}
    for fmt in sorted(set(xa) | set(xb)):
        emit(f"xfer {fmt} B/ev",
             (xa.get(fmt) or {}).get("bytes_per_event"),
             (xb.get(fmt) or {}).get("bytes_per_event"))
    da = a.get("devmem") or {}
    db = b.get("devmem") or {}
    if da or db:
        emit("devmem peak bytes", da.get("peak_footprint_bytes"),
             db.get("peak_footprint_bytes"))
    ska = a.get("sketch") or {}
    skb = b.get("sketch") or {}
    if ska or skb:
        emit("sketch state bytes", ska.get("state_bytes"),
             skb.get("state_bytes"))
        emit("sketch merged pairs", ska.get("merged_pairs"),
             skb.get("merged_pairs"))
    qa = (a.get("reach_query") or {}).get("query_obs") or {}
    qb = (b.get("reach_query") or {}).get("query_obs") or {}
    if qa or qb:
        sa, sb = qa.get("segments") or {}, qb.get("segments") or {}
        for seg in sorted(set(sa) | set(sb)):
            emit(f"reach {seg} p50 ms", (sa.get(seg) or {}).get("p50"),
                 (sb.get(seg) or {}).get("p50"))
        emit("reach contention",
             (qa.get("contention") or {}).get("ratio"),
             (qb.get("contention") or {}).get("ratio"))
    ta, tb = a.get("tenants") or {}, b.get("tenants") or {}
    for name in sorted(set(ta) | set(tb)):
        emit(f"tenant {name} events", (ta.get(name) or {}).get("events"),
             (tb.get(name) or {}).get("events"))
    ma, mb = a.get("multitenant") or {}, b.get("multitenant") or {}
    if ma or mb:
        wa, wb = ma.get("wait_ms") or {}, mb.get("wait_ms") or {}
        for name in sorted(set(wa) | set(wb)):
            emit(f"tenant {name} wait ms", wa.get(name), wb.get(name))
        emit("blame offdiag ratio", ma.get("offdiag_ratio"),
             mb.get("offdiag_ratio"))
    fault_keys = sorted(set(a["faults"]) | set(b["faults"]))
    for k in fault_keys:
        emit(f"fault {k}", a["faults"].get(k, 0), b["faults"].get(k, 0))
    stage_keys = sorted(set(a["stages"]) | set(b["stages"]))
    for k in stage_keys:
        emit(f"stage {k} ms", (a["stages"].get(k) or {}).get("ms", 0),
             (b["stages"].get(k) or {}).get("ms", 0))
    return "\n".join(lines)
