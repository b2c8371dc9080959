"""Fleet observability: metrics federation + cross-process trace
stitching.

The port's copy of ``streambench_tpu/obs/fleet.py`` (read-side host
code, no torch): the same merge, summary, table and trace stitching, so
a fleet of port processes renders exactly as the JAX package's does.

Since the reach tier scaled out, one "run" is a FLEET — an engine
writer, a snapshot shipper, N replica processes, pub/sub clients,
supervisor-restarted children — and each process journals its own
``metrics.jsonl`` and dumps its own ``trace_<pid>.json``.  Nothing
spans them.  This module is the spanning instrument:

- :class:`FleetCollector` tails every role's ``metrics.jsonl``
  (reusing ``load_records``' rotation stitch, so a rotated writer
  journal is covered end to end) into ONE ``fleet.jsonl`` whose every
  record carries ``role``/``pid`` attribution, merged in ``ts_ms``
  order;
- :func:`summarize_fleet` folds the merged stream into a per-role
  table — ingest rate, qps, cache hit ratio, staleness, freshness
  hops, restarts — rendered by ``python -m streambench_tpu_torch.obs
  fleet``;
- :func:`merge_traces` folds every role's Chrome trace file into one
  perfetto-loadable document: per-file clocks are aligned on the
  recorded ``wall0_ms`` epochs, real pids keep the lanes apart, and
  ``process_name`` metadata names each lane — writer folds and replica
  query batches sit on one timeline.

Like every obs layer: read-side only, nothing here runs unless asked.
"""

from __future__ import annotations

import json
import os

#: the merged-journal filename the collector writes
FLEET_LOG = "fleet.jsonl"


def _role_of(path: str, records: list) -> str:
    """Role attribution for one journal: the records' own ``role``
    stamp wins (MetricsSampler writes it), else the journal's parent
    directory name — good enough for ``<fleetdir>/<role>/metrics.jsonl``
    layouts."""
    for r in records:
        role = r.get("role")
        if isinstance(role, str) and role:
            return role
    parent = os.path.basename(os.path.dirname(os.path.abspath(path)))
    return parent or "unknown"


def parse_role_spec(spec: str) -> tuple:
    """``role=path`` or a bare path -> (role | None, path)."""
    if "=" in spec and not os.path.exists(spec):
        role, _, path = spec.partition("=")
        return role.strip() or None, path.strip()
    return None, spec


class FleetCollector:
    """Merge every role's ``metrics.jsonl`` into one attributed stream.

    ``roles`` is a list of ``(role_or_None, path)`` pairs; a ``None``
    role is inferred from the records / directory name.  ``collect()``
    re-reads every journal (rotation-stitched), attributes, merges by
    ``ts_ms``, optionally writes ``fleet.jsonl``, and returns the
    merged record list — cheap enough to run per report; an always-on
    tailer would be a daemon this repo doesn't need yet.
    """

    def __init__(self, roles: list, out_path: "str | None" = None):
        self.roles = [tuple(r) for r in roles]
        self.out_path = out_path
        self.sources: list[dict] = []   # per-source read stats

    def collect(self) -> list[dict]:
        from streambench_tpu_torch.obs.report import load_records

        self.sources = []
        merged: list[dict] = []
        for role, path in self.roles:
            try:
                records = load_records(path)   # stitches <path>.1 first
            except OSError as e:
                self.sources.append({"role": role, "path": path,
                                     "error": repr(e), "records": 0})
                continue
            role = role or _role_of(path, records)
            for r in records:
                out = dict(r)
                out["role"] = role
                out.setdefault("pid", None)
                merged.append(out)
            self.sources.append({"role": role, "path": path,
                                 "records": len(records)})
        merged.sort(key=lambda r: (r.get("ts_ms") or 0))
        if self.out_path:
            tmp = self.out_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for r in merged:
                    f.write(json.dumps(r) + "\n")
            os.replace(tmp, self.out_path)
        return merged


# ----------------------------------------------------------------------
# per-role summary + rendering (the `obs fleet` table)
def summarize_fleet(records: list[dict], path: str = "") -> dict:
    """Fold an attributed record stream into per-(role, pid) rows.

    Columns are the fleet health set: ingest rate
    (writer), qps / cache hit ratio / staleness / freshness hop p99s
    (any serving role), restart count (supervisor annotations), plus
    the clock-offset evidence when a replica estimated one."""
    by_role: dict = {}
    for r in records:
        role = r.get("role") or "unknown"
        key = (role, r.get("pid"))
        agg = by_role.setdefault(key, {
            "role": role, "pid": r.get("pid"), "snapshots": 0,
            "restarts": 0, "events": None, "events_per_s_mean": None,
            "_rates": [],
        })
        kind = r.get("kind")
        if kind == "event":
            # "restart" = the writer supervisor's annotation; "replica_
            # restart" = the fleet supervisor respawning a replica
            # process — one restart column covers both roles
            if r.get("event") in ("restart", "replica_restart"):
                agg["restarts"] += 1
            # controller decisions: a journal that carries
            # only the event stream (no summary snapshot yet) still
            # renders a decision count + the last verdict/knob
            if r.get("event") == "autoscale_decision":
                a = agg.setdefault("autoscale", {})
                a["decisions"] = a.get("decisions", 0) + 1
                a["last"] = {k: r.get(k) for k in
                             ("decision", "verdict", "knob",
                              "replicas")}
            continue
        if kind not in ("snapshot", "final"):
            continue
        agg["snapshots"] += 1
        if isinstance(r.get("events"), (int, float)):
            agg["events"] = r["events"]
        eps = r.get("events_per_s")
        if isinstance(eps, (int, float)) and eps > 0:
            agg["_rates"].append(eps)
        rq = r.get("reach_query")
        if isinstance(rq, dict):
            agg["qps"] = rq.get("qps")
            agg["served"] = rq.get("served")
            agg["shed"] = rq.get("shed")
            agg["plane_epoch"] = rq.get("plane_epoch")
            agg["staleness_ms"] = rq.get("staleness_ms")
            cache = rq.get("cache")
            if isinstance(cache, dict):
                agg["cache_hit_ratio"] = cache.get("hit_ratio")
            fr = rq.get("freshness")
            if isinstance(fr, dict):
                agg["freshness_p99_ms"] = {
                    hop: (s or {}).get("p99")
                    for hop, s in (fr.get("hops") or {}).items()}
                agg["freshness_high_water_ms"] = fr.get("high_water_ms")
        # router journal: the fronting router's sampler
        # writes rec["router"] = ReachRouter.summary() — folded into
        # the same serving columns (routed qps, answered as served) so
        # the router reads as one more row of the fleet table, plus
        # its own failover/shed evidence as a sub-line
        rt = r.get("router")
        if isinstance(rt, dict):
            agg["qps"] = rt.get("qps")
            agg["served"] = rt.get("answered")
            agg["shed"] = rt.get("shed")
            agg["router"] = {
                "routed": rt.get("routed"),
                "failovers": rt.get("failovers"),
                "shed_ratio": rt.get("shed_ratio"),
                "failover_p99_ms": rt.get("failover_p99_ms"),
                "replicas": len(rt.get("replicas") or ()),
                "suspect": sum(1 for h in (rt.get("replicas") or ())
                               if isinstance(h, dict)
                               and h.get("suspect")),
            }
        # autoscale controller: the controller's sampler
        # journals rec["autoscale"] = AutoscaleController.summary();
        # the snapshot's counts override the event-derived ones (they
        # are authoritative) and feed the controller sub-line
        asc = r.get("autoscale")
        if isinstance(asc, dict):
            a = agg.setdefault("autoscale", {})
            for k2 in ("replicas", "decisions", "scale_ups",
                       "scale_downs", "ship_tunes", "poll_tunes",
                       "holds", "shed_redirects"):
                if asc.get(k2) is not None:
                    a[k2] = asc[k2]
            last = asc.get("last")
            if isinstance(last, dict):
                a["last"] = {k2: last.get(k2) for k2 in
                             ("decision", "verdict", "knob",
                              "replicas")}
        # shipper cost: the writer's sampler journals
        # rec["ship"] = SnapshotShipper/DeltaShipper.summary() — the
        # per-tick bytes/rows/ms evidence the delta path is judged by,
        # rendered as a ship sub-line under the writer row
        sp = r.get("ship")
        if isinstance(sp, dict):
            agg["ship"] = {k2: sp.get(k2) for k2 in
                           ("mode", "ships", "bytes_per_tick",
                            "rows_per_tick", "ship_ms_per_tick",
                            "bytes_total", "bases", "deltas",
                            "cutovers")}
        # chaos fault counters: any role may journal its
        # injector's snapshot under "faults"; the net_faults column is
        # the fleet-wide message-fault evidence next to restarts
        faults = r.get("faults")
        if isinstance(faults, dict):
            n = faults.get("net_faults")
            if isinstance(n, (int, float)):
                agg["net_faults"] = int(n)
        clock = r.get("clock")
        if isinstance(clock, dict):
            agg["clock"] = {k: clock.get(k) for k in
                            ("offset_ms", "uncertainty_ms", "applied")}
        # multi-tenant host: the host's sampler journals a
        # per-tenant block (rec["tenants"]), per-tenant burn gauges
        # (rec["slo_tenants"]), the device-time ledger's blame matrix
        # (rec["multitenant"]) and the admission controller's summary
        # (rec["admission"]) — folded into one tenant sub-table under
        # the host row, last snapshot wins like the other columns
        tn = r.get("tenants")
        if isinstance(tn, dict):
            tens = agg.setdefault("tenants", {})
            for name, t in tn.items():
                if not isinstance(t, dict):
                    continue
                row = tens.setdefault(name, {})
                row["kind"] = t.get("kind")
                for k2 in ("events", "events_per_s", "queued_batches",
                           "folded_batches", "dropped_batches"):
                    if t.get(k2) is not None:
                        row[k2] = t[k2]
        st = r.get("slo_tenants")
        if isinstance(st, dict):
            tens = agg.setdefault("tenants", {})
            for name, s in st.items():
                if not isinstance(s, dict):
                    continue
                row = tens.setdefault(name, {})
                fast = [b.get("fast") for b in (s.get("burn") or
                                                {}).values()
                        if isinstance(b, dict)
                        and isinstance(b.get("fast"), (int, float))]
                if fast:
                    row["burn_fast"] = round(max(fast), 2)
                row["in_breach"] = s.get("in_breach")
        mt = r.get("multitenant")
        if isinstance(mt, dict):
            tens = agg.setdefault("tenants", {})
            for name in (mt.get("tenants") or ()):
                row = tens.setdefault(name, {})
                row["busy_ms"] = (mt.get("busy_ms") or {}).get(name)
                row["wait_ms"] = (mt.get("wait_ms") or {}).get(name)
            agg["blame"] = {
                "matrix_ms": mt.get("matrix_ms"),
                "offdiag_ratio": mt.get("offdiag_ratio"),
                "partition_ok": (mt.get("partition") or {}).get("ok"),
            }
        adm = r.get("admission")
        if isinstance(adm, dict):
            agg["admission"] = {k2: adm.get(k2) for k2 in
                                ("defers", "sheds", "releases", "holds",
                                 "batches_deferred", "batches_shed",
                                 "gates", "last")}
        # Kafka delivery ledger: any role ingesting through
        # the Kafka adapter journals rec["kafka"] (kafka_collector) —
        # last snapshot wins, rendered as a sub-line under the row
        kf = r.get("kafka")
        if isinstance(kf, dict):
            agg["kafka"] = {k2: kf.get(k2) for k2 in
                            ("produced", "delivered", "redeliveries",
                             "produce_retries", "consume_retries",
                             "broker_down_ms", "consumer_lag")}
    rows = []
    for agg in by_role.values():
        rates = agg.pop("_rates")
        if rates:
            agg["events_per_s_mean"] = round(sum(rates) / len(rates), 1)
        rows.append(agg)
    rows.sort(key=lambda a: (a["role"], a["pid"] or 0))
    return {"path": path, "records": len(records),
            "processes": len(rows), "roles": rows}


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:,.1f}"
    if isinstance(v, int):
        return f"{v:,}"
    return str(v)


def render_fleet(s: dict) -> str:
    lines = [f"fleet report: {s['path'] or '(records)'}",
             f"  {s['processes']} process(es), {s['records']} records",
             f"  {'role':<10} {'pid':>8} {'ev/s':>10} {'qps':>8} "
             f"{'hit%':>6} {'stale ms':>9} {'epoch':>6} {'restarts':>8} "
             f"{'netflt':>6}"]
    for a in s["roles"]:
        hit = a.get("cache_hit_ratio")
        lines.append(
            f"  {a['role']:<10} {_fmt(a.get('pid')):>8} "
            f"{_fmt(a.get('events_per_s_mean')):>10} "
            f"{_fmt(a.get('qps')):>8} "
            f"{(f'{hit * 100:.0f}%' if isinstance(hit, (int, float)) else '-'):>6} "
            f"{_fmt(a.get('staleness_ms')):>9} "
            f"{_fmt(a.get('plane_epoch')):>6} "
            f"{_fmt(a.get('restarts')):>8} "
            f"{_fmt(a.get('net_faults')):>6}")
        rt = a.get("router")
        if rt:
            ratio = rt.get("shed_ratio")
            ratio_s = (f"{ratio:.3f}"
                       if isinstance(ratio, (int, float)) else "-")
            lines.append(
                f"    router: routed {_fmt(rt.get('routed'))}  "
                f"failovers {_fmt(rt.get('failovers'))}  "
                f"shed_ratio {ratio_s}  "
                f"failover p99 {_fmt(rt.get('failover_p99_ms'))} ms  "
                f"replicas {_fmt(rt.get('replicas'))} "
                f"({_fmt(rt.get('suspect'))} suspect)")
        asc = a.get("autoscale")
        if asc:
            last = asc.get("last") or {}
            last_s = (f"{last.get('decision')}"
                      f"[{last.get('verdict')}->{last.get('knob')}]"
                      if last.get("decision") else "-")
            lines.append(
                f"    autoscale: replicas {_fmt(asc.get('replicas'))}  "
                f"decisions {_fmt(asc.get('decisions'))} "
                f"(up {_fmt(asc.get('scale_ups'))}, "
                f"down {_fmt(asc.get('scale_downs'))}, "
                f"ship {_fmt(asc.get('ship_tunes'))})  "
                f"holds {_fmt(asc.get('holds'))}  "
                f"redirects {_fmt(asc.get('shed_redirects'))}  "
                f"last {last_s}")
        sp = a.get("ship")
        if sp:
            chain = ""
            if sp.get("deltas") is not None:
                chain = (f"  bases {_fmt(sp.get('bases'))}  "
                         f"deltas {_fmt(sp.get('deltas'))}  "
                         f"cutovers {_fmt(sp.get('cutovers'))}")
            lines.append(
                f"    ship[{sp.get('mode') or 'full'}]: "
                f"ships {_fmt(sp.get('ships'))}  "
                f"bytes/tick {_fmt(sp.get('bytes_per_tick'))}  "
                f"rows/tick {_fmt(sp.get('rows_per_tick'))}  "
                f"ms/tick {_fmt(sp.get('ship_ms_per_tick'))}{chain}")
        kf = a.get("kafka")
        if kf:
            lines.append(
                f"    kafka: produced {_fmt(kf.get('produced'))}  "
                f"delivered {_fmt(kf.get('delivered'))}  "
                f"redeliveries {_fmt(kf.get('redeliveries'))}  "
                f"retries {_fmt(kf.get('produce_retries'))}/"
                f"{_fmt(kf.get('consume_retries'))}  "
                f"lag {_fmt(kf.get('consumer_lag'))}")
        fr = a.get("freshness_p99_ms")
        if fr:
            hops = "  ".join(f"{hop} {_fmt(fr.get(hop))}"
                             for hop in ("fold_lag", "ship_wait",
                                         "tail_lag", "serve", "total"))
            lines.append(f"    freshness p99 (ms): {hops}")
        clock = a.get("clock")
        if clock:
            lines.append(
                f"    clock offset {_fmt(clock.get('offset_ms'))} ms "
                f"+-{_fmt(clock.get('uncertainty_ms'))} "
                f"({'applied' if clock.get('applied') else 'NOT applied'})")
        tens = a.get("tenants")
        if tens:
            adm = a.get("admission") or {}
            gates = adm.get("gates") or {}
            lines.append(
                f"    {'tenant':<8} {'kind':<8} {'events':>10} "
                f"{'folded':>7} {'queued':>7} {'busy ms':>11} "
                f"{'wait ms':>11} {'burn':>6} {'gate':>6}")
            for name in sorted(tens):
                t = tens[name]
                gate = gates.get(name)
                if isinstance(gate, dict):
                    gate = gate.get("mode")
                lines.append(
                    f"    {name:<8} {t.get('kind') or '-':<8} "
                    f"{_fmt(t.get('events')):>10} "
                    f"{_fmt(t.get('folded_batches')):>7} "
                    f"{_fmt(t.get('queued_batches')):>7} "
                    f"{_fmt(t.get('busy_ms')):>11} "
                    f"{_fmt(t.get('wait_ms')):>11} "
                    f"{_fmt(t.get('burn_fast')):>6} "
                    f"{gate or '-':>6}")
            bl = a.get("blame")
            if bl and bl.get("offdiag_ratio") is not None:
                ok = bl.get("partition_ok")
                lines.append(
                    f"    blame offdiag {_fmt(bl['offdiag_ratio'])}  "
                    f"partition {'ok' if ok else 'FAIL' if ok is False else '-'}")
            if adm:
                last = adm.get("last") or {}
                last_s = (f"{last.get('decision')}"
                          f"[{last.get('tenant')}->"
                          f"{last.get('victim')}]"
                          if last.get("decision") else "-")
                lines.append(
                    f"    admission: defers {_fmt(adm.get('defers'))}  "
                    f"sheds {_fmt(adm.get('sheds'))}  "
                    f"releases {_fmt(adm.get('releases'))}  "
                    f"deferred {_fmt(adm.get('batches_deferred'))}  "
                    f"shed {_fmt(adm.get('batches_shed'))}  "
                    f"last {last_s}")
    return "\n".join(lines)


def discover_roles(directory: str) -> list:
    """``(role, path)`` pairs under one fleet directory: a top-level
    ``metrics.jsonl`` plus every ``<sub>/metrics.jsonl`` one level
    down (the writer-workdir + per-replica-subdir layout the CI fleet
    leg uses)."""
    out = []
    top = os.path.join(directory, "metrics.jsonl")
    if os.path.exists(top):
        out.append((None, top))
    for name in sorted(os.listdir(directory)):
        p = os.path.join(directory, name, "metrics.jsonl")
        if os.path.isdir(os.path.join(directory, name)) \
                and os.path.exists(p):
            out.append((None, p))
    return out


# ----------------------------------------------------------------------
# cross-process trace stitching (`obs trace --merge`)
def merge_traces(inputs: list, run: str = "fleet") -> dict:
    """Fold per-process Chrome trace files into one document.

    ``inputs``: ``(role_or_None, path)`` pairs.  Every SpanTracer dump
    stamps ``otherData.wall0_ms`` — the wall-clock epoch its relative
    ``ts`` values are measured from — so aligning clocks is exact up to
    wall-clock skew between the processes: each file's events shift by
    ``(wall0_ms - min(wall0_ms)) * 1000`` µs.  Events keep their real
    pids (distinct per process), and one ``process_name`` metadata
    event per file names the lane, which is exactly what perfetto
    needs to draw writer folds above replica query batches on one
    timeline."""
    events: list[dict] = []
    meta = []
    docs = []
    for role, path in inputs:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        wall0 = (doc.get("otherData") or {}).get("wall0_ms")
        docs.append((role or os.path.splitext(
            os.path.basename(path))[0], path, doc,
            float(wall0) if isinstance(wall0, (int, float)) else None))
    known = [w for _, _, _, w in docs if w is not None]
    base = min(known) if known else 0.0
    # tenant lanes: N tenants in ONE process dump N trace
    # files sharing one real pid, which would merge their lanes and
    # let the last process_name win.  When a later file claims a pid
    # an earlier file already used, remap its events onto a synthetic
    # pid (deterministic per file order) so every role/tenant keeps a
    # named lane of its own.
    claimed: dict = {}
    for fi, (role, path, doc, wall0) in enumerate(docs):
        shift_us = ((wall0 - base) * 1000.0) if wall0 is not None else 0.0
        remap: dict = {}
        pids = set()
        for ev in doc.get("traceEvents", []):
            if not isinstance(ev, dict):
                continue
            out = dict(ev)
            if out.get("ph") == "X":
                out["ts"] = round(float(out.get("ts", 0)) + shift_us, 3)
            pid = out.get("pid")
            if pid is not None:
                if pid not in remap:
                    owner = claimed.setdefault(pid, fi)
                    remap[pid] = (pid if owner == fi
                                  else pid * 1000 + fi)
                out["pid"] = remap[pid]
            pids.add(out.get("pid"))
            events.append(out)
        for pid in sorted(p for p in pids if p is not None):
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"name": role}})
        meta.append({"role": role, "path": os.path.basename(path),
                     "wall0_ms": wall0,
                     "shift_us": round(shift_us, 3)})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"run": run, "merged": meta,
                      "wall0_ms": base, "processes": len(docs)},
    }


def trace_process_names(doc: dict) -> dict:
    """{pid: process_name} out of a merged trace (validation helper)."""
    out = {}
    for ev in doc.get("traceEvents", []):
        if (isinstance(ev, dict) and ev.get("ph") == "M"
                and ev.get("name") == "process_name"):
            out[ev.get("pid")] = (ev.get("args") or {}).get("name")
    return out
