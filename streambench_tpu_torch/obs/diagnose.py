"""Fleet diagnosis engine: from measured fleet evidence to a ranked
list of named bottleneck verdicts.

The port's copy of ``streambench_tpu/obs/diagnose.py`` (pure host code,
no torch).  The obs layers provide the instruments — SLO burn rates, the ingest/query
contention ratio, per-reply freshness hops that decompose a reply's
evidence age into ``fold_lag/ship_wait/tail_lag/serve`` — but reading
them has stayed a human postmortem.  This module makes the reading
executable and PURE: :func:`evidence_window` folds a window of
attributed fleet records (live ``FleetCollector.collect()`` output or
a replayed ``fleet.jsonl``) into one flat evidence dict, and
:func:`diagnose` maps that dict to verdicts, each carrying the measured
evidence that justifies it and the knob the verdict-to-knob mapping
prescribes:

- ``fold_lag``   -> ship cadence (``SnapshotShipper.interval_ms``).
  A staleness breach whose age does NOT sit in the tailer is
  cadence/ingest starvation upstream of the replica.  NOTE the hop
  physics: a slow ship cadence mostly ages the record
  *while it serves* — the growth lands in the ``serve`` hop, not in
  ``fold_lag`` — so the rule keys on the breach minus tail dominance,
  not on the ``fold_lag`` hop alone.
- ``tail_lag``   -> replica poll interval (``ReachReplica.poll_ms``),
  when the tail hop dominates the breached staleness: the record was
  shipped promptly and sat in the log waiting for the tailer.
- ``serve``      -> replica count, on ``overloaded`` sheds or a p99
  breach without contention evidence: the fleet is out of serving
  capacity, not out of fresh evidence.
- ``contention`` -> batch/drain cadence, when the queue segment
  dominates a p99 breach AND the measured ingest-contention ratio says
  the queue wait was spent behind ingest dispatches.
- ``healthy``    -> no knob: every objective holds in this window.

No side effects, no clocks, no I/O — the unit tests table-drive it
with synthetic journals, and :class:`~streambench_tpu_torch.obs.autoscale.
AutoscaleController` is just this function on a cadence.
"""

from __future__ import annotations

#: verdict names (the bottleneck families the mapping names)
VERDICT_FOLD = "fold_lag"
VERDICT_TAIL = "tail_lag"
VERDICT_SERVE = "serve"
VERDICT_CONTENTION = "contention"
VERDICT_TENANT = "tenant_interference"
VERDICT_HEALTHY = "healthy"

#: knob names (what the controller actuates)
KNOB_SHIP = "ship_cadence"
KNOB_POLL = "poll_interval"
KNOB_REPLICAS = "replica_count"
KNOB_BATCH = "batch_cadence"
KNOB_ADMISSION = "admission"

KNOB_FOR = {
    VERDICT_FOLD: KNOB_SHIP,
    VERDICT_TAIL: KNOB_POLL,
    VERDICT_SERVE: KNOB_REPLICAS,
    VERDICT_CONTENTION: KNOB_BATCH,
    VERDICT_TENANT: KNOB_ADMISSION,
    VERDICT_HEALTHY: None,
}

#: the tail hop must carry at least this share of the breached
#: staleness (and top the other pipeline hops) before the poll knob is
#: blamed — below it, the age accrued upstream of the tailer
TAIL_DOMINANCE_SHARE = 0.35

#: queue-wait counts as contention-bound only when the measured
#: ingest-overlap ratio says at least this fraction of it was spent
#: behind ingest dispatches (streambench_reach_contention_ratio)
CONTENTION_RATIO_MIN = 0.5


def _num(v):
    return float(v) if isinstance(v, (int, float)) else None


def _nmax(a, b):
    if b is None:
        return a
    return b if a is None else max(a, b)


def evidence_window(records: list) -> dict:
    """Fold one window of attributed fleet records into a flat
    evidence dict.

    ``records`` is FleetCollector output (live or replayed from
    ``fleet.jsonl``): dicts with ``kind`` / ``role`` / ``pid`` and the
    per-role payload blocks (``reach_query``, ``router``,
    ``reach_ship``, ``slo``).  Per (role, pid) the LATEST snapshot
    wins; gauges (staleness, p99, hop p99s, queue depth) max-merge
    across serving rows, counters (served/shed/...) sum — the window is
    the fleet's worst case plus its total work.  Counters stay
    CUMULATIVE; :func:`diagnose` differences them against a previous
    window."""
    rq_by: dict = {}
    router = None
    ship = None
    slo = None
    multitenant = None
    slo_tenants: dict = {}
    ts = 0
    for r in records:
        if not isinstance(r, dict):
            continue
        t = r.get("ts_ms")
        if isinstance(t, (int, float)):
            ts = max(ts, int(t))
        if r.get("kind") not in ("snapshot", "final"):
            continue
        rq = r.get("reach_query")
        if isinstance(rq, dict):
            rq_by[(r.get("role"), r.get("pid"))] = rq
        rt = r.get("router")
        if isinstance(rt, dict):
            router = rt
        sh = r.get("reach_ship")
        if isinstance(sh, dict):
            ship = sh
        sl = r.get("slo")
        if isinstance(sl, dict):
            slo = sl
        # multi-tenant evidence: the host's blame-matrix
        # block and the nested per-tenant SLO blocks — latest wins,
        # per tenant for the SLO map
        mt = r.get("multitenant")
        if isinstance(mt, dict):
            multitenant = mt
        st = r.get("slo_tenants")
        if isinstance(st, dict):
            for name, b in st.items():
                if isinstance(b, dict):
                    slo_tenants[str(name)] = b
    w: dict = {"ts_ms": ts, "replicas": len(rq_by),
               "staleness_ms": None, "p99_ms": None, "qps": 0.0,
               "served": 0, "shed": 0, "shed_stale": 0,
               "queue_high_water": None, "hop_p99_ms": {},
               "contention_ratio": None, "segment_p99_ms": {}}
    for rq in rq_by.values():
        w["staleness_ms"] = _nmax(w["staleness_ms"],
                                  _num(rq.get("staleness_ms")))
        w["p99_ms"] = _nmax(w["p99_ms"], _num(rq.get("p99_ms")))
        w["qps"] += _num(rq.get("qps")) or 0.0
        w["served"] += int(rq.get("served") or 0)
        w["shed"] += int(rq.get("shed") or 0)
        w["shed_stale"] += int(rq.get("shed_stale") or 0)
        w["queue_high_water"] = _nmax(w["queue_high_water"],
                                      _num(rq.get("queue_high_water")))
        fr = rq.get("freshness")
        if isinstance(fr, dict):
            for hop, h in (fr.get("hops") or {}).items():
                p = _num((h or {}).get("p99"))
                if p is not None:
                    w["hop_p99_ms"][hop] = max(
                        w["hop_p99_ms"].get(hop, 0.0), p)
        qo = rq.get("query_obs")
        if isinstance(qo, dict):
            ratio = _num((qo.get("contention") or {}).get("ratio"))
            w["contention_ratio"] = _nmax(w["contention_ratio"], ratio)
            for seg, h in (qo.get("segments") or {}).items():
                p = _num((h or {}).get("p99"))
                if p is not None:
                    w["segment_p99_ms"][seg] = max(
                        w["segment_p99_ms"].get(seg, 0.0), p)
    w["shed_overloaded"] = max(w["shed"] - w["shed_stale"], 0)
    if router is not None:
        w["router_routed"] = int(router.get("routed") or 0)
        w["router_answered"] = int(router.get("answered") or 0)
        w["router_shed"] = int(router.get("shed") or 0)
        w["router_failovers"] = int(router.get("failovers") or 0)
        w["router_replicas"] = len(router.get("replicas") or ())
        # the fleet's front-door latency: a serialized single-replica
        # handle queues AT THE ROUTER — no replica's own submit->reply
        # percentiles ever see that wait, so the router's recent-window
        # e2e p99 is the latency evidence the serve verdict needs
        w["router_e2e_p99_ms"] = _num(router.get("e2e_p99_ms"))
        w["p99_ms"] = _nmax(w["p99_ms"], w["router_e2e_p99_ms"])
    if ship is not None:
        w["ship_interval_ms"] = _num(ship.get("interval_ms"))
        w["ships"] = int(ship.get("ships") or 0)
    if slo is not None:
        burns = [b for b in (slo.get("burn") or {}).values()
                 if isinstance(b, (int, float))]
        if burns:
            w["slo_burn_max"] = max(burns)
    if slo_tenants:
        w["tenant_burn"] = {}
        w["tenant_in_breach"] = []
        for name in sorted(slo_tenants):
            b = slo_tenants[name]
            vals = [v for wins in (b.get("burn") or {}).values()
                    if isinstance(wins, dict)
                    for v in wins.values()
                    if isinstance(v, (int, float))]
            w["tenant_burn"][name] = max(vals) if vals else 0.0
            if b.get("in_breach"):
                w["tenant_in_breach"].append(name)
    if multitenant is not None:
        w["blame_offdiag_ratio"] = _num(
            multitenant.get("offdiag_ratio"))
        w["blame_matrix_ms"] = dict(
            multitenant.get("matrix_ms") or {})
    return w


def _delta(window: dict, prev, key: str) -> int:
    cur = int(window.get(key) or 0)
    if not isinstance(prev, dict):
        return cur
    return max(cur - int(prev.get(key) or 0), 0)


def diagnose(window: dict, *, objective: dict,
             prev: "dict | None" = None) -> list:
    """Rank the window's bottlenecks.  Pure: (evidence, objective) ->
    verdicts, most severe first.

    ``objective``: ``{"staleness_ms": ..., "p99_ms": ...}`` (either
    optional).  ``prev``: an earlier :func:`evidence_window` over the
    same fleet — counters are differenced against it so a historic shed
    burst can't breach forever; without it the cumulative counts stand.

    Returns ``[{"verdict", "knob", "score", "why", "evidence"}, ...]``
    — never empty: a window breaching nothing is one
    ``healthy``/no-knob verdict."""
    stale_limit = _num(objective.get("staleness_ms"))
    p99_limit = _num(objective.get("p99_ms"))
    staleness = _num(window.get("staleness_ms"))
    p99 = _num(window.get("p99_ms"))
    hops = dict(window.get("hop_p99_ms") or {})
    d_stale = _delta(window, prev, "shed_stale")
    d_over = _delta(window, prev, "shed_overloaded")
    d_router_shed = _delta(window, prev, "router_shed")
    evidence = {
        "staleness_ms": staleness, "p99_ms": p99,
        "qps": round(float(window.get("qps") or 0.0), 1),
        "hop_p99_ms": hops,
        "shed_stale": d_stale, "shed_overloaded": d_over,
        "router_shed": d_router_shed,
        "contention_ratio": window.get("contention_ratio"),
        "replicas": window.get("replicas"),
        "objective": dict(objective),
    }
    out: list = []

    # -- staleness breaches: the pipeline knobs ------------------------
    stale_breach = (stale_limit is not None and staleness is not None
                    and staleness > stale_limit)
    if stale_breach or d_stale > 0:
        sev = ((staleness / stale_limit)
               if stale_breach and stale_limit else 1.0)
        sev += min(d_stale / 10.0, 1.0)
        tail = hops.get("tail_lag")
        rest = max(hops.get("fold_lag") or 0.0,
                   hops.get("ship_wait") or 0.0)
        age = staleness if staleness is not None else sum(
            v for v in hops.values() if v is not None) or None
        tail_bound = (tail is not None and age and tail >= rest
                      and tail / age >= TAIL_DOMINANCE_SHARE)
        if tail_bound:
            out.append({
                "verdict": VERDICT_TAIL, "knob": KNOB_POLL,
                "score": round(sev, 3),
                "why": (f"staleness {staleness} breaches "
                        f"{stale_limit} ms and the tail_lag hop p99 "
                        f"({tail} ms) dominates: the record shipped "
                        "promptly and waited on the tailer"),
                "evidence": evidence})
        else:
            out.append({
                "verdict": VERDICT_FOLD, "knob": KNOB_SHIP,
                "score": round(sev, 3),
                "why": (f"staleness {staleness} breaches "
                        f"{stale_limit} ms with no tail dominance: the "
                        "evidence aged upstream of the tailer "
                        "(ship/fold cadence starvation)"),
                "evidence": evidence})

    # -- capacity breaches: serve vs contention ------------------------
    lat_breach = (p99_limit is not None and p99 is not None
                  and p99 > p99_limit)
    if lat_breach or d_over > 0:
        sev = 1.0 + min(d_over / 10.0, 2.0)
        if lat_breach and p99_limit:
            sev += max(p99 / p99_limit - 1.0, 0.0)
        ratio = _num(window.get("contention_ratio"))
        segs = window.get("segment_p99_ms") or {}
        queue_p99 = _num(segs.get("queue"))
        queue_dom = (queue_p99 is not None and segs
                     and queue_p99 >= max(
                         (v for k, v in segs.items() if k != "queue"),
                         default=0.0))
        if (lat_breach and queue_dom and ratio is not None
                and ratio >= CONTENTION_RATIO_MIN):
            out.append({
                "verdict": VERDICT_CONTENTION, "knob": KNOB_BATCH,
                "score": round(sev + ratio, 3),
                "why": (f"p99 {p99} breaches {p99_limit} ms, the queue "
                        f"segment dominates and contention_ratio "
                        f"{ratio} says the wait was spent behind "
                        "ingest dispatches"),
                "evidence": evidence})
        else:
            out.append({
                "verdict": VERDICT_SERVE, "knob": KNOB_REPLICAS,
                "score": round(sev, 3),
                "why": (f"{d_over} overloaded sheds / p99 "
                        f"{p99} vs {p99_limit} ms without contention "
                        "evidence: serving capacity, not freshness"),
                "evidence": evidence})

    # -- tenant interference: the admission knob ------------------------
    t_burn = dict(window.get("tenant_burn") or {})
    in_breach = list(window.get("tenant_in_breach") or ())
    matrix = window.get("blame_matrix_ms") or {}
    victims = in_breach or sorted(
        (t for t, b in t_burn.items() if b >= 1.0),
        key=lambda t: -t_burn[t])
    if victims and matrix:
        # the highest-burn breaching victim with cross-tenant blame
        # evidence names the aggressor; a tenant burning its own budget
        # (empty off-diagonal row) stays with the capacity verdicts
        victim = max(victims, key=lambda t: t_burn.get(t, 1.0))
        row = matrix.get(victim) or {}
        best = None
        for aggressor, ms in row.items():
            if aggressor == victim or not isinstance(ms, (int, float)):
                continue
            if ms > 0 and (best is None or ms > best[1]):
                best = (aggressor, ms)
        if best is not None:
            aggressor, blame_ms = best
            burn = t_burn.get(victim, 1.0)
            evidence = dict(evidence)
            evidence["tenant_burn"] = t_burn
            evidence["blame_row_ms"] = row
            evidence["blame_offdiag_ratio"] = window.get(
                "blame_offdiag_ratio")
            out.append({
                "verdict": VERDICT_TENANT, "knob": KNOB_ADMISSION,
                "score": round(1.0 + burn + min(blame_ms / 1e3, 2.0), 3),
                "victim": victim, "aggressor": aggressor,
                "why": (f"tenant {victim!r} burns its budget at "
                        f"{burn}x while {aggressor!r} held the device "
                        f"for {blame_ms} ms of its measured wait — "
                        "gate the aggressor's ingest"),
                "evidence": evidence})

    if not out:
        out.append({"verdict": VERDICT_HEALTHY, "knob": None,
                    "score": 0.0,
                    "why": "no objective breached in this window",
                    "evidence": evidence})
    out.sort(key=lambda v: v["score"], reverse=True)
    return out
