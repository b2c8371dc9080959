"""Multi-tenant host: N topologies in one process on one device.

The port of ``streambench_tpu/engine/tenants.py``: every tenant's engine
is the port's own (``engine/pipeline.py``, ``engine/sketches.py``) on
the host's ``device`` (``cuda`` unless the caller asks for ``cpu``), and
its busy windows come from the port's CUDA-event
:class:`~streambench_tpu_torch.obs.occupancy.OccupancySampler`: host
``perf_counter_ns`` intervals around the sampled event wait, the clock
the enqueue-to-fold waits use too.

The reference harness runs one workload per engine process; the
"millions of users" north star is the opposite shape — several
topologies (an exact windowed count, a session CMS, a reach serving
tier) sharing one process and one accelerator.  This module is the
host that makes that shape *observable and governable*:

- every tenant gets its own engine, its own fakeredis sink, its own
  :class:`~streambench_tpu_torch.obs.tenancy.TenantRegistry` view over the
  ONE shared registry (all its instruments carry ``tenant=``), its own
  :class:`~streambench_tpu_torch.obs.occupancy.OccupancySampler` whose
  sampled busy windows feed the shared
  :class:`~streambench_tpu_torch.obs.tenancy.DeviceTimeLedger`, and (when an
  objective is declared) its own per-tenant
  :class:`~streambench_tpu_torch.obs.slo.SloTracker`;
- one shared :class:`~streambench_tpu_torch.obs.sampler.MetricsSampler`
  journals everything into one ``metrics.jsonl``: per-tenant blocks
  under ``rec["tenants"][name]``, per-tenant SLO under
  ``rec["slo_tenants"][name]``, the blame matrix + partition check
  under ``rec["multitenant"]``, and admission-controller state under
  ``rec["admission"]``;
- ingest is a bounded per-tenant batch queue.  Batches stamp their
  enqueue time; the fold loop records enqueue→fold as the tenant's
  measured *wait* (the blame matrix's victim side).  A reach tenant's
  waits come from its server's admit→pop pairs instead.
- when ``jax.admission.enabled`` is set the host consults the
  :class:`~streambench_tpu_torch.obs.admission.AdmissionController` before
  folding: a defer gate leaves the aggressor's batches queued (nothing
  lost), a shed gate drops its oldest batch (counted per tenant).
  Default-off: without the flag the fold loop never calls into
  admission at all.
- a defer gate also *actuates upstream* when the tenant's reader
  supports it (the Kafka adapter's ``pause()``/``resume()``): the
  paused consumer stops fetching, so the aggressor's backlog
  accumulates IN THE BROKER — measured by the per-tenant
  ``streambench_kafka_consumer_lag`` gauge — instead of ballooning the
  host queue.  Release (or escalation to shed) resumes the consumer.
  Readers without ``pause`` (FileBroker) just keep the old
  queue-backlog behavior.

Round-robin fairness note, stated honestly: one host loop folds every
tenant, so a flash crowd on one tenant delays everyone through the host
loop *and* the card's stream — which is exactly the interference the
blame matrix measures.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from streambench_tpu_torch.io.fakeredis import make_store
from streambench_tpu_torch.io.redis_schema import as_redis
from streambench_tpu_torch.obs import (
    AdmissionController,
    DeviceTimeLedger,
    OccupancySampler,
    SloTracker,
    TenantRegistry,
    engine_collector,
)

#: engine kinds a tenant can declare (the engine CLI's families)
TENANT_KINDS = ("exact", "hll", "sliding", "session", "reach", "hllx")

#: per-tenant ingest queue bound: a deferred tenant's backlog is
#: bounded — past it the OLDEST batch is dropped and counted, the
#: shed-not-wedge rule every bounded queue in the repo follows
QUEUE_MAX = 1024


def parse_tenants(spec: str) -> list[dict]:
    """``"alpha:exact,beta:session,gamma:reach"`` -> tenant dicts.

    Names must be unique and non-empty; a missing kind defaults to
    ``exact``.  The spec grammar is deliberately the fleet
    ``parse_role_spec`` shape — one flat comma list, loud errors.
    """
    out: list[dict] = []
    seen: set = set()
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, kind = part.partition(":")
        name = name.strip()
        kind = (kind.strip() or "exact")
        if not name:
            raise ValueError(f"tenant with empty name in {spec!r}")
        if name in seen:
            raise ValueError(f"duplicate tenant {name!r} in {spec!r}")
        if kind not in TENANT_KINDS:
            raise ValueError(
                f"tenant {name!r} declares unknown kind {kind!r} "
                f"(supported: {', '.join(TENANT_KINDS)})")
        seen.add(name)
        out.append({"name": name, "kind": kind})
    if not out:
        raise ValueError(f"no tenants in spec {spec!r}")
    return out


class _Tenant:
    """One tenant's runtime bundle (host-internal)."""

    __slots__ = ("name", "kind", "engine", "view", "occupancy", "slo",
                 "queue", "reader", "serve", "folded_batches",
                 "dropped_batches", "wait_seen")

    def __init__(self, name, kind):
        self.name = name
        self.kind = kind
        self.engine = None
        self.view = None
        self.occupancy = None
        self.slo = None
        self.queue: deque = deque()
        self.reader = None
        self.serve = None
        self.folded_batches = 0
        self.dropped_batches = 0
        # high-water (pop_ns, admit_ns) over the serve wait ring:
        # wait_intervals() returns the WHOLE bounded ring each call, so
        # the drain must consume only what it has not seen yet or every
        # drain re-attributes the same waits (ring order is pop order,
        # admits ascending within one pop batch — lexicographic works)
        self.wait_seen = (0, 0)


class MultiTenantHost:
    """Build, feed, meter and (optionally) govern N tenant engines.

    ``specs`` is :func:`parse_tenants` output, optionally extended per
    tenant with objective keys (``p99_ms``, ``rate_evps``,
    ``reach_p99_ms``) and ``serve=True`` for a reach tenant that
    should answer live queries.  ``registry`` is the ONE shared
    :class:`MetricsRegistry`; ``sampler`` (optional) is the shared
    MetricsSampler the host adds its collectors to.
    """

    def __init__(self, cfg, specs, mapping, campaigns=None, *,
                 registry, sampler=None, sample_every: int = 4,
                 admission: bool = False,
                 admission_kw: "dict | None" = None,
                 queue_max: int = QUEUE_MAX,
                 redis_factory=None,
                 device="cuda"):
        self.cfg = cfg
        self.device = device
        self.mapping = mapping
        self.campaigns = campaigns
        self.registry = registry
        self.sampler = sampler
        self.sample_every = max(int(sample_every), 1)
        self.queue_max = max(int(queue_max), 1)
        # called once per tenant; default is a private in-process store
        # per tenant (the CLI passes a factory honoring cfg.redis_host
        # so harness evidence walks see the windows)
        self._redis_factory = redis_factory
        # drain_waits runs on the fold loop and on the sampler's thread;
        # the lock keeps the high-water read-modify-write whole, so no
        # wait pair is attributed twice
        self._drain_lock = threading.Lock()
        self.ledger = DeviceTimeLedger(registry=registry)
        self._tenants: "dict[str, _Tenant]" = {}
        for spec in specs:
            self._build(dict(spec))
        self.admission = None
        if admission:
            self.admission = AdmissionController(
                self.ledger, self._burns, registry=registry,
                sampler=sampler, lags=self.reader_lags,
                **(admission_kw or {}))
        if sampler is not None:
            sampler.add_collector(self._host_collector())

    # -- construction --------------------------------------------------
    def _build(self, spec: dict) -> None:
        name = spec["name"]
        kind = spec.get("kind", "exact")
        t = _Tenant(name, kind)
        t.view = TenantRegistry(self.registry, name)
        self.ledger.declare(name)
        redis = (self._redis_factory() if self._redis_factory is not None
                 else as_redis(make_store()))
        if kind == "exact":
            from streambench_tpu_torch.engine.pipeline import AdAnalyticsEngine

            t.engine = AdAnalyticsEngine(
                self.cfg, self.mapping, campaigns=self.campaigns,
                redis=redis, device=self.device)
        else:
            from streambench_tpu_torch.engine.sketches import (
                HLLDistinctEngine,
                HLLXEngine,
                ReachSketchEngine,
                SessionCMSEngine,
                SlidingTDigestEngine,
            )

            cls = {"hll": HLLDistinctEngine,
                   "sliding": SlidingTDigestEngine,
                   "session": SessionCMSEngine,
                   "reach": ReachSketchEngine,
                   "hllx": HLLXEngine}[kind]
            t.engine = cls(self.cfg, self.mapping,
                           campaigns=self.campaigns, redis=redis,
                           device=self.device)
        t.occupancy = OccupancySampler(t.view,
                                       sample_every=self.sample_every,
                                       watch_compiles=False)
        t.occupancy.busy_sink = self.ledger.busy_sink(name)
        t.engine.attach_obs(t.view, occupancy=t.occupancy)
        p99 = int(spec.get("p99_ms") or 0)
        rate = int(spec.get("rate_evps") or 0)
        reach_p99 = int(spec.get("reach_p99_ms") or 0)
        if p99 or rate or reach_p99:
            t.slo = SloTracker(
                t.view, p99_ms=p99, rate_evps=rate,
                reach_p99_ms=reach_p99,
                budget=float(getattr(self.cfg, "jax_slo_budget", 0.01)),
                fast_s=float(spec.get(
                    "fast_s", getattr(self.cfg, "jax_slo_fast_s", 30))),
                slow_s=float(spec.get(
                    "slow_s", getattr(self.cfg, "jax_slo_slow_s", 180))),
                tenant=name,
                annotate=(self.sampler.annotate
                          if self.sampler is not None else None))
        if kind == "reach" and spec.get("serve"):
            from streambench_tpu_torch.reach.serve import ReachQueryServer

            t.serve = ReachQueryServer(self.campaigns or [],
                                       registry=t.view)
            t.engine.attach_reach(t.serve)
        if self.sampler is not None:
            self.sampler.add_collector(self._tenant_collector(t))
        self._tenants[name] = t

    # -- journal plumbing ----------------------------------------------
    def _tenant_collector(self, t: _Tenant):
        inner = engine_collector(t.engine, registry=t.view)

        def collect(rec: dict, dt_s: float) -> None:
            sub: dict = {"kind": t.kind}
            inner(sub, dt_s)
            sub["queued_batches"] = len(t.queue)
            sub["folded_batches"] = t.folded_batches
            sub["dropped_batches"] = t.dropped_batches
            lag_fn = getattr(t.reader, "lag", None)
            if lag_fn is not None:
                try:
                    lag = int(lag_fn())
                except Exception:
                    lag = None
                if lag is not None:
                    sub["consumer_lag"] = lag
                    sub["reader_paused"] = bool(
                        getattr(t.reader, "paused", False))
                    t.view.gauge(
                        "streambench_kafka_consumer_lag",
                        "broker log end minus this consumer's position"
                        " (records not yet fetched)").set(lag)
            if t.serve is not None:
                sub["reach_query"] = t.serve.summary()
            if t.slo is not None:
                # the tenant-scoped tracker journals into the
                # RECORD-level slo_tenants map, not the tenant block —
                # hoist it up where diagnose() reads it
                t.slo.collect(sub, dt_s)
                st = sub.pop("slo_tenants", None)
                if st:
                    rec.setdefault("slo_tenants", {}).update(st)
            rec.setdefault("tenants", {})[t.name] = sub

        return collect

    def _host_collector(self):
        def collect(rec: dict, dt_s: float) -> None:
            self.drain_waits()
            mt = self.ledger.summary()
            mt["partition"] = self.partition_check()
            rec["multitenant"] = mt
            if self.admission is not None:
                rec["admission"] = self.admission.summary()

        return collect

    def _burns(self) -> dict:
        return {t.name: t.slo.fast_burn()
                for t in self._tenants.values() if t.slo is not None}

    def reader_lags(self) -> dict:
        """``{tenant: broker-side consumer lag}`` for every tenant
        whose reader can measure it (the Kafka adapter's ``lag()``).
        The admission controller journals this map with every gate
        decision — the broker-backlog evidence the defer actuator is
        judged by."""
        out: dict = {}
        for t in self._tenants.values():
            lag_fn = getattr(t.reader, "lag", None)
            if lag_fn is None:
                continue
            try:
                out[t.name] = int(lag_fn())
            except Exception:
                pass
        return out

    # -- ingest --------------------------------------------------------
    def tenants(self) -> list[str]:
        return list(self._tenants)

    def tenant(self, name: str) -> _Tenant:
        return self._tenants[name]

    def offer(self, name: str, lines: list) -> None:
        """Queue one ingest batch for a tenant (enqueue-stamped for
        wait attribution).  A full queue drops the OLDEST batch."""
        t = self._tenants[name]
        if len(t.queue) >= self.queue_max:
            t.queue.popleft()
            t.dropped_batches += 1
        t.queue.append((time.perf_counter_ns(), lines))

    def pump(self, max_records: int = 4096) -> int:
        """Poll each tenant's journal reader (when wired) into its
        queue.  Returns total lines moved."""
        moved = 0
        for t in self._tenants.values():
            if t.reader is None or getattr(t.reader, "paused", False):
                continue
            lines = t.reader.poll(max_records)
            if lines:
                self.offer(t.name, lines)
                moved += len(lines)
        return moved

    def _sync_reader_gates(self) -> None:
        """Mirror admission gates onto pausable readers: a defer gate
        pauses the tenant's consumer (backlog accumulates broker-side,
        not in the host queue); anything else — admit, release, or a
        shed escalation (which must keep consuming to keep shedding) —
        resumes it."""
        for t in self._tenants.values():
            r = t.reader
            if r is None or not hasattr(r, "pause"):
                continue
            want = self.admission.admit(t.name) == "defer"
            if want and not getattr(r, "paused", False):
                r.pause()
            elif not want and getattr(r, "paused", False):
                r.resume()

    def step(self) -> int:
        """One round-robin fold pass: at most one queued batch per
        tenant, admission-gated.  Returns batches folded."""
        folded = 0
        if self.admission is not None:
            self._sync_reader_gates()
        for t in self._tenants.values():
            if not t.queue:
                continue
            if self.admission is not None:
                action = self.admission.admit(t.name)
                if action == "defer":
                    self.admission.note_deferred(t.name)
                    continue
                if action == "shed":
                    t.queue.popleft()
                    self.admission.note_shed(t.name)
                    continue
            t_enq, lines = t.queue.popleft()
            self.ledger.note_wait(t.name, t_enq,
                                  time.perf_counter_ns())
            t.engine.process_lines(lines)
            t.folded_batches += 1
            folded += 1
        return folded

    def drain_waits(self) -> None:
        """Pull reach servers' admit→pop wait pairs into the ledger
        (the serving tenant's victim-side evidence)."""
        with self._drain_lock:
            for t in self._tenants.values():
                if t.serve is not None:
                    seen = t.wait_seen
                    for a_ns, p_ns in t.serve.wait_intervals():
                        if (p_ns, a_ns) <= seen:
                            continue
                        self.ledger.note_wait(t.name, a_ns, p_ns)
                        if (p_ns, a_ns) > t.wait_seen:
                            t.wait_seen = (p_ns, a_ns)

    def control_step(self) -> "dict | None":
        """One admission-controller pass (no-op when admission is
        off)."""
        if self.admission is None:
            return None
        self.drain_waits()
        return self.admission.step()

    def flush_all(self, final: bool = False) -> None:
        for t in self._tenants.values():
            t.engine.flush(final=final)

    def warmup(self) -> None:
        for t in self._tenants.values():
            t.engine.warmup()

    # -- invariants + reporting ----------------------------------------
    def partition_check(self) -> dict:
        """The blame matrix's conservation law over the LIVE samplers:
        per-tenant attributed busy must sum to the occupancy samplers'
        measured busy."""
        return self.ledger.partition_check(
            {t.name: t.occupancy.busy_ns
             for t in self._tenants.values()})

    def summary(self) -> dict:
        out: dict = {"tenants": {}}
        for t in self._tenants.values():
            tel = t.engine.telemetry()
            block = {
                "kind": t.kind,
                "events": tel["events"],
                "windows_written": tel["windows_written"],
                "folded_batches": t.folded_batches,
                "queued_batches": len(t.queue),
                "dropped_batches": t.dropped_batches,
                "occupancy": t.occupancy.summary(),
            }
            if t.slo is not None:
                block["slo"] = t.slo.verdict()
            if t.serve is not None:
                block["reach_query"] = t.serve.summary()
            out["tenants"][t.name] = block
        mt = self.ledger.summary()
        mt["partition"] = self.partition_check()
        out["multitenant"] = mt
        if self.admission is not None:
            out["admission"] = self.admission.summary()
        return out

    def total_events(self) -> int:
        return sum(t.engine.telemetry()["events"]
                   for t in self._tenants.values())

    def close(self, final: bool = True) -> dict:
        """Final flush + close every tenant (runner ordering: flush
        ``final=True`` BEFORE close); returns the final summary."""
        self.drain_waits()
        for t in self._tenants.values():
            if t.serve is not None:
                t.serve.close()
            try:
                t.engine.flush(final=final)
            except Exception:
                pass
        out = self.summary()
        for t in self._tenants.values():
            t.engine.close()
            t.occupancy.close()
        return out


def run_tenants_cli(cfg, args, mapping, campaigns) -> int:
    """The engine CLI's ``--tenants`` branch: run the multi-tenant
    host over the shared broker topic until ``--duration`` /
    ``--maxEvents`` / catch-up drain, then print one stats line.

    Every tenant tails the SAME topic with its OWN reader (the shared
    firehose feeds N disjoint topologies — the many-users shape), so
    offsets never contend and a deferred tenant's backlog is visible
    as its reader/queue lag, not anyone else's.
    """
    import json
    import os
    import signal

    from streambench_tpu_torch.io.kafka import make_broker
    from streambench_tpu_torch.obs import (
        MetricsRegistry,
        MetricsSampler,
        MetricsServer,
    )

    specs = parse_tenants(getattr(args, "tenants", None)
                          or cfg.jax_tenants)
    for s in specs:
        if s["kind"] == "reach":
            s["serve"] = True
            if cfg.jax_reach_slo_p99_ms:
                s["reach_p99_ms"] = cfg.jax_reach_slo_p99_ms
        else:
            if cfg.jax_slo_p99_ms:
                s["p99_ms"] = cfg.jax_slo_p99_ms
            if cfg.jax_slo_rate_evps:
                s["rate_evps"] = cfg.jax_slo_rate_evps

    broker = make_broker(cfg.kafka_bootstrap_servers,
                         args.brokerDir
                         or os.path.join(args.workdir, "broker"),
                         fake=cfg.kafka_fake)
    broker.create_topic(cfg.kafka_topic)
    registry = MetricsRegistry()
    sampler = None
    if cfg.jax_metrics_interval_ms > 0:
        sampler = MetricsSampler(
            os.path.join(args.workdir, "metrics.jsonl"),
            interval_ms=cfg.jax_metrics_interval_ms,
            registry=registry, role="host")
    def _make_redis():
        if cfg.redis_host == ":inprocess:":
            return as_redis(make_store())
        from streambench_tpu_torch.io.resp import RespClient

        return RespClient(cfg.redis_host, cfg.redis_port)

    host = MultiTenantHost(
        cfg, specs, mapping, campaigns=campaigns, registry=registry,
        sampler=sampler, redis_factory=_make_redis,
        device=args.device,
        admission=cfg.jax_admission_enabled,
        admission_kw={
            "breach_ticks": cfg.jax_admission_breach_ticks,
            "healthy_ticks": cfg.jax_admission_healthy_ticks,
            "escalate_ticks": cfg.jax_admission_escalate_ticks,
            "cooldown_s": cfg.jax_admission_cooldown_s,
        })
    for name in host.tenants():
        host.tenant(name).reader = broker.reader(cfg.kafka_topic)
    if (sampler is not None
            and getattr(broker, "counters", None) is not None):
        from streambench_tpu_torch.obs import kafka_collector

        # one broker-level ledger block per tick (the per-tenant lag
        # gauges live in each tenant's collector); host-level lag is
        # the WORST tenant's — the admission actuator's headline
        sampler.add_collector(kafka_collector(
            broker.counters,
            lag=lambda: max(host.reader_lags().values(), default=0),
            registry=registry))
    host.warmup()
    if sampler is not None:
        sampler.start()
    server = None
    if cfg.jax_metrics_port >= 0:
        refresh = sampler.collect_now if sampler is not None else None
        server = MetricsServer(registry, port=cfg.jax_metrics_port,
                               refresh=refresh)
    print(f"tenants up: {','.join(host.tenants())}"
          + (f" (admission on)" if host.admission else ""),
          flush=True)

    # the harness stops engines with SIGTERM (stream_bench
    # stop_if_needed) — convert it into a clean drain so the stats
    # line and the final journal flush still happen
    stopping = []
    try:
        signal.signal(signal.SIGTERM, lambda *_: stopping.append(1))
    except ValueError:  # not the main thread (in-process embedding)
        pass

    t0 = time.monotonic()
    deadline = (t0 + args.duration) if args.duration else None
    flush_s = max(cfg.jax_flush_interval_ms, 1) / 1000.0
    last_flush = last_ctrl = t0
    idle_since = None
    try:
        while True:
            now = time.monotonic()
            if stopping:
                break
            if deadline is not None and now >= deadline:
                break
            if (args.maxEvents
                    and host.total_events() >= args.maxEvents):
                break
            moved = host.pump()
            folded = host.step()
            if host.admission is not None and now - last_ctrl >= 0.5:
                host.control_step()
                last_ctrl = now
            if now - last_flush >= flush_s:
                host.flush_all()
                last_flush = now
            if moved or folded:
                idle_since = None
                continue
            host.drain_waits()
            if args.catchup:
                break
            if args.idleTimeout is not None:
                if idle_since is None:
                    idle_since = now
                elif now - idle_since >= args.idleTimeout:
                    break
            time.sleep(0.005)
    except KeyboardInterrupt:
        pass
    summary = host.close()
    stats_line = {
        "engine": "multitenant",
        "tenants": {name: {
            "kind": b["kind"], "events": b["events"],
            "windows_written": b["windows_written"],
            "folded_batches": b["folded_batches"],
            **({"slo_pass": b["slo"]["pass"]} if "slo" in b else {}),
        } for name, b in summary["tenants"].items()},
        "events": sum(b["events"]
                      for b in summary["tenants"].values()),
        "blame_offdiag_ratio":
            summary["multitenant"]["offdiag_ratio"],
        "partition_ok": summary["multitenant"]["partition"]["ok"],
    }
    if "admission" in summary:
        adm = summary["admission"]
        stats_line["admission"] = {
            k: adm[k] for k in ("defers", "sheds", "releases", "holds",
                                "batches_deferred", "batches_shed")}
    if getattr(broker, "counters", None) is not None:
        ksnap = {k[len("kafka_"):]: v
                 for k, v in broker.counters.snapshot().items()
                 if k.startswith("kafka_")}
        if ksnap:
            stats_line["kafka"] = ksnap
    print(json.dumps(stats_line), flush=True)
    if server is not None:
        server.close()
    if sampler is not None:
        sampler.close(final=stats_line)
    return 0
