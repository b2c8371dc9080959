"""Background metrics sampler: a ``metrics.jsonl`` time-series journal.

One daemon thread wakes every ``jax.metrics.interval.ms`` and appends a
snapshot record to ``metrics.jsonl`` in the run's workdir — the run's
flight recorder.  Everything is *pulled* from the engine's existing
host-side bookkeeping (``events_processed``, the ``Tracer`` table,
``FaultCounters``, the journal reader's byte position): the hot loop is
never instrumented beyond what already exists, so a disabled sampler
costs the hot path nothing at all.

Record schema (one JSON object per line):

- ``{"kind": "snapshot", "seq": N, "ts_ms": ..., "uptime_ms": ...,``
  ``"events": cum, "events_per_s": delta-rate, "windows_written": cum,``
  ``"backlog_bytes": ..., "watermark_lag_ms": ..., "sink_dirty_rows": ...,``
  ``"rss_bytes": ..., "latency_ms": {count,p50,p95,p99,min,max,sum},``
  ``"stages": {name: {"calls": Δ, "ms": Δ}}, "faults": cum,``
  ``"fault_deltas": Δ}`` — per-tick state; deltas are since the
  previous record.  When the staged ingest pipeline is live the record
  also carries ``"ingest": {block_queue_depth, batch_queue_depth,``
  ``reader_stalls, encode_stalls, ...}`` (``IngestPipeline.telemetry``).
- ``{"kind": "event", "event": "...", ...}`` — out-of-band annotations
  (supervisor restarts, give-ups) injected between snapshots.
- ``{"kind": "final", ..., "run_stats": {...}}`` — one last snapshot at
  close, carrying the exit ``RunStats`` verbatim so the time series and
  the run's JSON stats line can be reconciled record-for-record.
"""

from __future__ import annotations

import json
import os
import threading
import time

from streambench_tpu_torch.utils.ids import now_ms


def rss_sample() -> "tuple[int | None, str]":
    """``(bytes, field_name)`` resident-set reading for this process.

    The primary ``/proc/self/statm`` path reads CURRENT RSS and labels
    it ``rss_bytes``; the portability fallback only has ``ru_maxrss`` —
    the PEAK, which never goes down — so it is labeled
    ``rss_peak_bytes`` instead of being passed off as current (a report
    reading a flat "rss" line would otherwise conclude memory is stable
    while the process leaks toward its peak)."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return (int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE"),
                    "rss_bytes")
    except (OSError, ValueError, IndexError):
        try:
            import resource

            return (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                    * 1024, "rss_peak_bytes")
        except Exception:
            return None, "rss_bytes"


def rss_bytes() -> int | None:
    """Resident set size of this process, or None when unreadable.
    NOTE: on hosts without ``/proc`` this is the peak, not current —
    use :func:`rss_sample` when the distinction matters."""
    return rss_sample()[0]


def engine_collector(engine, reader=None, runner=None, registry=None):
    """Collector closure over one engine (+ optional reader/runner).

    Each call folds the engine's current cumulative bookkeeping into the
    snapshot ``record`` (rates and per-stage/fault deltas computed
    against the previous call) and mirrors the same values into
    ``registry`` instruments so a Prometheus scrape and the jsonl stream
    always tell one story.  Everything is duck-typed reads of host-side
    fields — no device sync, no locks beyond the instruments' own.
    """
    prev = {"events": 0, "windows": 0, "stages": {}, "faults": {}}
    reg = registry
    if reg is not None:
        c_events = reg.counter("streambench_events_total",
                               "events folded into device state")
        c_windows = reg.counter("streambench_windows_written_total",
                                "window rows written to the sink")
        g_eps = reg.gauge("streambench_events_per_s",
                          "ingest rate over the last sample interval")
        g_backlog = reg.gauge("streambench_backlog_bytes",
                              "journal bytes appended but not consumed")
        g_wm = reg.gauge("streambench_watermark_lag_ms",
                         "now - max folded event time")
        g_dirty = reg.gauge("streambench_sink_dirty_rows",
                            "failed-writeback rows retained for retry")

    def collect(rec: dict, dt_s: float) -> None:
        tel = engine.telemetry()
        events = tel["events"]
        rec["events"] = events
        rec["events_per_s"] = (round((events - prev["events"]) / dt_s, 1)
                               if dt_s > 0 else 0.0)
        rec["windows_written"] = tel["windows_written"]
        rec["watermark_lag_ms"] = tel["watermark_lag_ms"]
        rec["sink_dirty_rows"] = tel["sink_dirty_rows"]
        rec["pending_rows"] = tel["pending_rows"]
        if "sink_fence" in tel:
            # exactly-once writeback: the (epoch, seq) fence plus the
            # reconcile flag — a resumed-in-reconcile run is visible in
            # the time series, not only in the fault counters
            rec["sink_fence"] = tel["sink_fence"]
            if reg is not None:
                reg.gauge("streambench_sink_fence_seq",
                          "last committed exactly-once flush seq"
                          ).set(tel["sink_fence"]["seq"])
        # sketch-memory census: engines with a counter-plane family (the
        # session engine's fixed, SALSA or two-stage sketch) publish the
        # mode, the state bytes and (at close) the merge counts, read by
        # the ``obs report`` sketch rows
        sk = getattr(engine, "sketch_summary", None)
        if sk is not None:
            try:
                rec["sketch"] = sk()
            except Exception:
                pass
        if reader is not None:
            bb = getattr(reader, "backlog_bytes", None)
            rec["backlog_bytes"] = bb() if bb is not None else None
        if runner is not None:
            rec["batches"] = runner.stats.batches
            rec["flushes"] = runner.stats.flushes
            # staged ingest pipeline (engine.ingest): stage queue depths
            # + stall/starvation counters, present only while a pipeline
            # is live (looked up per tick — the runner builds it inside
            # run(), after this collector was wired)
            pipe = getattr(runner, "_pipeline", None)
            if pipe is not None:
                ing = pipe.telemetry()
                rec["ingest"] = ing
                if reg is not None:
                    reg.gauge("streambench_ingest_block_queue_depth",
                              "raw journal blocks queued ahead of encode"
                              ).set(ing["block_queue_depth"])
                    reg.gauge("streambench_ingest_batch_queue_depth",
                              "encoded batch groups queued ahead of "
                              "device dispatch"
                              ).set(ing["batch_queue_depth"])
                    reg.counter("streambench_ingest_reader_stalls_total",
                                "reader blocked on a full block queue"
                                ).set_total(ing["reader_stalls"])
                    reg.counter("streambench_ingest_encode_stalls_total",
                                "encode blocked on a full batch queue"
                                ).set_total(ing["encode_stalls"])
        # per-stage span deltas (thread-safe Tracer snapshot)
        stages = {}
        for name, (calls, total_ns, _mx) in engine.tracer.snapshot().items():
            pc, pn = prev["stages"].get(name, (0, 0))
            if calls != pc or total_ns != pn:
                stages[name] = {"calls": calls - pc,
                                "ms": round((total_ns - pn) / 1e6, 3)}
            prev["stages"][name] = (calls, total_ns)
        rec["stages"] = stages
        faults = engine.faults.snapshot()
        rec["faults"] = faults
        rec["fault_deltas"] = {
            k: v - prev["faults"].get(k, 0)
            for k, v in faults.items() if v != prev["faults"].get(k, 0)}
        prev["faults"] = faults
        prev["events"] = events
        hist = getattr(engine, "_obs_hist", None)
        if hist is not None and hist.count:
            rec["latency_ms"] = hist.summary()
        # window-lifecycle attribution (obs.lifecycle): the per-segment
        # decomposition of the latency histogram above, present only
        # when the engine was attached with lifecycle=True
        lc = getattr(engine, "_obs_lifecycle", None)
        if lc is not None:
            rec["attribution"] = lc.summary()
        # measured device occupancy (obs.occupancy): sampled busy ratio
        # + recompile counters, present only when attached
        occ = getattr(engine, "_obs_occupancy", None)
        if occ is not None:
            rec["occupancy"] = occ.summary()
        # host->device transfer ledger (obs.xfer): exact payload bytes
        # per wire format + sampled timed transfers
        xf = getattr(engine, "_obs_xfer", None)
        if xf is not None:
            rec["xfer"] = xf.summary()
        # per-shard routed-row skew (obs.xfer.ShardSkew): materializing
        # the device accumulators syncs, but only at sampler cadence
        sk = getattr(engine, "_obs_shard", None)
        if sk is not None:
            shard = sk.summary()
            if shard is not None:
                rec["shard_skew"] = shard
        rss, rss_label = rss_sample()
        rec[rss_label] = rss
        if reg is not None:
            c_events.set_total(events)
            c_windows.set_total(rec["windows_written"])
            g_eps.set(rec["events_per_s"])
            if rec.get("backlog_bytes") is not None:
                g_backlog.set(rec["backlog_bytes"])
            if rec.get("watermark_lag_ms") is not None:
                g_wm.set(rec["watermark_lag_ms"])
            g_dirty.set(rec["sink_dirty_rows"])
            if rss is not None:
                # gauge name follows the sample's semantics (current vs
                # peak) — get-or-create, so only the taken path exists
                reg.gauge(f"streambench_{rss_label}",
                          "resident set size of the engine process"
                          if rss_label == "rss_bytes" else
                          "peak resident set size (ru_maxrss fallback)"
                          ).set(rss)
            for name, d in stages.items():
                reg.counter("streambench_stage_calls_total",
                            "tracer span calls per stage",
                            labels={"stage": name}).inc(d["calls"])
                reg.counter("streambench_stage_ms_total",
                            "tracer span time per stage (ms)",
                            labels={"stage": name}).inc(d["ms"])
            for k, v in faults.items():
                reg.counter("streambench_faults_total",
                            "fault/retry/recovery events by kind",
                            labels={"kind": k}).set_total(v)

    return collect


def kafka_collector(counters, lag=None, registry=None):
    """Collector over the Kafka adapter's shared delivery ledger.

    ``counters`` is the :class:`FaultCounters` a
    :class:`~streambench_tpu_torch.io.kafka.KafkaBroker` threads through
    every writer/reader it hands out (``kafka_produced``,
    ``kafka_delivered``, ``kafka_redeliveries``, retry/backoff
    counters); ``lag`` is an optional callable returning the
    broker-side consumer lag in records.  Each tick lands the ledger
    under ``rec["kafka"]`` (prefix stripped) and mirrors the headline
    instruments into ``registry``.  The instrument family is
    predeclared up front — the scrape-gap rule: a Prometheus scrape
    BEFORE the first fault must see zeroed series, not a missing
    family.
    """
    reg = registry
    if reg is not None:
        reg.predeclare(
            "counter", "streambench_kafka_redeliveries_total",
            "records the broker re-sent after a connection drop and "
            "the reader filtered (duplicates never reach the engine)")
        reg.predeclare(
            "counter", "streambench_kafka_produce_retries_total",
            "transient produce errors retried with capped backoff")
        reg.predeclare(
            "counter", "streambench_kafka_broker_down_ms_total",
            "milliseconds spent in retry backoff against a faulted "
            "broker")
        reg.predeclare(
            "gauge", "streambench_kafka_consumer_lag",
            "broker log end minus the consumer's position (records "
            "not yet fetched)")

    def collect(rec: dict, dt_s: float) -> None:
        snap = counters.snapshot()
        blk = {k[len("kafka_"):]: v for k, v in snap.items()
               if k.startswith("kafka_")}
        if lag is not None:
            try:
                blk["consumer_lag"] = int(lag())
            except Exception:
                pass
        rec["kafka"] = blk
        if reg is not None:
            reg.counter("streambench_kafka_redeliveries_total"
                        ).set_total(blk.get("redeliveries", 0))
            reg.counter("streambench_kafka_produce_retries_total"
                        ).set_total(blk.get("produce_retries", 0))
            reg.counter("streambench_kafka_broker_down_ms_total"
                        ).set_total(blk.get("broker_down_ms", 0))
            if "consumer_lag" in blk:
                reg.gauge("streambench_kafka_consumer_lag"
                          ).set(blk["consumer_lag"])

    return collect


class MetricsSampler:
    """The sampling thread + jsonl writer.

    ``add_collector`` registers callables ``fn(record, dt_s)`` that fold
    state into each snapshot; ``start`` launches the daemon thread;
    ``annotate`` injects an out-of-band event record (any thread);
    ``collect_now`` runs the collectors without journaling (the
    Prometheus handler's pre-scrape refresh); ``close`` stops the thread
    and writes the final record.  All journal writes go through one lock
    so records never interleave.
    """

    def __init__(self, path: str, interval_ms: int = 1000,
                 registry=None, max_bytes: int = 0,
                 role: "str | None" = None):
        self.path = path
        self.interval_ms = max(int(interval_ms), 1)
        self.registry = registry
        # fleet attribution: every record carries this process's pid, and
        # its fleet role when one is declared ("writer", "replica",
        # "router", "controller"), so the FleetCollector can merge many
        # roles' journals into one attributed stream.  pid is stamped
        # unconditionally: one int per record makes any journal
        # self-identifying.
        self.role = role
        self._pid = os.getpid()
        # journal size cap (``jax.metrics.max.bytes``; 0 = unbounded):
        # a record that would push past it rotates metrics.jsonl to
        # metrics.jsonl.1 (replacing any previous .1) — a week-long
        # chaos sweep keeps at most ~2x the cap on disk, never an
        # unbounded time series
        self.max_bytes = max(int(max_bytes or 0), 0)
        self.rotations = 0
        self._collectors: list = []
        self._seq = 0
        self._t0 = time.monotonic()
        self._last_collect = self._t0
        self._io_lock = threading.Lock()
        self._collect_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._bytes = self._f.tell()   # append mode: existing size

    def add_collector(self, fn) -> None:
        self._collectors.append(fn)

    # ------------------------------------------------------------------
    def _write(self, rec: dict) -> None:
        line = json.dumps(rec) + "\n"
        with self._io_lock:
            if (self.max_bytes and self._bytes
                    and self._bytes + len(line) > self.max_bytes):
                # rotate BEFORE the write, so no single file ever
                # exceeds the cap and the newest record is never split
                self._f.close()
                os.replace(self.path, self.path + ".1")
                self._f = open(self.path, "a", encoding="utf-8")
                self._bytes = 0
                self.rotations += 1
            self._f.write(line)
            self._f.flush()
            self._bytes += len(line)

    def _snapshot_record(self, kind: str = "snapshot") -> dict:
        with self._collect_lock:
            now = time.monotonic()
            dt_s = now - self._last_collect
            self._last_collect = now
            rec = {"kind": kind, "seq": self._seq, "ts_ms": now_ms(),
                   "uptime_ms": int((now - self._t0) * 1000),
                   "pid": self._pid}
            if self.role is not None:
                rec["role"] = self.role
            self._seq += 1
            for fn in self._collectors:
                fn(rec, dt_s)
        return rec

    def collect_now(self) -> dict:
        """Run the collectors once, off-cadence, without journaling —
        refreshes the registry so a scrape never serves stale values."""
        return self._snapshot_record(kind="scrape")

    def annotate(self, event: str, **fields) -> None:
        """Inject an out-of-band event record (supervisor restarts...)."""
        rec = {"kind": "event", "event": event, "ts_ms": now_ms(),
               "uptime_ms": int((time.monotonic() - self._t0) * 1000),
               "pid": self._pid}
        if self.role is not None:
            rec["role"] = self.role
        rec.update(fields)
        self._write(rec)

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.interval_ms / 1000.0):
            self._write(self._snapshot_record())

    def start(self) -> "MetricsSampler":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="metrics-sampler")
            self._thread.start()
        return self

    def close(self, final: dict | None = None) -> None:
        """Stop sampling; journal one ``final`` record carrying the
        collectors' last word plus the exit ``run_stats`` verbatim."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        rec = self._snapshot_record(kind="final")
        if final is not None:
            rec["run_stats"] = final
        self._write(rec)
        with self._io_lock:
            self._f.close()
