"""Per-query latency attribution for the reach serving tier.

The port's copy of ``streambench_tpu/obs/queryattr.py`` (host code, no
torch).  The ingest data path has decomposed latency: every written
window's e2e splits into ingest/encode/fold/flush/sink segments that sum
to it.  The reach query path alone has only the aggregate
``streambench_reach_latency_ms`` histogram, which cannot say whether a
slow query's time was queue wait, batch assembly, the device dispatch or
the reply write, nor how much of the queue wait was caused by the device
being busy folding ingest batches.  This module is the query-side mirror
of
:class:`~streambench_tpu_torch.obs.lifecycle.WindowLifecycle`:

- every admitted query gets a :class:`QueryRecord` stamped at
  **admission**, **queue-exit**, **dispatch-submit**,
  **dispatch-complete** and **reply-write**; the submit -> reply e2e is
  decomposed into four segments that sum to it exactly:

  - ``queue``    — admission until the worker popped it for a batch
  - ``batch``    — queue-exit until the padded dispatch was submitted
    (mask assembly; shared by every query in the batch)
  - ``dispatch`` — dispatch submit until the results were materialized
    on the host (device compute + transfer back: on the card the server
    stamps it after the CUDA event recorded behind the query and the
    copies to the host, never at kernel submission)
  - ``reply``    — results in hand until this query's reply was written

  Segments land in one ``streambench_reach_segment_ms`` histogram
  family (label ``segment=...``) plus a matched
  ``streambench_reach_query_e2e_ms`` over the SAME tracked queries, so
  segment p50s explain the e2e p50 apples-to-apples (the serving
  histogram ``streambench_reach_latency_ms`` is unchanged).

- **shed queries stamp too**: a shed victim contributes one
  ``streambench_reach_shed_queue_ms`` sample (admission -> shed; a
  queue-only record, deliberately OUTSIDE the segment family so the
  segment/e2e distributions stay matched) and one ``shed_records``
  count that reconciles exactly against
  ``streambench_reach_shed_total``.

- a bounded **slow-query log** keeps the full decomposition of every
  query slower than ``slo_ms`` (cap + oldest-first eviction, evictions
  counted — the lifecycle-table rule).

- **contention attribution**: each answered query's queue-wait
  interval is intersected with the known *ingest-busy* intervals —
  both sides stamp the same ``perf_counter_ns`` clock — and the
  accumulated overlap/wait ratio is exported as
  ``streambench_reach_contention_ratio``: the fraction of query queue
  time during which the device was occupied by an ingest dispatch.
  ~1.0 means queries wait *because* ingest owns the device (sharded
  reach needs its own device or a replica tier); ~0.0
  means the queue wait is the server's own batching cadence.

  Busy evidence comes from two merged sources, because an async
  dispatch stream hides its own device time: (a) ingest dispatch spans
  (``device_step``/``device_scan``/``drain``) from the wired
  :class:`~streambench_tpu_torch.obs.spans.SpanTracer` ring — meaningful
  exactly where the span covers a real device wait (the ``drain``
  sync), and (b) explicit ``note_ingest_busy(start_ns, end_ns)``
  intervals — the engine CLI wires the OccupancySampler's 1-in-N
  CUDA-event-timed windows here (sampled evidence, same caveat as the
  busy ratio), and a backpressured ingest loop feeds its measured
  fold-sync windows.  Absent both, the gauge stays 0 — missing evidence is
  never fabricated.

Default-off like every obs layer: the reach server carries a ``None``
attribute and reply payloads are byte-identical until
``jax.obs.query`` is set.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from streambench_tpu_torch.utils.ids import now_ms

#: Segment order is pipeline order; renderers preserve it.
SEGMENTS = ("queue", "batch", "dispatch", "reply")

_SEGMENT_HELP = {
    "queue": "admission -> popped from the bounded queue by the worker",
    "batch": "queue-exit -> padded batch dispatch submitted",
    "dispatch": "dispatch submit -> results materialized on host",
    "reply": "results materialized -> this query's reply written",
}

#: Tracer stage-span names that mean "the device is running an ingest
#: dispatch" (engine/pipeline.py span sites) — the numerator of the
#: contention ratio.
INGEST_DISPATCH_SPANS = frozenset(
    ("device_step", "device_scan", "drain"))


class QueryRecord:
    """Stamps of one query's journey (``perf_counter_ns`` clock, the
    span tracer's clock).  Created at admission; ``t_exit`` is set when
    the worker pops it; the batch-level submit/done stamps are passed
    to ``note_reply`` rather than stored per record."""

    __slots__ = ("trace", "qid", "client_ms", "t_admit", "t_exit")

    def __init__(self, trace=None, qid=None, client_ms=None):
        self.trace = trace
        self.qid = qid
        self.client_ms = client_ms
        self.t_admit = time.perf_counter_ns()
        self.t_exit = 0


class QueryLifecycle:
    """Tracks per-query stage stamps and feeds the segment histograms.

    One instance per reach server; the pub/sub handler threads call
    ``admit`` (under the server's admission path) and the single worker
    thread calls ``note_queue_exit``/``note_reply``; shed replies call
    ``note_shed`` from whichever thread sheds.  One lock guards the
    slow log and contention accumulators; the histograms carry their
    own.
    """

    def __init__(self, registry, slo_ms: int = 0, slowlog_max: int = 128,
                 sample_every: int = 1, spans=None):
        self.slo_ms = max(int(slo_ms), 0)
        self.slowlog_max = max(int(slowlog_max), 1)
        self.sample_every = max(int(sample_every), 1)
        self._spans = spans
        self._lock = threading.Lock()
        self.served_records = 0
        self.shed_records = 0
        self.slowlog_evicted = 0
        self._slowlog: deque = deque(maxlen=self.slowlog_max)
        # contention accumulators (ns, answered queries only)
        self._queue_wait_ns = 0
        self._ingest_overlap_ns = 0
        self._device_samples = 0
        # explicit ingest-busy intervals (perf_counter_ns), bounded:
        # the occupancy sampler / an ingest loop feed measured
        # device-busy windows here (async dispatch spans cannot)
        self._busy: deque = deque(maxlen=4096)
        self.ingest_busy_intervals = 0
        # Same tight growth as the window attribution (~9%/bucket):
        # the contract is "segment p50s explain the e2e p50", and
        # bucket error is that comparison's noise floor.  lo=0.01 ms:
        # batch assembly on a warm server is tens of microseconds.
        growth = 2 ** 0.125
        self._hists = {
            seg: registry.histogram(
                "streambench_reach_segment_ms",
                "reach query latency attribution by segment (ms)",
                lo=0.01, hi=1e7, growth=growth, labels={"segment": seg})
            for seg in SEGMENTS}
        self._e2e = registry.histogram(
            "streambench_reach_query_e2e_ms",
            "submit -> reply e2e of attribution-tracked reach queries "
            "(ms)", lo=0.01, hi=1e7, growth=growth)
        # NOT part of the segment partition: how long a shed victim sat
        # queued before the shed (its whole server-side life)
        self._shed_hist = registry.histogram(
            "streambench_reach_shed_queue_ms",
            "admission -> shed of load-shed reach queries (ms)",
            lo=0.01, hi=1e7, growth=growth)
        self._g_contention = registry.gauge(
            "streambench_reach_contention_ratio",
            "fraction of reach-query queue wait during which the "
            "device was occupied by an ingest dispatch (needs "
            "jax.obs.spans for the ingest span stream)")
        self._hist_device = registry.histogram(
            "streambench_reach_dispatch_device_ms",
            "sampled reach dispatch device time, submit to the "
            "results' CUDA event (ms)", lo=0.001, hi=1e5)
        self._c_tracked = registry.counter(
            "streambench_reach_tracked_total",
            "reach queries with a full lifecycle record (answered)")
        self._c_shed_tracked = registry.counter(
            "streambench_reach_shed_tracked_total",
            "shed reach queries with a queue-only lifecycle record")

    # ------------------------------------------------------------------
    def admit(self, trace=None, qid=None, client_ms=None) -> QueryRecord:
        """One query entered the bounded queue; returns the record that
        rides the queue item.  ``trace``/``client_ms`` come off the
        wire message (``trace``/``sent_ms`` fields) when the client
        propagated them."""
        return QueryRecord(trace=trace, qid=qid, client_ms=client_ms)

    # ------------------------------------------------------------------
    def note_queue_exit(self, recs: list) -> None:
        """The worker popped these records into one batch (stamp
        ``t_exit`` first, then call this): accumulates queue-wait vs
        ingest-dispatch overlap for the contention ratio.  One span-ring
        snapshot per BATCH, not per query."""
        if not recs:
            return
        busy = self._ingest_busy_intervals(
            min(r.t_admit for r in recs),
            max(r.t_exit for r in recs))
        wait_ns = overlap_ns = 0
        for r in recs:
            w = r.t_exit - r.t_admit
            if w <= 0:
                continue
            wait_ns += w
            if busy:
                overlap_ns += _interval_overlap_ns(
                    r.t_admit, r.t_exit, busy)
        with self._lock:
            self._queue_wait_ns += wait_ns
            self._ingest_overlap_ns += overlap_ns
            ratio = (self._ingest_overlap_ns / self._queue_wait_ns
                     if self._queue_wait_ns else 0.0)
        self._g_contention.set(round(ratio, 4))

    def note_ingest_busy(self, start_ns: int, end_ns: int) -> None:
        """One measured ingest device-busy window (``perf_counter_ns``
        stamps): the OccupancySampler's sampled CUDA-event
        wait, or a backpressured ingest loop's fold-sync window.  An
        async dispatch's span only covers the submit call, so THIS is
        how real device occupancy reaches the contention numerator."""
        if end_ns > start_ns:
            with self._lock:
                self._busy.append((int(start_ns), int(end_ns)))
                self.ingest_busy_intervals += 1

    def _ingest_busy_intervals(self, lo_ns: int, hi_ns: int) -> list:
        """Merged [start_ns, end_ns) ingest-busy intervals overlapping
        [lo_ns, hi_ns): span-ring dispatch spans + explicitly fed busy
        windows.  Empty when neither source is wired (the contention
        gauge then stays 0 — absent evidence, not fabricated)."""
        if hi_ns <= lo_ns:
            return []
        raw = []
        if self._spans is not None:
            t0 = self._spans.t0_ns
            for s in self._spans.snapshot():
                if (s.get("cat") != "stage"
                        or s.get("name") not in INGEST_DISPATCH_SPANS):
                    continue
                s_ns = t0 + int(s["ts_us"] * 1e3)
                e_ns = s_ns + int(s["dur_us"] * 1e3)
                if e_ns <= lo_ns or s_ns >= hi_ns:
                    continue
                raw.append((s_ns, e_ns))
        with self._lock:
            busy = list(self._busy)
        raw.extend((s_ns, e_ns) for s_ns, e_ns in busy
                   if not (e_ns <= lo_ns or s_ns >= hi_ns))
        if not raw:
            return []
        raw.sort()
        merged = [list(raw[0])]
        for s_ns, e_ns in raw[1:]:
            if s_ns <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e_ns)
            else:
                merged.append([s_ns, e_ns])
        return merged

    # ------------------------------------------------------------------
    def note_reply(self, rec: QueryRecord, t_submit_ns: int,
                   t_done_ns: int) -> None:
        """This record's reply was just written; observe one sample per
        segment.  The four segments sum to ``now - t_admit`` exactly —
        the same partition contract as the window attribution."""
        now = time.perf_counter_ns()
        segs = (
            ("queue", rec.t_exit - rec.t_admit),
            ("batch", t_submit_ns - rec.t_exit),
            ("dispatch", t_done_ns - t_submit_ns),
            ("reply", now - t_done_ns),
        )
        for name, ns in segs:
            self._hists[name].observe(max(ns, 0) / 1e6)
        e2e_ms = max(now - rec.t_admit, 0) / 1e6
        self._e2e.observe(e2e_ms)
        with self._lock:
            self.served_records += 1
        self._c_tracked.inc()
        if self.slo_ms and e2e_ms > self.slo_ms:
            entry = {
                "ts_ms": now_ms(),
                "id": rec.qid,
                "e2e_ms": round(e2e_ms, 3),
                **{f"{name}_ms": round(max(ns, 0) / 1e6, 3)
                   for name, ns in segs},
            }
            if rec.trace is not None:
                entry["trace"] = rec.trace
            with self._lock:
                if len(self._slowlog) == self.slowlog_max:
                    self.slowlog_evicted += 1
                self._slowlog.append(entry)

    def note_shed(self, rec: QueryRecord) -> float:
        """This record's query was shed; observes the queue-only sample
        and returns the queue-wait in ms (the shed reply carries it)."""
        queue_ms = max(time.perf_counter_ns() - rec.t_admit, 0) / 1e6
        self._shed_hist.observe(queue_ms)
        with self._lock:
            self.shed_records += 1
        self._c_shed_tracked.inc()
        return queue_ms

    # ------------------------------------------------------------------
    def device_sample_due(self, dispatch_no: int) -> bool:
        """1-in-N dispatch sampling cadence for the explicit
        device timing (OccupancySampler's rule)."""
        return dispatch_no % self.sample_every == 0

    def note_device_sample(self, device_ms: float) -> None:
        self._hist_device.observe(device_ms)
        with self._lock:
            self._device_samples += 1

    # ------------------------------------------------------------------
    def server_block(self, rec: QueryRecord, t_submit_ns: int,
                     t_done_ns: int) -> dict:
        """The server-side decomposition a reply payload carries (up to
        reply-write START — the write itself cannot describe its own
        duration), so a client can split round-trip time into
        server-vs-network halves."""
        now = time.perf_counter_ns()
        out = {
            "queue_ms": round(max(rec.t_exit - rec.t_admit, 0) / 1e6, 3),
            "batch_ms": round(max(t_submit_ns - rec.t_exit, 0) / 1e6, 3),
            "dispatch_ms": round(max(t_done_ns - t_submit_ns, 0) / 1e6,
                                 3),
            "total_ms": round(max(now - rec.t_admit, 0) / 1e6, 3),
        }
        if rec.trace is not None:
            out["trace"] = rec.trace
        return out

    # ------------------------------------------------------------------
    def contention_ratio(self) -> float:
        with self._lock:
            if not self._queue_wait_ns:
                return 0.0
            return self._ingest_overlap_ns / self._queue_wait_ns

    def segment_quantiles(self) -> dict:
        """Compact {segment: {p50, p99}} for SLO breach events — which
        segment is burning the budget when the reach objective trips."""
        out = {}
        for seg in SEGMENTS:
            s = self._hists[seg].summary()
            if s.get("count"):
                out[seg] = {"p50": s.get("p50"), "p99": s.get("p99")}
        return out

    def slowlog(self) -> list[dict]:
        with self._lock:
            return list(self._slowlog)

    def summary(self) -> dict:
        """The ``query_obs`` block the reach server's summary / the
        ``reach_query`` metrics.jsonl block carries."""
        with self._lock:
            wait_ns = self._queue_wait_ns
            overlap_ns = self._ingest_overlap_ns
            slowlog = list(self._slowlog)
            served = self.served_records
            shed = self.shed_records
            evicted = self.slowlog_evicted
            device_samples = self._device_samples
        out = {
            "served_records": served,
            "shed_records": shed,
            "segments": {seg: self._hists[seg].summary()
                         for seg in SEGMENTS},
            "e2e_ms": self._e2e.summary(),
            "shed_queue_ms": self._shed_hist.summary(),
            "contention": {
                "queue_wait_ms": round(wait_ns / 1e6, 3),
                "ingest_overlap_ms": round(overlap_ns / 1e6, 3),
                "ratio": round(overlap_ns / wait_ns, 4) if wait_ns
                else 0.0,
                "spans_wired": self._spans is not None,
                "busy_intervals": self.ingest_busy_intervals,
            },
            "slow_queries": len(slowlog),
            "slowlog_evicted": evicted,
            "slowlog": slowlog,
        }
        if self.slo_ms:
            out["slo_ms"] = self.slo_ms
        if device_samples:
            out["device_dispatch_ms"] = self._hist_device.summary()
        return out


def _interval_overlap_ns(lo: int, hi: int, merged: list) -> int:
    """Overlap of [lo, hi) with a sorted list of merged intervals."""
    total = 0
    for s_ns, e_ns in merged:
        if e_ns <= lo:
            continue
        if s_ns >= hi:
            break
        total += min(hi, e_ns) - max(lo, s_ns)
    return total


def segment_help(seg: str) -> str:
    """Human description of one segment (report rendering)."""
    return _SEGMENT_HELP.get(seg, "")
