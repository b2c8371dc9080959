"""Per-window latency attribution: where inside the engine each window's
latency was spent.

The benchmark's headline metric is one opaque number per window —
``time_updated - window_ts`` (``core.clj:149``) — and the telemetry
layer so far only reports its aggregate distribution.  This module makes
the reference's per-tuple timestamp idiom (SURVEY.md §5.1: stamps ride
the dataflow) first-class end to end: every emitted window's journey is
stamped at five points and the end-to-end latency decomposed into

- ``ingest_ms``  — window start until its LAST contributing event was
  read off the journal (includes the window's own span: a 10 s
  tumbling window cannot complete before it has existed for 10 s, so
  this segment dominating is the *healthy* shape; the separate
  ``arrival_span_ms`` histogram — last read minus FIRST read — shows
  how long events for one window kept arriving)
- ``encode_ms``  — last read until the last event was encoded (encode
  residency, read-ahead included)
- ``fold_ms``    — last encode until the last device fold dispatch
- ``flush_ms``   — last fold until ``flush()`` submitted the window's
  rows to the sink writer (device-drain + 1 Hz cadence residency)
- ``sink_ms``    — submit until the writer's actual write stamp
  (queue wait + Redis round trip + any outage backoff)

Each writeback of a window contributes one sample per segment, so the
five segments sum to exactly that write's end-to-end latency (clamping
of clock jitter aside) and the per-segment distributions explain the
aggregate one.  Segments land in the shared :class:`MetricsRegistry`
as one ``streambench_window_segment_ms`` histogram family (label
``segment=...``), are journaled in every ``metrics.jsonl`` snapshot
under ``"attribution"``, and are rendered by
``python -m streambench_tpu_torch.obs attribution`` (with A/B diff).

Cost model (SALSA's bar: cheap enough to leave on): one ``np.unique``
over the batch's window ids per fold (~tens of µs at B=8192), dict
upkeep per open window, O(1) histogram observes per written window.
Default-off — the engine carries only a ``None`` attribute until
``attach_obs(..., lifecycle=True)``, so the disabled hot path is
byte-for-byte the pre-attribution one.
"""

from __future__ import annotations

import threading

import numpy as np

from streambench_tpu_torch.utils.ids import now_ms

#: Segment order is pipeline order; renderers preserve it.
SEGMENTS = ("ingest", "encode", "fold", "flush", "sink")

_SEGMENT_HELP = {
    "ingest": "window start -> last contributing event read",
    "encode": "last read -> last event encoded",
    "fold": "last encode -> last device fold dispatch",
    "flush": "last fold -> flush() submit to the sink writer",
    "sink": "writer submit -> actual sink write (time_updated)",
}


class WindowLifecycle:
    """Tracks per-window stage stamps and feeds segment histograms.

    One instance per engine, shared across the host loop (``note_fold``,
    ``note_flush``), the ingest encode thread (stamps ride the batches,
    see ``engine.ingest``), and the sink writer thread
    (``note_written``) — one lock guards the window table; the
    histograms carry their own.

    The table is bounded two ways: windows closed past
    ``lateness + 2 x divisor`` behind the newest seen window are dropped
    at write time, and a hard ``max_windows`` cap evicts oldest-first
    (evictions are counted, never silent).
    """

    def __init__(self, registry, divisor_ms: int, lateness_ms: int = 0,
                 max_windows: int = 8192):
        self.divisor_ms = max(int(divisor_ms), 1)
        self.lateness_ms = max(int(lateness_ms), 0)
        self.max_windows = max(int(max_windows), 16)
        self._lock = threading.Lock()
        # abs_window_ts -> [first_read_ms, last_read_ms, last_encode_ms,
        #                   last_fold_ms, flush_submit_ms | None]
        self._windows: dict[int, list] = {}
        self._max_wid_ts: int | None = None
        self.windows_evicted = 0
        self.writes_observed = 0
        self.writes_untracked = 0   # written windows never seen folding
        #   (restored-from-checkpoint pending, reclaims after eviction)
        # what the clamping at 0 added, per segment and for the e2e, and
        # the most it added to one write (see clamps())
        self._clamped = dict.fromkeys((*SEGMENTS, "e2e"), 0)
        self._clamped_writes = 0
        self._clamp_max_write = 0
        # Tighter growth than the general-purpose histograms (~9% per
        # bucket vs ~19%): the attribution contract is "segment p50s
        # explain the e2e p50", and bucket error is the noise floor of
        # that comparison.  ~190 buckets — still O(1) observe.
        growth = 2 ** 0.125
        self._hists = {
            seg: registry.histogram(
                "streambench_window_segment_ms",
                "window latency attribution by segment (ms)",
                lo=0.1, hi=1e7, growth=growth, labels={"segment": seg})
            for seg in SEGMENTS}
        # e2e over the SAME tracked windows, so segment sums and the
        # end-to-end distribution are apples-to-apples (the writeback
        # histogram streambench_window_latency_ms also counts untracked
        # windows; this one never does)
        self._e2e = registry.histogram(
            "streambench_window_e2e_ms",
            "end-to-end latency of attribution-tracked windows (ms)",
            lo=0.1, hi=1e7, growth=growth)
        # NOT part of the partition: how long one window's events kept
        # arriving (last read - first read) — distinguishes "the window
        # was still filling" from "one late straggler reopened it"
        self._span = registry.histogram(
            "streambench_window_arrival_span_ms",
            "first-to-last journal read of one window's events (ms)",
            lo=0.1, hi=1e7, growth=growth)

    # ------------------------------------------------------------------
    def stamp_encoded(self, batches, read_ms: int | None = None) -> None:
        """Hang read/encode wall stamps on freshly encoded batches.

        Called by the engine's encode halves (serial paths: read and
        encode are adjacent, the read stamp defaults to now — the gap is
        bounded by ``buffer_timeout_ms``, noise against a window span)
        and overridden with the TRUE read time by the staged ingest
        pipeline's encode stage, where read-ahead makes the gap real.
        """
        now = now_ms()
        if read_ms is None:
            read_ms = now
        for b in batches:
            if getattr(b, "_lc_read_ms", None) is None:
                b._lc_read_ms = read_ms
            b._lc_encode_ms = now

    # ------------------------------------------------------------------
    def note_fold(self, batch) -> None:
        """One encoded batch was dispatched to the device (host loop,
        called from the engine's watermark-note hook).  Attributes the
        batch's read/encode stamps to every window its valid rows touch:
        first-read keeps the min, encode/fold keep the max."""
        n = batch.n
        if not n:
            return
        vt = batch.event_time[:n]
        v = batch.valid[:n]
        if not v.all():
            vt = vt[v]
            if vt.size == 0:
                return
        base = batch.base_time_ms
        wids = np.unique(vt // self.divisor_ms)
        now = now_ms()
        read = getattr(batch, "_lc_read_ms", None) or now
        enc = getattr(batch, "_lc_encode_ms", None) or now
        with self._lock:
            for wid in wids.tolist():
                ts = base + int(wid) * self.divisor_ms
                ent = self._windows.get(ts)
                if ent is None:
                    self._windows[ts] = [read, read, enc, now, None]
                else:
                    if read < ent[0]:
                        ent[0] = read
                    if read > ent[1]:
                        ent[1] = read
                    if enc > ent[2]:
                        ent[2] = enc
                    ent[3] = now
                if self._max_wid_ts is None or ts > self._max_wid_ts:
                    self._max_wid_ts = ts
            # hard cap: evict oldest-first (insertion order tracks time)
            while len(self._windows) > self.max_windows:
                self._windows.pop(next(iter(self._windows)))
                self.windows_evicted += 1

    def note_flush(self, window_ts) -> None:
        """``flush()`` is submitting these windows' rows to the sink
        writer now (host loop).  ``window_ts`` is any iterable of
        absolute window timestamps; duplicates are fine."""
        now = now_ms()
        with self._lock:
            for ts in set(int(t) for t in window_ts):
                ent = self._windows.get(ts)
                if ent is not None:
                    ent[4] = now

    def note_written(self, window_ts, stamp: int) -> None:
        """These windows' rows actually landed in the sink at ``stamp``
        (writer thread).  Observes one sample per segment per window and
        retires windows closed well past lateness."""
        horizon = None
        with self._lock:
            if self._max_wid_ts is not None:
                horizon = (self._max_wid_ts - self.lateness_ms
                           - 2 * self.divisor_ms)
            for ts in window_ts:
                ts = int(ts)
                ent = self._windows.get(ts)
                if ent is None:
                    self.writes_untracked += 1
                    continue
                self.writes_observed += 1
                first_read, last_read, last_enc, last_fold, flush_sub = ent
                if flush_sub is None:
                    flush_sub = last_fold   # direct write, no 1 Hz hop
                e2e = stamp - ts
                segs = (
                    ("ingest", last_read - ts),
                    ("encode", last_enc - last_read),
                    ("fold", last_fold - last_enc),
                    ("flush", flush_sub - last_fold),
                    ("sink", stamp - flush_sub),
                )
                clamp = 0
                for name, ms in segs:
                    self._hists[name].observe(max(float(ms), 0.0))
                    if ms < 0:
                        self._clamped[name] -= ms
                        clamp -= ms
                self._e2e.observe(max(float(e2e), 0.0))
                if e2e < 0:
                    self._clamped["e2e"] -= e2e
                if clamp:
                    self._clamped_writes += 1
                    self._clamp_max_write = max(self._clamp_max_write,
                                                clamp)
                self._span.observe(max(float(last_read - first_read),
                                       0.0))
                if horizon is not None and ts < horizon:
                    del self._windows[ts]       # closed for good
                else:
                    ent[4] = None               # may be written again

    def clamps(self) -> dict:
        """What clamping each sample at 0 added, so the unclamped sums
        can be recovered: ``sum(segments) - segments_ms`` equals
        ``sum(e2e) - e2e_ms`` exactly (the raw segments telescope).  A
        segment goes negative when a stamp it starts from moved past
        the one it ends at: a fold that lands while the window's write
        is in flight makes ``flush`` (and, for a second payload of the
        same flush, ``sink``) negative by at most that write's
        submit-to-landing time.  Not in the JAX package's lifecycle."""
        with self._lock:
            return {"segments_ms": {seg: self._clamped[seg]
                                    for seg in SEGMENTS},
                    "e2e_ms": self._clamped["e2e"],
                    "writes_clamped": self._clamped_writes,
                    "max_write_ms": self._clamp_max_write}

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        """The ``"attribution"`` block a metrics.jsonl snapshot carries:
        per-segment histogram summaries + the matched e2e distribution +
        table health counters."""
        with self._lock:
            open_windows = len(self._windows)
        return {
            "writes_observed": self.writes_observed,
            "writes_untracked": self.writes_untracked,
            "open_windows": open_windows,
            "windows_evicted": self.windows_evicted,
            "e2e_ms": self._e2e.summary(),
            "arrival_span_ms": self._span.summary(),
            "segments": {seg: self._hists[seg].summary()
                         for seg in SEGMENTS},
        }


def segment_help(seg: str) -> str:
    """Human description of one segment (report rendering)."""
    return _SEGMENT_HELP.get(seg, "")
