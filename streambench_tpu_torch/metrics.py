"""Latency accounting: decile report + stall detection.

Re-expresses the reference's two in-repo observability idioms
(SURVEY.md §5.5):

- the Apex latency-aware store (``ProcessTimeAwareStore.java``): per
  (key, bucket) last-update times recorded as aggregates land
  (``updateUpdateTime``, ``:102-111``), then a final report of sorted
  latencies ``update_time − bucket − window_len`` with the first
  ``ignore_first`` and the trailing bucket dropped as incomplete
  (``logFinalLatencies``, ``:115-146``) and a 10-group percentile table
  (``outputGroupByCount``, ``:160-176``);
- its backpressure stall warning: log when the gap between consecutive
  end-of-window callbacks exceeds 2x the streaming window
  (``:84-87``, 400 ms for the 200 ms window).

Here the "store" is the engine's flush path, so ``LatencyTracker.record``
is called once per window writeback and the report runs at close (or on
demand).  Pure host-side bookkeeping: tiny dicts, no device work.
"""

from __future__ import annotations

import logging
import threading
from collections import defaultdict
from typing import Callable

logger = logging.getLogger("streambench.metrics")


class FaultCounters:
    """Thread-safe monotonic counters for fault/retry/recovery events.

    The reference engines have no fault accounting at all — a Redis
    outage surfaces as a Jedis stack trace and a recount-from-earliest
    restart (PAPER.md §0).  Here every adverse event is counted so a run
    can report *how* it survived, not just that it did:

    - ``sink_errors``       — window writebacks that raised (per batch)
    - ``sink_retries``      — rows re-merged into pending for retry
    - ``sink_reconnects``   — reconnect attempts after a sink error
    - ``sink_dirty_high_water`` — retained-rows cap crossings (warned)
    - ``sink_backoff_ms``   — total writer backoff sleep
    - ``crashes_injected``  — simulated ``EngineCrash``es raised
    - ``restarts``          — supervised restarts performed
    - ``journal_faults``    — injected journal read faults served
    - ``journal_corrupt_skipped`` — torn/NUL records skipped by a reader
    - ``dlq_lines``         — malformed lines shunted to the dead-letter
      journal
    - ``flush_stalls``      — flush-cadence gaps past the stall threshold
      (``StallDetector`` with ``counters`` wired)
    - ``rows_lost``         — window rows abandoned at writer shutdown
      after ``CLOSE_RETRY_LIMIT`` exhausted (counted AND raised: a
      silent-loss run can never report a clean exit)

    Exactly-once mode (``jax.sink.exactly_once``, ROBUSTNESS.md):

    - ``fence_conflicts``   — flushes aborted because a newer writer
      epoch owns the sink (zombie guard)
    - ``dedup_suppressed_flushes`` — failed flushes whose commit fence
      proved they fully landed; the retry was suppressed
    - ``reconciled_windows`` — windows rewritten absolute from the
      cumulative ledger (tainted or reconcile-mode flushes)
    - ``sink_unfenced_resumes`` — resumes that found sink fence state
      past the snapshot's (unfenced flushes -> reconcile mode)
    - ``fence_read_errors`` — sink-fence reads that failed (attach
      retried; reconcile assumed conservatively)

    Writers are the Redis flusher thread, the chaos injector, and the
    supervisor — concurrent by construction, hence the lock.  ``inc`` is
    a dict add under a lock (~100 ns); nothing here is on the device
    path.
    """

    def __init__(self) -> None:
        self._counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def inc(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] += n

    def get(self, key: str, default: int = 0) -> int:
        """Current count for ``key``; ``default`` for a key never
        bumped (the dict-like signature callers reach for)."""
        with self._lock:
            return self._counts.get(key, default)

    def snapshot(self) -> dict[str, int]:
        """Non-zero counters as a plain dict (RunStats surfacing)."""
        with self._lock:
            return {k: v for k, v in self._counts.items() if v}

    def merge(self, other: "dict[str, int] | FaultCounters") -> None:
        items = (other.snapshot() if isinstance(other, FaultCounters)
                 else other)
        with self._lock:
            for k, v in items.items():
                self._counts[k] += v


class LatencyTracker:
    """Per-(key, bucket) last-update times -> final latency distribution."""

    def __init__(self, window_ms: int = 10_000, ignore_first: int = 10):
        self.window_ms = window_ms
        self.ignore_first = ignore_first
        # bucket(ms, window start) -> key -> last update time (ms)
        self._updates: dict[int, dict[str, int]] = defaultdict(dict)
        # bulk batches (key_idx array, bucket array, stamp, names) parked
        # until a report asks for them: the per-pair dict updates are too
        # slow for catchup flush sizes (10^5 rows) on the hot path
        self._bulk: list = []

    def record(self, key: str, bucket_ms: int, update_time_ms: int) -> None:
        self._merge_bulk()  # keep single/bulk recording order coherent
        self._updates[bucket_ms][key] = update_time_ms

    def record_bulk(self, key_idx, buckets, update_time_ms: int,
                    names: list[str]) -> None:
        """Record a whole flush batch as arrays; merged lazily at report
        time (last update per (bucket, key) wins, append order = time
        order, same as repeated ``record`` calls)."""
        self._bulk.append((key_idx, buckets, int(update_time_ms), names))

    def _merge_bulk(self) -> None:
        if not self._bulk:
            return
        bulk, self._bulk = self._bulk, []
        for key_idx, buckets, stamp, names in bulk:
            for c, b in zip(key_idx.tolist(), buckets.tolist()):
                self._updates[b][names[c]] = stamp

    def final_latencies(self) -> list[int]:
        """Sorted ``update − bucket − window_len`` over complete buckets.

        The first ``ignore_first`` buckets (engine warm-up) and the last
        bucket (still filling when the run stopped) are excluded, exactly
        the reference's trimming (``ProcessTimeAwareStore.java:129-140``).
        Returns [] when too few buckets survive the trim.
        """
        self._merge_bulk()
        buckets = sorted(self._updates)
        if len(buckets) <= self.ignore_first + 1:
            return []
        kept = buckets[self.ignore_first:-1]
        out = [t - b - self.window_ms
               for b in kept for t in self._updates[b].values()]
        out.sort()
        return out

    def decile_table(self) -> list[tuple[str, int]]:
        return decile_table(self.final_latencies())

    def report(self) -> str:
        lats = self.final_latencies()
        if not lats:
            return ("latency report: not enough complete windows "
                    f"({len(self._updates)} buckets, need "
                    f"> {self.ignore_first + 1})")
        lines = [f"latency report over {len(lats)} samples "
                 f"({len(self._updates)} buckets, first {self.ignore_first} "
                 "+ last ignored):"]
        lines += [f"  {rng}: {v} ms" for rng, v in decile_table(lats)]
        return "\n".join(lines)


def decile_table(latencies: list[int]) -> list[tuple[str, int]]:
    """10 equal-count groups; each row is the group's upper-bound latency
    (``outputGroupByCount``: row i = sorted[step*(i+1)], last = max).

    The index is proportional (``n * (i+1) // 10``), not the reference's
    integer ``step = n // 10`` multiple: below 10 samples the truncated
    step is 0 and every row would repeat ``sorted[0]``.  Proportional
    indices are identical when n divides evenly by 10, drift by at most
    the truncation remainder otherwise, and spread small samples across
    the order statistics instead of collapsing them.
    """
    if not latencies:
        return []
    groups = 10
    n = len(latencies)
    rows: list[tuple[str, int]] = []
    for i in range(groups - 1):
        idx = min(n * (i + 1) // groups, n - 1)
        rows.append((f"{i * 100 // groups} - {(i + 1) * 100 // groups}",
                     int(latencies[idx])))
    rows.append((f"{(groups - 1) * 100 // groups} - 100", int(latencies[-1])))
    return rows


class StallDetector:
    """Warn when consecutive progress ticks are too far apart.

    The reference warns on an end-window gap over 2x the streaming window
    (``ProcessTimeAwareStore.java:84-87``).  ``tick()`` is called once per
    flush; returns the gap in ms when it stalled, else None.

    When ``counters`` is given, every stall also bumps its
    ``flush_stalls`` key — routing stalls into the engine's
    ``FaultCounters`` so they surface in ``RunStats.faults`` and the
    telemetry stream next to the sink/chaos counters, not only in a
    log line and this object's own attribute.
    """

    def __init__(self, expected_period_ms: int,
                 factor: float = 2.0,
                 warn: Callable[[str], None] | None = None,
                 counters: "FaultCounters | None" = None):
        self.threshold_ms = expected_period_ms * factor
        self._warn = warn or logger.warning
        self._counters = counters
        self._last_ms: int | None = None
        self.stalls = 0
        # Largest observed gap (ms) across the run: the bench's
        # independent wall-clock stall evidence — its one-shot retry must
        # not fire on the percentile shape alone (ADVICE r5).
        self.max_gap_ms = 0

    def reset(self) -> None:
        """Drop the cadence baseline (engine restart / resumed run): the
        next tick establishes a fresh one instead of billing the
        downtime as a stall."""
        self._last_ms = None

    def tick(self, now_ms: int) -> int | None:
        gap = None
        if self._last_ms is not None:
            period = now_ms - self._last_ms
            if period > self.threshold_ms:
                gap = period
                self.stalls += 1
                self.max_gap_ms = max(self.max_gap_ms, period)
                if self._counters is not None:
                    self._counters.inc("flush_stalls")
                self._warn(
                    f"unexpected long flush period: {period} ms "
                    f"(threshold {self.threshold_ms:.0f} ms)")
        self._last_ms = now_ms
        return gap
