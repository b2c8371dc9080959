"""Stamped-timestamp tracing for the host loop + device profiler hook.

The reference has no dedicated tracer; profiling is ad-hoc stopwatch
timestamps woven into the dataflow (SURVEY.md §5.1): ``DeserializeBolt``
stamps arrival time into each tuple (``AdvertisingTopologyNative.java:264,
273``), the windowed bolts capture per-window (receive, row->col, col->row)
stamps (``:316-353``), and per-window wall time is printed
(``:425-426``).  This module makes that idiom first-class: named
monotonic-clock spans per pipeline stage, aggregated into per-stage
totals/counts, cheap enough to leave on (two ``perf_counter_ns`` calls and
a dict update per span).

``device_trace`` wraps ``torch.profiler`` so a run can also capture a
Chrome trace of the host's torch ops and, on the card, its kernels and
copies.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field


@dataclass
class StageStats:
    calls: int = 0
    total_ns: int = 0
    max_ns: int = 0

    @property
    def total_ms(self) -> float:
        return self.total_ns / 1e6

    @property
    def mean_ms(self) -> float:
        return self.total_ns / 1e6 / max(self.calls, 1)


@dataclass
class Tracer:
    """Per-stage span accounting.  ``with tracer.span("encode"): ...``

    Thread-safe: the Redis flusher thread records ``redis_flush`` spans
    concurrently with the host loop's ``encode``/``device_step`` spans
    (and the telemetry sampler reads the table mid-run), so the
    ``StageStats`` read-modify-write happens under one lock.  The span
    overhead stays ~two ``perf_counter_ns`` calls plus the locked dict
    update — timing runs outside the lock.
    """

    stages: dict[str, StageStats] = field(default_factory=dict)
    enabled: bool = True
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)
    # Optional per-span forwarder ``sink(stage, start_ns, dur_ns)``
    # (obs.spans.SpanTracer wires itself here): None by default, so the
    # uninstrumented path pays one attribute check per span — the same
    # price as the lifecycle/flightrec hooks.  Called OUTSIDE the lock,
    # on the thread that ran the span (span tracing is thread-aware).
    sink: "object | None" = field(default=None, repr=False,
                                  compare=False)

    def _record(self, stage: str, duration_ns: int) -> None:
        with self._lock:
            st = self.stages.get(stage)
            if st is None:
                st = self.stages[stage] = StageStats()
            st.calls += 1
            st.total_ns += duration_ns
            st.max_ns = max(st.max_ns, duration_ns)

    @contextlib.contextmanager
    def span(self, stage: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            dur = time.perf_counter_ns() - t0
            self._record(stage, dur)
            if self.sink is not None:
                self.sink(stage, t0, dur)

    def add(self, stage: str, duration_ns: int) -> None:
        self._record(stage, duration_ns)

    def snapshot(self) -> dict[str, tuple[int, int, int]]:
        """Consistent ``{stage: (calls, total_ns, max_ns)}`` copy — the
        delta source for the telemetry sampler."""
        with self._lock:
            return {name: (st.calls, st.total_ns, st.max_ns)
                    for name, st in self.stages.items()}

    def report(self) -> str:
        snap = self.snapshot()
        if not snap:
            return "trace: no spans recorded"
        width = max(len(s) for s in snap)
        lines = ["trace (stage: calls total_ms mean_ms max_ms):"]
        for name, (calls, total_ns, max_ns) in sorted(
                snap.items(), key=lambda kv: -kv[1][1]):
            lines.append(
                f"  {name:<{width}}  {calls:>8}  {total_ns / 1e6:>10.1f}  "
                f"{total_ns / 1e6 / max(calls, 1):>8.3f}  "
                f"{max_ns / 1e6:>8.3f}")
        return "\n".join(lines)

    def as_dict(self) -> dict[str, dict[str, float]]:
        return {name: {"calls": calls, "total_ms": total_ns / 1e6,
                       "mean_ms": total_ns / 1e6 / max(calls, 1),
                       "max_ms": max_ns / 1e6}
                for name, (calls, total_ns, max_ns)
                in self.snapshot().items()}


@contextlib.contextmanager
def device_trace(logdir: str | None, device=None):
    """Capture a ``torch.profiler`` trace into ``logdir/trace.json``
    (no-op if None); ``device`` is the engine's, whose kernels are
    recorded when it is a CUDA device.

    Delegates to ``obs.capture.profiler_window`` — the ONE profiler
    start/stop path in the package, shared with the triggered-capture
    manager (the profiler is process-wide; two entry points with their
    own state could double-start it).  If a triggered capture already
    owns the profiler, this trace is skipped rather than raised."""
    from streambench_tpu_torch.obs.capture import profiler_window

    with profiler_window(logdir, device):
        yield
