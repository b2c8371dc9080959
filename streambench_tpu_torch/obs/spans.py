"""Span tracing: a bounded, thread-aware ring of closed spans, exported
as Chrome trace-event JSON (perfetto-loadable).

The existing :class:`~streambench_tpu_torch.trace.Tracer` answers "how much
total time went to each stage" — aggregates only, no timeline.  This
module keeps the individual spans: WHEN each encode/dispatch/flush/sink
write ran, on WHICH thread, and for how long — the picture that shows
whether the writer thread actually overlaps the host loop, where the
1 Hz flush cadence sits relative to device dispatches, and what the
engine was doing in the seconds before a crash (the flight recorder
embeds the last N closed spans in its dumps).

Design constraints, matching the rest of obs/:

- **default-off, zero hot-path cost when unused** — the engine's
  ``Tracer`` gains one ``sink`` attribute (``None`` by default: one
  attribute check per span, the same price the lifecycle/flightrec
  hooks pay).  Nothing else changes until ``attach_obs(...,
  spans=SpanTracer(...))``.
- **bounded** — a deque ring of ``capacity`` closed spans; evictions
  are counted (``dropped``), never silent.  At the default 4096 the
  ring holds the last few seconds of a hot run — exactly the window a
  postmortem wants.
- **cheap** — one dict + deque append under a lock per CLOSED span
  (~1 µs); open spans carry no state beyond the caller's stack.

Export format is the Chrome trace-event JSON object form
(``{"traceEvents": [...]}``): ``"X"`` complete events with
microsecond ``ts``/``dur`` on the span's real thread id, plus one
``"M"`` ``thread_name`` metadata event per thread — load the file in
https://ui.perfetto.dev or ``chrome://tracing`` as-is.  The ``obs
trace`` CLI validates and summarizes one.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

from streambench_tpu_torch.utils.ids import now_ms

#: Chrome trace phase codes this module emits.
PH_COMPLETE = "X"
PH_METADATA = "M"


class SpanTracer:
    """Bounded ring of closed spans + Chrome trace export.

    ``add`` records one closed span (any thread); ``span`` is the
    context-manager form; ``sink`` has the exact signature
    ``Tracer.sink`` calls with, so ``tracer.sink = spans.sink`` (or
    ``spans.attach(tracer)``) forwards every existing stage span —
    encode, device_step/device_scan, drain, redis_flush, warmup,
    decode_probe — without touching a single call site.  The staged
    ingest pipeline and the serial runner loops add their read spans
    the same way.
    """

    def __init__(self, capacity: int = 4096, registry=None):
        self.capacity = max(int(capacity), 16)
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0
        # trace epoch: spans are stamped relative to this perf_counter
        # origin; wall0_ms lets a reader line the trace up with the
        # metrics.jsonl / flight-recorder wall clocks
        self._t0_ns = time.perf_counter_ns()
        self.wall0_ms = now_ms()
        # t0_ns is public API: the query-contention tracker
        # (obs.queryattr) converts its own perf_counter_ns stamps into
        # ring-relative time to intersect with ingest dispatch spans
        self._c_spans = self._c_dropped = None
        if registry is not None:
            self._c_spans = registry.counter(
                "streambench_spans_total",
                "closed spans recorded by the span tracer")
            self._c_dropped = registry.counter(
                "streambench_spans_dropped_total",
                "spans evicted from the bounded ring")

    @property
    def t0_ns(self) -> int:
        """The ring's ``perf_counter_ns`` origin: ``ts_us`` fields are
        relative to this stamp."""
        return self._t0_ns

    # ------------------------------------------------------------------
    def add(self, name: str, start_ns: int, dur_ns: int,
            cat: str = "engine", args: "dict | None" = None) -> None:
        """Record one closed span.  ``start_ns`` is a
        ``perf_counter_ns`` stamp (the Tracer's native clock); the
        thread identity is captured HERE — call from the thread that
        ran the span."""
        t = threading.current_thread()
        rec = {
            "name": name,
            "cat": cat,
            "ts_us": round((start_ns - self._t0_ns) / 1e3, 3),
            "dur_us": round(dur_ns / 1e3, 3),
            "tid": t.ident or 0,
            "thread": t.name,
        }
        if args:
            rec["args"] = dict(args)
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(rec)
        if self._c_spans is not None:
            self._c_spans.inc()
            if self.dropped:
                self._c_dropped.set_total(self.dropped)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "engine",
             args: "dict | None" = None):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter_ns() - t0,
                     cat=cat, args=args)

    def sink(self, stage: str, start_ns: int, dur_ns: int) -> None:
        """``Tracer.sink`` adapter: stage spans arrive under the
        ``"stage"`` category."""
        self.add(stage, start_ns, dur_ns, cat="stage")

    def attach(self, tracer) -> "SpanTracer":
        """Forward every span the given Tracer records into this ring."""
        tracer.sink = self.sink
        return self

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def snapshot(self) -> list[dict]:
        """Ring contents, oldest first."""
        with self._lock:
            return list(self._buf)

    def tail(self, n: int = 32) -> list[dict]:
        """The last ``n`` closed spans (flight-recorder embedding)."""
        with self._lock:
            if n >= len(self._buf):
                return list(self._buf)
            return list(self._buf)[-n:]

    # ------------------------------------------------------------------
    def chrome_trace(self, run: str = "") -> dict:
        """The ring as a Chrome trace-event JSON object (perfetto/
        chrome://tracing load it directly): ``X`` complete events on
        real thread ids + one ``thread_name`` metadata event per
        thread."""
        spans = self.snapshot()
        pid = os.getpid()
        events: list[dict] = []
        threads: dict[int, str] = {}
        for s in spans:
            threads.setdefault(s["tid"], s["thread"])
        for tid, name in sorted(threads.items()):
            events.append({"name": "thread_name", "ph": PH_METADATA,
                           "pid": pid, "tid": tid,
                           "args": {"name": name}})
        for s in spans:
            ev = {"name": s["name"], "cat": s["cat"], "ph": PH_COMPLETE,
                  "ts": s["ts_us"], "dur": s["dur_us"],
                  "pid": pid, "tid": s["tid"]}
            if "args" in s:
                ev["args"] = s["args"]
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "run": run,
                "wall0_ms": self.wall0_ms,
                "spans": len(spans),
                "spans_dropped": self.dropped,
            },
        }

    def dump(self, path: str, run: str = "") -> str:
        """Write the Chrome trace to ``path`` (tmp + rename, so a torn
        write is never mistaken for a complete trace)."""
        doc = self.chrome_trace(run=run)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


# ----------------------------------------------------------------------
# trace-file validation + summary (the ``obs trace`` CLI)
def validate_chrome_trace(doc) -> list[str]:
    """Schema problems in a Chrome trace-event object ([] = loadable).
    Checks the subset perfetto requires: a ``traceEvents`` list whose
    events carry ``name``/``ph``/``pid``/``tid``, ``X`` events with
    numeric ``ts``+``dur``, ``M`` events with an ``args`` dict."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return [f"top level is {type(doc).__name__}, not an object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                problems.append(f"{where}: missing {key!r}")
        ph = ev.get("ph")
        if ph == PH_COMPLETE:
            for key in ("ts", "dur"):
                if not isinstance(ev.get(key), (int, float)):
                    problems.append(f"{where}: X event {key!r} not "
                                    "numeric")
        elif ph == PH_METADATA:
            if not isinstance(ev.get("args"), dict):
                problems.append(f"{where}: M event without args dict")
        elif ph is not None:
            problems.append(f"{where}: unsupported ph {ph!r}")
        if len(problems) >= 20:
            problems.append("... (truncated)")
            break
    return problems


def summarize_trace(doc, path: str = "") -> dict:
    """Per-name totals + thread table of one Chrome trace object."""
    events = [e for e in doc.get("traceEvents", [])
              if isinstance(e, dict)]
    xs = [e for e in events if e.get("ph") == PH_COMPLETE]
    threads = {e["tid"]: (e.get("args") or {}).get("name", "?")
               for e in events if e.get("ph") == PH_METADATA}
    by_name: dict[str, dict] = {}
    for e in xs:
        agg = by_name.setdefault(e.get("name", "?"),
                                 {"count": 0, "total_ms": 0.0,
                                  "max_ms": 0.0})
        dur_ms = float(e.get("dur", 0)) / 1e3
        agg["count"] += 1
        agg["total_ms"] = round(agg["total_ms"] + dur_ms, 3)
        agg["max_ms"] = round(max(agg["max_ms"], dur_ms), 3)
    span_us = ((max(e["ts"] + e.get("dur", 0) for e in xs)
                - min(e["ts"] for e in xs)) if xs else 0.0)
    other = doc.get("otherData") or {}
    return {
        "path": path,
        "events": len(xs),
        "threads": {str(k): v for k, v in sorted(threads.items())},
        "trace_span_ms": round(span_us / 1e3, 3),
        "spans_dropped": other.get("spans_dropped"),
        "run": other.get("run"),
        "by_name": dict(sorted(by_name.items(),
                               key=lambda kv: -kv[1]["total_ms"])),
    }


def render_trace_summary(s: dict) -> str:
    lines = [f"span trace: {s['path'] or '(doc)'}",
             f"  events {s['events']}  span {s['trace_span_ms']:,.1f} ms"
             + (f"  dropped {s['spans_dropped']}"
                if s.get("spans_dropped") else "")]
    if s["threads"]:
        lines.append("  threads: "
                     + ", ".join(f"{tid}={name}"
                                 for tid, name in s["threads"].items()))
    if s["by_name"]:
        width = max(len(n) for n in s["by_name"])
        lines.append(f"  {'name':<{width}}  {'count':>8}  "
                     f"{'total_ms':>12}  {'max_ms':>10}")
        for name, agg in s["by_name"].items():
            lines.append(f"  {name:<{width}}  {agg['count']:>8}  "
                         f"{agg['total_ms']:>12,.1f}  "
                         f"{agg['max_ms']:>10,.3f}")
    return "\n".join(lines)
