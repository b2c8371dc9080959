"""Crash flight recorder: a bounded black box every failed run leaves.

``metrics.jsonl`` is a time series for runs that LIVE; a run that dies
mid-window leaves at best a truncated tail and a bare traceback.  The
:class:`FlightRecorder` is the postmortem complement: a lock-guarded
bounded ring of structured records that the runner (flush-cadence ticks,
checkpoint offsets), the staged ingest pipeline (stalls, stage errors),
and the chaos supervisor (crash/restart annotations) feed continuously
— and that is dumped to ``<workdir>/flight_<reason>.jsonl`` the moment
something terminal happens: an engine crash, a supervisor ``give_up``, a
fatal exception, or SIGTERM.  The airliner model exactly: recording is
cheap and always-on (when enabled), the file only exists after an
incident, and the LAST record is the terminal fault that ended the run.

Cost: one dict + deque append under a lock per record; the feeders
record at flush cadence (~1 Hz) plus rare events, so the hot path never
sees it.  Default-off (``jax.obs.flightrec.enabled``): a ``None``
recorder costs the engine one attribute check per flush cycle.
"""

from __future__ import annotations

import json
import os
import re
import threading
from collections import deque

from streambench_tpu_torch.utils.ids import now_ms


class FlightRecorder:
    """Bounded ring of structured records + atomic crash dumps.

    ``record(kind, **fields)`` appends one record (any thread); ``dump``
    freezes the ring into ``flight_<reason>.jsonl``, appending the
    caller's ``terminal`` record last so a reader can open the file and
    see what killed the run on the final line.  Sequence numbers are
    process-monotonic across all feeders, so interleaved runner /
    pipeline / supervisor records read back in true order.
    """

    #: Spans embedded per dump when a span source is wired (bounded so
    #: the black box stays a black box, not a full trace file).
    SPAN_TAIL = 64

    def __init__(self, workdir: str, capacity: int = 512):
        self.workdir = workdir
        self.capacity = max(int(capacity), 8)
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.dumps: list[str] = []   # paths written, in order
        # Optional ``tail(n) -> list[dict]`` of recently closed spans
        # (obs.spans.SpanTracer.tail): when set, every dump embeds a
        # ``spans`` record just before the terminal one, so the crash
        # postmortem carries the timing context of the final seconds —
        # what the engine was actually DOING when it died, not only
        # what its counters said.
        self.span_source = None

    # ------------------------------------------------------------------
    def _stamp(self, kind: str, fields: dict) -> dict:
        self._seq += 1
        return {"seq": self._seq, "ts_ms": now_ms(), "kind": kind,
                **fields}

    def record(self, kind: str, **fields) -> None:
        """Append one record (any thread, any feeder)."""
        with self._lock:
            self._buf.append(self._stamp(kind, fields))

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def snapshot(self) -> list[dict]:
        """Current ring contents, oldest first (tests/diagnostics)."""
        with self._lock:
            return list(self._buf)

    # ------------------------------------------------------------------
    def dump(self, reason: str, terminal: "dict | None" = None) -> str:
        """Write the ring to ``<workdir>/flight_<reason>.jsonl``.

        ``terminal`` (recommended) is appended as the LAST record —
        stamped like any other, ``kind`` defaulting to ``"fault"`` — so
        the file ends with what ended the run.  Never overwrites: a
        second dump for the same reason gets a ``.2``/``.3`` suffix
        (every supervised crash keeps its own black box).  The write is
        tmp + rename, so a half-written dump is never mistaken for a
        complete one.
        """
        spans = None
        if self.span_source is not None:
            try:
                spans = list(self.span_source(self.SPAN_TAIL))
            except Exception:
                spans = None   # a broken tracer must not eat the dump
        with self._lock:
            records = list(self._buf)
            if spans is not None:
                # dump-only record (never enters the ring: a later dump
                # for a different reason gets ITS OWN fresh span tail,
                # and the bounded ring keeps its capacity for feeders)
                records.append(self._stamp("spans", {"spans": spans}))
            if terminal is not None:
                t = dict(terminal)
                kind = t.pop("kind", "fault")
                term = self._stamp(kind, t)
                self._buf.append(term)
                records.append(term)
        safe = re.sub(r"[^A-Za-z0-9_.-]+", "_", str(reason)) or "unknown"
        os.makedirs(self.workdir, exist_ok=True)
        path = os.path.join(self.workdir, f"flight_{safe}.jsonl")
        i = 2
        while os.path.exists(path):
            path = os.path.join(self.workdir, f"flight_{safe}.{i}.jsonl")
            i += 1
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        os.replace(tmp, path)
        with self._lock:
            self.dumps.append(path)
        return path
