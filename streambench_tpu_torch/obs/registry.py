"""Live metrics registry: counters, gauges, log-bucketed histograms.

The engine's existing signals are all post-hoc — the ``Tracer`` span
table, the ``LatencyTracker`` decile report, and ``FaultCounters`` only
surface after the run exits (``engine/__main__.py``).  This module is the
*live* complement: a registry of named instruments a background sampler
(``obs.sampler``) reads every tick and a Prometheus endpoint
(``obs.httpd``) exposes on demand, while the run is still going.  SALSA
(PAPERS.md, arxiv 2102.12531) makes the same argument for streaming
systems generally: adaptation needs continuous occupancy signals, not an
exit report.

Design constraints, in priority order:

- **zero hot-path cost when unused** — nothing here is ever called
  unless the engine was explicitly attached (``attach_obs``); the
  default engine carries only a ``None`` attribute.
- **O(1) ``observe``** — the streaming histogram is log-bucketed
  (geometric bucket bounds): one log + one locked increment per sample,
  no per-sample storage, so percentiles stay queryable mid-run at any
  sample volume.  It *complements* the exact close-time decile table in
  ``metrics.LatencyTracker`` — that one is exact but only available at
  the end; this one is ~±12% (one bucket) but live.
- **thread-safe** — instruments are written from the writer thread and
  read from the sampler + HTTP threads concurrently.
"""

from __future__ import annotations

import math
import threading


def _fmt_labels(labels: "dict[str, str] | None") -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    """Prometheus text-exposition number (integers without the .0)."""
    if v != v:  # NaN
        return "NaN"
    if isinstance(v, bool):
        return str(int(v))
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonic counter.  ``inc`` for push-style use; ``set_total`` for
    poll-style collectors that mirror an already-cumulative engine field
    (monotonic by construction — a lower value is ignored)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: "dict[str, str] | None" = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0
        self._lock = threading.Lock()

    @property
    def value(self):
        with self._lock:
            return self._value

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def set_total(self, total: float) -> None:
        with self._lock:
            if total > self._value:
                self._value = total

    def render(self) -> list[str]:
        return [f"{self.name}{_fmt_labels(self.labels)} "
                f"{_fmt_value(self.value)}"]


class Gauge:
    """Point-in-time value (backlog bytes, watermark lag, RSS...)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: "dict[str, str] | None" = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value: float = 0.0
        self._lock = threading.Lock()

    @property
    def value(self):
        with self._lock:
            return self._value

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def render(self) -> list[str]:
        return [f"{self.name}{_fmt_labels(self.labels)} "
                f"{_fmt_value(self.value)}"]


class StreamingHistogram:
    """Log-bucketed streaming histogram: O(1) observe, no sample storage.

    Bucket upper bounds grow geometrically from ``lo`` by ``growth`` per
    bucket (default ~19%/bucket: quantiles are exact to within one
    bucket, i.e. a bounded *relative* error — the right shape for
    latencies spanning ms..hours).  ``observe`` is one ``math.log`` plus
    a locked integer increment; quantile queries walk the (~100-entry)
    bucket array.  Samples at or below ``lo`` land in bucket 0; above
    ``hi`` in the overflow bucket whose reported bound is ``+Inf``.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", lo: float = 1.0,
                 hi: float = 1e7, growth: float = 2 ** 0.25,
                 labels: "dict[str, str] | None" = None):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(f"bad histogram geometry lo={lo} hi={hi} "
                             f"growth={growth}")
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lo = lo
        self._log_growth = math.log(growth)
        n = int(math.ceil(math.log(hi / lo) / self._log_growth))
        # bounds[i] is the inclusive upper bound of bucket i; one extra
        # overflow bucket past bounds[-1] catches everything else
        self._bounds = [lo * growth ** (i + 1) for i in range(n)]
        self._counts = [0] * (n + 2)   # [<=lo, n geometric, overflow]
        self._count = 0
        self._sum = 0.0
        self._min: float | None = None
        self._max: float | None = None
        self._lock = threading.Lock()

    def _index(self, x: float) -> int:
        if x <= self._lo:
            return 0
        i = int(math.log(x / self._lo) / self._log_growth) + 1
        return min(i, len(self._counts) - 1)

    def observe(self, x: float) -> None:
        i = self._index(x)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += x
            if self._min is None or x < self._min:
                self._min = x
            if self._max is None or x > self._max:
                self._max = x

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def count_le(self, x: float) -> int:
        """Samples at or below ``x``, at bucket resolution: the bucket
        containing ``x`` is counted whole (its upper bound is the first
        one >= x), so the answer can over-include by at most one
        bucket's worth — the same one-bucket error contract as the
        quantiles.  The SLO burn-rate tracker's good/bad split."""
        i = self._index(x)
        with self._lock:
            return sum(self._counts[:i + 1])

    def _upper(self, i: int) -> float:
        if i == 0:
            return self._lo
        if i - 1 < len(self._bounds):
            return self._bounds[i - 1]
        return math.inf

    def quantiles(self, qs) -> list[float]:
        """Bucket-upper-bound quantiles for each q in ``qs`` (one pass).
        Clamped to the observed max so p99 of a tight distribution
        doesn't report a bucket bound past any real sample."""
        with self._lock:
            total = self._count
            if total == 0:
                return [math.nan] * len(qs)
            counts = list(self._counts)
            mx = self._max
        out: list[float] = []
        for q in qs:
            rank = max(min(q, 1.0), 0.0) * total
            acc = 0.0
            val = mx
            for i, c in enumerate(counts):
                acc += c
                if acc >= rank and c:
                    val = min(self._upper(i), mx)
                    break
            out.append(val)
        return out

    def summary(self) -> dict:
        """Point-in-time {count, sum, min, max, p50, p95, p99} dict —
        the shape the sampler journals every tick.  Empty histograms
        emit ``{"count": 0}`` alone: NaN percentiles would round-trip
        through JSON as the non-standard ``NaN`` token (or crash strict
        parsers), and a reader must not mistake "no samples" for "zero
        latency"."""
        if self.count == 0:
            return {"count": 0}
        p50, p95, p99 = self.quantiles((0.5, 0.95, 0.99))
        with self._lock:
            return {"count": self._count, "sum": round(self._sum, 3),
                    "min": self._min, "max": self._max,
                    "p50": p50, "p95": p95, "p99": p99}

    def render(self) -> list[str]:
        """Real Prometheus histogram exposition: cumulative ``_bucket``
        lines + ``_sum``/``_count``.  Bucket lines are emitted sparsely
        — every OCCUPIED bucket, the immediate lower neighbor of each
        occupied bucket (the lower edge of every occupied range stays
        on record, so quantile interpolation keeps its one-bucket
        resolution), plus the first and the ``+Inf`` bucket.
        Semantically identical to full emission (each bucket is its
        own cumulative series; an omitted bound between two emitted
        ones whose cumulative equals its lower neighbor's carries no
        information) but keeps a ~190-bucket segment-histogram family
        from dominating every scrape with runs of repeated numbers.
        The quantile summaries the report CLI reads (``summary()``)
        are unchanged."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            s = self._sum
        lines = []
        acc = 0
        base = dict(self.labels)
        last = len(counts) - 1
        for i, c in enumerate(counts):
            acc += c
            nxt = counts[i + 1] if i < last else 0
            if not (i == 0 or i == last or c or nxt):
                continue
            ub = self._upper(i)
            le = "+Inf" if ub == math.inf else _fmt_value(round(ub, 6))
            lines.append(f"{self.name}_bucket"
                         f"{_fmt_labels({**base, 'le': le})} {acc}")
        lines.append(f"{self.name}_sum{_fmt_labels(base)} {_fmt_value(s)}")
        lines.append(f"{self.name}_count{_fmt_labels(base)} {total}")
        return lines


class MetricsRegistry:
    """Get-or-create registry of named instruments.

    Instruments are keyed by (name, sorted labels) so per-stage/per-kind
    label families (``streambench_faults_total{kind=...}``) share one
    name.  ``render_prometheus`` emits the standard text exposition
    (one ``# TYPE`` per family).
    """

    def __init__(self) -> None:
        self._metrics: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str,
             labels: "dict[str, str] | None", **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, help=help,
                                             labels=labels, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: "dict[str, str] | None" = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: "dict[str, str] | None" = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", lo: float = 1.0,
                  hi: float = 1e7, growth: float = 2 ** 0.25,
                  labels: "dict[str, str] | None" = None
                  ) -> StreamingHistogram:
        return self._get(StreamingHistogram, name, help, labels,
                         lo=lo, hi=hi, growth=growth)

    def predeclare(self, kind: str, name: str, help: str = "",
                   label_sets: "list[dict | None] | None" = None,
                   **kw) -> None:
        """Eagerly create an instrument family (one instrument per
        label set) so a scrape BEFORE the first feed returns it with
        zero samples instead of omitting the family — the lazy-
        instrument gap: per-format/per-tenant instruments created at
        first dispatch are invisible to early Prometheus scrapes, and
        harnesses end up polling the endpoint until they appear."""
        maker = {"counter": self.counter, "gauge": self.gauge,
                 "histogram": self.histogram}[kind]
        for labels in (label_sets or [None]):
            maker(name, help, labels=labels, **kw)

    def collect(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def render_prometheus(self) -> str:
        """Text exposition format (version 0.0.4): families grouped, one
        ``# HELP``/``# TYPE`` header per family name."""
        by_name: dict[str, list] = {}
        for m in self.collect():
            by_name.setdefault(m.name, []).append(m)
        lines: list[str] = []
        for name in sorted(by_name):
            fam = by_name[name]
            help_text = next((m.help for m in fam if m.help), "")
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {fam[0].kind}")
            for m in fam:
                lines.extend(m.render())
        return "\n".join(lines) + "\n"
