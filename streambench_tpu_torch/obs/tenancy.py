"""Multi-tenant observability: tenant-scoped metric views + the
shared-device time ledger and blame matrix.

The port of ``streambench_tpu/obs/tenancy.py``; pure host code.

Everything before this layer assumed one workload per process: one
metric namespace, one SLO, one occupancy sampler.  The north star is
the opposite shape — N topologies sharing one process and one
accelerator — and the moment two engines share a device the first
operational question becomes *whose dispatch burned whose SLO budget*.
This module adds the tenant dimension in two pieces:

- :class:`TenantRegistry` — a thin view over one shared
  :class:`~streambench_tpu_torch.obs.registry.MetricsRegistry` that injects a
  ``tenant=<name>`` label into every instrument it creates.  The
  registry already keys instruments by ``(name, sorted labels)``, so
  two tenants touching the same family get *disjoint* instruments for
  free — isolation is a property of the keying, not of any new
  bookkeeping, and one Prometheus scrape federates all tenants with
  the label doing the namespacing.  Engines, SLO trackers and query
  lifecycles take the view wherever they took the registry; they
  cannot tell the difference (same ``counter/gauge/histogram/
  predeclare`` surface).

- :class:`DeviceTimeLedger` — attribution of *device time* to tenants.
  Each tenant's :class:`~streambench_tpu_torch.obs.occupancy.OccupancySampler`
  feeds its sampled CUDA-event busy windows (host ``perf_counter_ns``
  around the event wait) into the ledger via
  :meth:`DeviceTimeLedger.busy_sink` (the same hook that feeds the
  reach contention ratio), and each tenant's measured *wait*
  intervals — host queue wait for batch tenants, the reach server's
  admit→pop pairs for a serving tenant — land via :meth:`note_wait`.
  The **blame matrix** generalizes the reach contention ratio to
  N×N: cell ``[victim][aggressor]`` is the overlap of the victim's
  wait intervals with the aggressor's merged device-busy windows.  The
  diagonal is self-inflicted wait (your own dispatches ahead of you);
  off-diagonal mass is cross-tenant interference — the evidence an
  admission controller acts on and a diagnose verdict names.

  Clock discipline: busy windows stamp ``perf_counter_ns`` (the
  occupancy sampler's clock) and the reach server's wait pairs stamp
  ``monotonic``-derived ns — on Linux both read CLOCK_MONOTONIC, so
  the intersection is well-defined; on platforms where they diverge
  the overlap degrades toward zero (missing evidence, never wrong
  evidence — the queryattr rule).

  The **partition invariant** (tested, same ±slack discipline as the
  freshness hops): the per-tenant attributed busy totals must
  sum to the samplers' total measured busy time.  Attribution that
  loses or double-counts device time would silently skew every blame
  cell; :meth:`partition_check` makes the conservation law executable.

Default-off like every obs layer: nothing here is constructed unless
the host was started with tenants declared.
"""

from __future__ import annotations

import threading
from collections import deque

from streambench_tpu_torch.obs.queryattr import _interval_overlap_ns

#: Bounded per-tenant interval rings (busy + wait): a week-long run
#: keeps the *recent* interference picture, while the ns totals (which
#: the partition check audits) accumulate unbounded alongside.
INTERVALS_MAX = 4096

#: Partition-check slack: sampled busy windows and their attributed
#: copies are the same integers, so the expected error is zero — the
#: slack only absorbs float/rounding noise, same discipline as the
#: freshness-hop reconciliation.
PARTITION_SLACK = 0.01


def _merge(intervals: list) -> list:
    """Sort-and-merge [start_ns, end_ns) pairs (the queryattr merge)."""
    if not intervals:
        return []
    intervals = sorted(intervals)
    merged = [list(intervals[0])]
    for s_ns, e_ns in intervals[1:]:
        if s_ns <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e_ns)
        else:
            merged.append([s_ns, e_ns])
    return merged


class TenantRegistry:
    """Tenant-scoped view over a shared :class:`MetricsRegistry`.

    Injects ``tenant=<name>`` into the labels of every instrument
    created through it, then delegates — the shared registry's
    ``(name, sorted labels)`` keying does the isolation.  A caller
    passing an explicit ``tenant`` label that disagrees with the view's
    own name is a bug caught loudly, not silently relabeled.
    """

    def __init__(self, registry, tenant: str):
        if not tenant:
            raise ValueError("tenant name must be non-empty")
        self.registry = registry
        self.tenant = str(tenant)

    def _labels(self, labels: "dict | None") -> dict:
        out = dict(labels or {})
        prev = out.setdefault("tenant", self.tenant)
        if prev != self.tenant:
            raise ValueError(
                f"instrument labeled tenant={prev!r} created through "
                f"the {self.tenant!r} view — cross-tenant label bleed")
        return out

    def counter(self, name: str, help: str = "", labels=None):
        return self.registry.counter(name, help,
                                     labels=self._labels(labels))

    def gauge(self, name: str, help: str = "", labels=None):
        return self.registry.gauge(name, help,
                                   labels=self._labels(labels))

    def histogram(self, name: str, help: str = "", lo: float = 1.0,
                  hi: float = 1e7, growth: float = 2 ** 0.25,
                  labels=None):
        return self.registry.histogram(name, help, lo=lo, hi=hi,
                                       growth=growth,
                                       labels=self._labels(labels))

    def predeclare(self, kind: str, name: str, help: str = "",
                   label_sets=None, **kw) -> None:
        self.registry.predeclare(
            kind, name, help,
            label_sets=[self._labels(ls) for ls in (label_sets or [None])],
            **kw)

    # federation helpers ------------------------------------------------
    def collect(self) -> list:
        """Only this tenant's instruments (label-filtered)."""
        return [m for m in self.registry.collect()
                if m.labels.get("tenant") == self.tenant]

    def render_prometheus(self) -> str:
        """The WHOLE shared exposition — a scrape is per-process, and
        the ``tenant=`` label is the namespacing, not the endpoint."""
        return self.registry.render_prometheus()


class DeviceTimeLedger:
    """Per-tenant device-time attribution + the N×N blame matrix.

    ``busy_sink(tenant)`` returns the callable an OccupancySampler's
    ``busy_sink`` hook wants; ``note_wait`` records a tenant's measured
    wait interval (host queue wait, reach admit→pop).  All writes are
    O(1) appends under one lock; the matrix is computed on demand
    (sampler cadence / bench close), never on the hot path.
    """

    def __init__(self, registry=None, max_intervals: int = INTERVALS_MAX):
        self._lock = threading.Lock()
        self._max = max(int(max_intervals), 1)
        self._busy: "dict[str, deque]" = {}
        self._wait: "dict[str, deque]" = {}
        self.busy_ns: "dict[str, int]" = {}
        self.wait_ns: "dict[str, int]" = {}
        self._reg = registry
        self._c_busy: dict = {}
        self._c_wait: dict = {}

    def _tenant(self, tenant: str) -> str:
        t = str(tenant)
        if t not in self._busy:
            self._busy[t] = deque(maxlen=self._max)
            self._wait[t] = deque(maxlen=self._max)
            self.busy_ns.setdefault(t, 0)
            self.wait_ns.setdefault(t, 0)
            if self._reg is not None:
                self._c_busy[t] = self._reg.counter(
                    "streambench_tenant_device_busy_ms_total",
                    "sampled device-busy time attributed to a tenant "
                    "(ms)", labels={"tenant": t})
                self._c_wait[t] = self._reg.counter(
                    "streambench_tenant_wait_ms_total",
                    "measured queue/stall wait attributed to a tenant "
                    "(ms)", labels={"tenant": t})
        return t

    def declare(self, tenant: str) -> None:
        """Pre-declare a tenant (zero-valued rows from the first
        scrape, the same lazy-instrument fix as the registry's
        ``predeclare``)."""
        with self._lock:
            self._tenant(tenant)

    # writes ------------------------------------------------------------
    def note_busy(self, tenant: str, t0_ns: int, t1_ns: int) -> None:
        if t1_ns <= t0_ns:
            return
        with self._lock:
            t = self._tenant(tenant)
            self._busy[t].append((int(t0_ns), int(t1_ns)))
            self.busy_ns[t] += int(t1_ns) - int(t0_ns)
            c = self._c_busy.get(t)
        if c is not None:
            c.inc((t1_ns - t0_ns) / 1e6)

    def note_wait(self, tenant: str, t0_ns: int, t1_ns: int) -> None:
        if t1_ns <= t0_ns:
            return
        with self._lock:
            t = self._tenant(tenant)
            self._wait[t].append((int(t0_ns), int(t1_ns)))
            self.wait_ns[t] += int(t1_ns) - int(t0_ns)
            c = self._c_wait.get(t)
        if c is not None:
            c.inc((t1_ns - t0_ns) / 1e6)

    def busy_sink(self, tenant: str):
        """The ``fn(t0_ns, t1_ns)`` an OccupancySampler's ``busy_sink``
        hook takes, bound to one tenant."""
        with self._lock:
            self._tenant(tenant)
        return lambda t0_ns, t1_ns: self.note_busy(tenant, t0_ns, t1_ns)

    # reads -------------------------------------------------------------
    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._busy)

    def merged_busy(self, tenant: str) -> list:
        with self._lock:
            raw = list(self._busy.get(str(tenant), ()))
        return _merge(raw)

    def blame_matrix(self) -> dict:
        """The N×N interference picture.

        ``matrix_ms[victim][aggressor]`` = victim's wait intervals ∩
        aggressor's merged busy windows, in ms.  Also reports each
        victim's total wait, each tenant's attributed busy total, and
        ``offdiag_ratio`` — cross-tenant blame mass over total blame
        mass (0.0 = everyone only waits on themselves; the regress key
        ``tenant_blame_offdiag_ratio`` reads this).
        """
        with self._lock:
            names = sorted(self._busy)
            waits = {t: list(self._wait[t]) for t in names}
            raw_busy = {t: list(self._busy[t]) for t in names}
            busy_ns = dict(self.busy_ns)
            wait_ns = dict(self.wait_ns)
        merged = {t: _merge(raw_busy[t]) for t in names}
        matrix: "dict[str, dict[str, float]]" = {}
        diag = offdiag = 0.0
        for victim in names:
            row: dict[str, float] = {}
            for aggressor in names:
                ov = 0
                if merged[aggressor]:
                    for w0, w1 in waits[victim]:
                        ov += _interval_overlap_ns(
                            w0, w1, merged[aggressor])
                ms = round(ov / 1e6, 3)
                row[aggressor] = ms
                if victim == aggressor:
                    diag += ms
                else:
                    offdiag += ms
            matrix[victim] = row
        total = diag + offdiag
        return {
            "tenants": names,
            "matrix_ms": matrix,
            "wait_ms": {t: round(wait_ns[t] / 1e6, 3) for t in names},
            "busy_ms": {t: round(busy_ns[t] / 1e6, 3) for t in names},
            "offdiag_ratio": round(offdiag / total, 4) if total else 0.0,
        }

    def aggressor_for(self, victim: str) -> "tuple[str, float] | None":
        """The OTHER tenant whose busy windows overlap this victim's
        waits the most: ``(name, blame_ms)``, or None when no
        cross-tenant blame exists — an admission controller must not
        act on absent evidence."""
        m = self.blame_matrix()
        row = m["matrix_ms"].get(str(victim))
        if not row:
            return None
        best = None
        for aggressor, ms in row.items():
            if aggressor == str(victim) or ms <= 0:
                continue
            if best is None or ms > best[1]:
                best = (aggressor, ms)
        return best

    # invariants --------------------------------------------------------
    def partition_check(self, sampler_busy_ns,
                        slack: float = PARTITION_SLACK) -> dict:
        """Conservation law: Σ per-tenant attributed busy ==
        Σ samplers' measured busy, within ``slack`` (relative).

        ``sampler_busy_ns`` is ``{tenant: busy_ns}`` read straight off
        each tenant's OccupancySampler — the ground truth the ledger's
        attribution must neither lose nor double-count.  Returns the
        check record the bench artifact commits; ``ok`` False means
        attribution is broken and every blame cell is suspect.
        """
        with self._lock:
            attributed = dict(self.busy_ns)
        total_attr = sum(attributed.values())
        total_meas = sum(int(v) for v in sampler_busy_ns.values())
        err = (abs(total_attr - total_meas) / total_meas
               if total_meas else (1.0 if total_attr else 0.0))
        per_tenant = {}
        ok = err <= slack
        for t, meas in sampler_busy_ns.items():
            a = attributed.get(str(t), 0)
            t_err = abs(a - int(meas)) / int(meas) if meas else (
                1.0 if a else 0.0)
            per_tenant[str(t)] = {
                "attributed_ms": round(a / 1e6, 3),
                "measured_ms": round(int(meas) / 1e6, 3),
                "rel_err": round(t_err, 6),
            }
            ok = ok and t_err <= slack
        return {
            "ok": ok,
            "attributed_ms": round(total_attr / 1e6, 3),
            "measured_ms": round(total_meas / 1e6, 3),
            "rel_err": round(err, 6),
            "slack": slack,
            "tenants": per_tenant,
        }

    def summary(self) -> dict:
        """The ``multitenant`` block a metrics.jsonl snapshot carries:
        the blame matrix plus interval census."""
        m = self.blame_matrix()
        with self._lock:
            m["intervals"] = {
                t: {"busy": len(self._busy[t]),
                    "wait": len(self._wait[t])}
                for t in sorted(self._busy)}
        return m
