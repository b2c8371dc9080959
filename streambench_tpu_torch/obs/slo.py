"""Config-driven latency/throughput objectives with burn-rate gates.

The port of ``streambench_tpu/obs/slo.py``.

ROADMAP item 4's live serving workload needs "load-shedding and latency
SLOs measured by the obs stack"; until now a run could only be judged
after the fact, by a human reading percentiles.  This module makes the
objective explicit and machine-checked while the run is going:

- ``jax.slo.p99.ms``   — window-latency objective: a written window is
  *bad* when its end-to-end latency exceeds this.  Evaluated over the
  lifecycle e2e histogram when attribution is on (the tracked-window
  distribution) or the writeback-latency histogram otherwise, using
  the histogram's bucket-resolution ``count_le`` — O(buckets) per
  tick, no per-window state.
- ``jax.slo.rate.evps`` — ingest objective: a sample interval is *bad*
  when its event rate falls below this while the run is supposed to be
  under load.
- ``jax.reach.slo.p99.ms`` — reach-serving objective: a served reach
  query slower than this (submit -> reply) is *bad*, judged over the
  reach server's latency histogram and reported under ``"reach"``.

Judgment is the SRE *multi-window burn rate*, not a point threshold:
an error budget (``jax.slo.budget``, default 1% of windows may be
bad) burns at ``rate = bad_fraction / budget``; a **breach** is
declared only when the budget is burning at >= ``BREACH_BURN`` over
BOTH the fast and the slow window (``jax.slo.window.{fast,slow}.s``) —
fast-only spikes get flagged as warnings in the gauges but don't flip
the verdict, and a slow-only residue of an early incident doesn't
re-page.  This is the standard two-window construction (fast window
catches onset, slow window confirms it's real) scaled down to
benchmark-run durations.

Every breach transition is journaled to ``metrics.jsonl`` as an event
record and ticked into the flight recorder; ``streambench_slo_*``
gauges expose the live burn rates; ``verdict()`` is the pass/fail
block the RunStats close line and the bench artifact carry.
"""

from __future__ import annotations

import time

#: Burn-rate threshold for a breach: the budget is being consumed at
#: at least this multiple of the sustainable rate on both windows.
#: 1.0 = "exactly on budget"; requiring > 1 on two windows keeps a
#: single straggler window from failing a whole run.
BREACH_BURN = 1.0


class SloTracker:
    """Burn-rate tracking over the live histograms.

    ``collect(rec, dt_s)`` has the MetricsSampler collector signature —
    add it AFTER ``engine_collector`` so ``rec["events"]`` is already
    populated (the rate objective reads it; absent, rate burn stays 0).
    Each tick appends one (t, windows_total, windows_bad, events,
    interval_bad) sample to a bounded ring and recomputes fast/slow
    burn rates from the ring's deltas.
    """

    def __init__(self, registry, p99_ms: int = 0, rate_evps: int = 0,
                 reach_p99_ms: int = 0,
                 budget: float = 0.01, fast_s: float = 30.0,
                 slow_s: float = 180.0, use_lifecycle: bool = False,
                 annotate=None, flightrec=None, capture=None,
                 queryattr=None, tenant: "str | None" = None,
                 clock=time.monotonic):
        # multi-tenant: a tracker scoped to one tenant is built over
        # that tenant's TenantRegistry view — its gauges and
        # get-or-create histograms pick up the ``tenant=`` label from
        # the view, so N trackers over one shared registry never share
        # an instrument.  ``tenant`` here only steers the JOURNAL shape
        # (the per-tenant block nests under
        # ``rec["slo_tenants"][name]`` instead of claiming the
        # process-wide ``rec["slo"]`` key) and stamps breach events
        # with the tenant name.
        self.tenant = tenant
        self.p99_ms = max(int(p99_ms), 0)
        self.rate_evps = max(int(rate_evps), 0)
        # jax.reach.slo.p99.ms — reach-serving latency objective: a
        # served reach query slower than this (submit -> reply) is
        # "bad".  Judged over the reach server's latency histogram with
        # the SAME two-window burn construction as the window objective.
        self.reach_p99_ms = max(int(reach_p99_ms), 0)
        self.budget = min(max(float(budget), 1e-6), 1.0)
        self.fast_s = max(float(fast_s), 1.0)
        self.slow_s = max(float(slow_s), self.fast_s)
        self.annotate = annotate       # sampler.annotate or None
        self.flightrec = flightrec
        # obs.capture.CaptureManager (or None): a breach TRANSITION
        # fires a bounded profiler capture — the deep "why was the
        # dispatch slow" evidence next to the flight dump's "that it
        # was".  The manager owns cooldown/cap policy, so a flapping
        # breach cannot profile the run to death.
        self.capture = capture
        # obs.queryattr.QueryLifecycle (or None): when the reach
        # objective breaches, the breach event carries the per-segment
        # attribution — WHICH segment (queue/batch/dispatch/reply) was
        # burning the budget, not just that the budget burned.
        self.queryattr = queryattr
        self._clock = clock
        # latency source: get-or-create with the SAME geometry as the
        # producer so the registry hands back the shared instrument
        # (lifecycle's e2e at growth 2^0.125, or attach_obs's writeback
        # histogram at the defaults)
        if use_lifecycle:
            self._hist = registry.histogram(
                "streambench_window_e2e_ms",
                "end-to-end latency of attribution-tracked windows (ms)",
                lo=0.1, hi=1e7, growth=2 ** 0.125)
        else:
            self._hist = registry.histogram(
                "streambench_window_latency_ms",
                "window writeback latency (time_updated - window_ts), ms")
        # reach latency source: get-or-create the SAME instrument the
        # ReachQueryServer feeds (default geometry on both sides)
        self._reach_hist = None
        if self.reach_p99_ms:
            from streambench_tpu_torch.reach.serve import LATENCY_HIST

            self._reach_hist = registry.histogram(
                LATENCY_HIST,
                "reach query latency, submit to reply (ms)")
        # sample ring: (t, windows_total, windows_bad, rate_ticks,
        # rate_bad_ticks, reach_total, reach_bad) — bounded by the slow
        # window at the sampler's cadence; 4096 covers a 1 s cadence for
        # over an hour
        self._ring: list[tuple] = []
        self._ring_cap = 4096
        self._rate_ticks = 0
        self._rate_bad = 0
        self.breaches = 0
        self._in_breach = False
        g = registry.gauge
        self._gauges = {
            ("latency", "fast"): g("streambench_slo_burn_rate",
                                   "error-budget burn rate",
                                   labels={"objective": "latency",
                                           "window": "fast"}),
            ("latency", "slow"): g("streambench_slo_burn_rate", "",
                                   labels={"objective": "latency",
                                           "window": "slow"}),
            ("rate", "fast"): g("streambench_slo_burn_rate", "",
                                labels={"objective": "rate",
                                        "window": "fast"}),
            ("rate", "slow"): g("streambench_slo_burn_rate", "",
                                labels={"objective": "rate",
                                        "window": "slow"}),
            ("reach", "fast"): g("streambench_slo_burn_rate", "",
                                 labels={"objective": "reach",
                                         "window": "fast"}),
            ("reach", "slow"): g("streambench_slo_burn_rate", "",
                                 labels={"objective": "reach",
                                         "window": "slow"}),
        }
        self._g_bad = g("streambench_slo_bad_windows_total",
                        "windows whose e2e latency exceeded the "
                        "jax.slo.p99.ms objective (bucket resolution)")
        self._c_breach = registry.counter(
            "streambench_slo_breaches_total",
            "breach transitions: both burn windows over threshold")

    @property
    def active(self) -> bool:
        return bool(self.p99_ms or self.rate_evps or self.reach_p99_ms)

    # ------------------------------------------------------------------
    def _window_burn(self, window_s: float, idx_total: int,
                     idx_bad: int) -> float:
        """Burn rate over the trailing ``window_s``: bad/total deltas
        between now and the newest sample at least ``window_s`` old
        (or the oldest available — early in a run the window is
        whatever history exists)."""
        if len(self._ring) < 2:
            return 0.0
        newest = self._ring[-1]
        cutoff = newest[0] - window_s
        base = self._ring[0]
        for s in reversed(self._ring[:-1]):
            if s[0] <= cutoff:
                base = s
                break
        d_total = newest[idx_total] - base[idx_total]
        d_bad = newest[idx_bad] - base[idx_bad]
        if d_total <= 0:
            return 0.0
        return (d_bad / d_total) / self.budget

    def burn_rates(self) -> dict:
        """{"latency": {"fast": x, "slow": y}, "rate": {...}} from the
        current ring."""
        out: dict = {}
        if self.p99_ms:
            out["latency"] = {
                "fast": round(self._window_burn(self.fast_s, 1, 2), 3),
                "slow": round(self._window_burn(self.slow_s, 1, 2), 3)}
        if self.rate_evps:
            out["rate"] = {
                "fast": round(self._window_burn(self.fast_s, 3, 4), 3),
                "slow": round(self._window_burn(self.slow_s, 3, 4), 3)}
        if self.reach_p99_ms:
            out["reach"] = {
                "fast": round(self._window_burn(self.fast_s, 5, 6), 3),
                "slow": round(self._window_burn(self.slow_s, 5, 6), 3)}
        return out

    def fast_burn(self) -> float:
        """Worst fast-window burn across this tracker's objectives —
        the scalar the admission controller's ``burns()`` callable
        reports per tenant (fast window: admission wants onset, the
        two-window breach verdict stays the pass/fail arbiter)."""
        burns = self.burn_rates()
        vals = [wins.get("fast", 0.0) for wins in burns.values()]
        return max(vals) if vals else 0.0

    # ------------------------------------------------------------------
    def collect(self, rec: dict, dt_s: float) -> None:
        """Sampler-collector hook: append one sample, recompute burns,
        journal breach transitions, and put the ``"slo"`` block on the
        snapshot record."""
        if not self.active:
            return
        now = self._clock()
        total = bad = 0
        if self.p99_ms:
            total = self._hist.count
            bad = total - self._hist.count_le(float(self.p99_ms))
        if self.rate_evps and dt_s > 0:
            events = rec.get("events")
            rate = rec.get("events_per_s")
            # judge only intervals that MOVED events or follow one that
            # did — a run that has not started yet is not "below rate"
            if isinstance(rate, (int, float)) and isinstance(
                    events, (int, float)) and events > 0:
                self._rate_ticks += 1
                if rate < self.rate_evps:
                    self._rate_bad += 1
        r_total = r_bad = 0
        if self._reach_hist is not None:
            r_total = self._reach_hist.count
            r_bad = r_total - self._reach_hist.count_le(
                float(self.reach_p99_ms))
        self._ring.append((now, total, bad,
                           self._rate_ticks, self._rate_bad,
                           r_total, r_bad))
        if len(self._ring) > self._ring_cap:
            del self._ring[:len(self._ring) - self._ring_cap]
        burns = self.burn_rates()
        for obj, wins in burns.items():
            for win, v in wins.items():
                self._gauges[(obj, win)].set(v)
        self._g_bad.set(bad)
        breaching = any(
            wins["fast"] >= BREACH_BURN and wins["slow"] >= BREACH_BURN
            for wins in burns.values())
        if breaching and not self._in_breach:
            self.breaches += 1
            self._c_breach.inc()
            fields = {"burn": burns, "bad_windows": bad,
                      "total_windows": total}
            if self.tenant is not None:
                fields["tenant"] = self.tenant
            if self.reach_p99_ms and self.queryattr is not None:
                # per-segment burn attribution: the breach event says
                # where the slow queries' time went
                segs = self.queryattr.segment_quantiles()
                if segs:
                    fields["reach_segments"] = segs
                fields["reach_contention_ratio"] = round(
                    self.queryattr.contention_ratio(), 4)
            if self.annotate is not None:
                try:
                    self.annotate("slo_breach", **fields)
                except Exception:
                    pass   # a closing sampler must not kill the tick
            if self.flightrec is not None:
                self.flightrec.record("slo_breach", **fields)
            if self.capture is not None:
                try:
                    self.capture.trigger("slo_breach")
                except Exception:
                    pass   # capture failure must not kill the tick
        elif not breaching and self._in_breach:
            rcv = ({"burn": burns} if self.tenant is None
                   else {"burn": burns, "tenant": self.tenant})
            if self.annotate is not None:
                try:
                    self.annotate("slo_recovered", **rcv)
                except Exception:
                    pass
            if self.flightrec is not None:
                self.flightrec.record("slo_recovered", **rcv)
        self._in_breach = breaching
        block = {"burn": burns, "bad_windows": bad,
                 "total_windows": total, "breaches": self.breaches,
                 "in_breach": breaching}
        if self.reach_p99_ms:
            block["bad_reach"] = r_bad
            block["total_reach"] = r_total
        if self.tenant is None:
            rec["slo"] = block
        else:
            rec.setdefault("slo_tenants", {})[self.tenant] = block

    # ------------------------------------------------------------------
    def verdict(self) -> dict:
        """The pass/fail block the RunStats close line carries.  PASS =
        the run never breached AND is not ending inside one."""
        burns = self.burn_rates()
        total = self._hist.count if self.p99_ms else 0
        bad = (total - self._hist.count_le(float(self.p99_ms))
               if self.p99_ms else 0)
        out = {
            "objectives": {
                **({"p99_ms": self.p99_ms} if self.p99_ms else {}),
                **({"rate_evps": self.rate_evps}
                   if self.rate_evps else {}),
                **({"reach_p99_ms": self.reach_p99_ms}
                   if self.reach_p99_ms else {}),
            },
            "budget": self.budget,
            "windows_s": {"fast": self.fast_s, "slow": self.slow_s},
            "burn": burns,
            "bad_windows": bad,
            "total_windows": total,
            "breaches": self.breaches,
            "pass": self.breaches == 0 and not self._in_breach,
        }
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self._reach_hist is not None:
            r_total = self._reach_hist.count
            out["bad_reach"] = r_total - self._reach_hist.count_le(
                float(self.reach_p99_ms))
            out["total_reach"] = r_total
            if self.queryattr is not None:
                segs = self.queryattr.segment_quantiles()
                if segs:
                    out["reach_segments"] = segs
                out["reach_contention_ratio"] = round(
                    self.queryattr.contention_ratio(), 4)
        return out
