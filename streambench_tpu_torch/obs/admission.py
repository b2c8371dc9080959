"""Measurement-actuated admission control: the multi-tenant host's
actuator.

The port of ``streambench_tpu/obs/admission.py``; pure host code.

The multi-tenant host's enforcement arm: when a victim tenant's SLO
burn rate breaches and the :class:`~streambench_tpu_torch.obs.tenancy.
DeviceTimeLedger` blame matrix names another tenant as the dominant
aggressor, the controller gates the AGGRESSOR's ingest — first
**defer** (its queued batches stay queued; nothing is lost, the
backlog absorbs the flash crowd) and, if the victim keeps burning
while the gate is up, escalate to **shed** (the host drops the
aggressor's oldest queued batches, counted per tenant).  The victim's
own ingest is never touched: fairness is enforced by measurement, not
by who shouted first.

Safety is structural, the same pattern as
:class:`~streambench_tpu_torch.obs.autoscale.AutoscaleController`:

- **priming** — the first step only records state; history can never
  read as a live breach;
- **hysteresis** — a breach must persist ``breach_ticks`` consecutive
  steps before any gate goes up, and the gate needs cross-tenant blame
  evidence (no aggressor in the matrix -> no actuation; a tenant
  burning its own budget is the autoscaler's problem, not admission's);
- **cooldowns-as-holds** — a confirmed breach inside the per-action
  cooldown is counted as a ``hold``, never acted on (chaos windows and
  fault-injection noise land here — ROBUSTNESS.md);
- **release on sustained health** — ``healthy_ticks`` consecutive
  sub-threshold steps drop every gate, journaled like any decision;
- **journaled evidence-carrying decisions** — every defer/shed/release
  lands in the decision log, the metrics.jsonl event stream, and the
  flight recorder with the victim's burn and the blame row attached,
  capped at ``DECISIONS_MAX``.

Default-off: the host constructs a controller only when
``jax.admission.enabled`` is set, and with it off the ingest path is
byte-identical (pinned, like every prior flag).
"""

from __future__ import annotations

import time

from streambench_tpu_torch.utils.ids import now_ms

#: decision journal cap (leak guard, not policy — the autoscale rule)
DECISIONS_MAX = 1024

ACTION_ADMIT = "admit"
ACTION_DEFER = "defer"
ACTION_SHED = "shed"


class AdmissionController:
    """Burn-watch → blame → gate loop over one shared-device host.

    ``burns`` is a callable returning ``{tenant: fast_burn_rate}`` for
    every tenant with an objective (the host wires it over its
    per-tenant SLO trackers); ``ledger`` is the shared
    :class:`DeviceTimeLedger`.  ``admit(tenant)`` is the hot-path
    check: one dict lookup returning ``"admit"``/``"defer"``/
    ``"shed"``.  Clock is injectable so hysteresis, cooldown and
    escalation all unit-test against a fake clock.
    """

    def __init__(self, ledger, burns, *, breach_burn: float = 1.0,
                 breach_ticks: int = 2, healthy_ticks: int = 4,
                 escalate_ticks: int = 6, cooldown_s: float = 3.0,
                 sampler=None, flightrec=None, registry=None,
                 lags=None, clock=time.monotonic):
        self.ledger = ledger
        self.burns = burns
        # optional callable -> {tenant: broker-side consumer lag}; when
        # wired (the multi-tenant host's reader_lags over the Kafka
        # adapter) every journaled decision carries the lag map, so a
        # defer gate's broker-backlog effect is evidence IN the
        # decision, not a separate scrape to correlate
        self.lags = lags
        self.breach_burn = float(breach_burn)
        self.breach_ticks = max(int(breach_ticks), 1)
        self.healthy_ticks = max(int(healthy_ticks), 1)
        self.escalate_ticks = max(int(escalate_ticks), 1)
        self.cooldown_s = float(cooldown_s)
        self.sampler = sampler
        self.flightrec = flightrec
        self._clock = clock
        self._reg = registry
        self.steps = 0
        self.holds = 0
        self._primed = False
        self._breach_streak: "dict[str, int]" = {}   # per victim
        self._healthy_streak = 0
        self._last_act: "float | None" = None
        #: aggressor -> {"mode", "victim", "since_step"}
        self._gates: "dict[str, dict]" = {}
        self.decisions: list = []
        self.actions: "dict[str, int]" = {}
        self.deferred = 0
        self.shed = 0
        self._c_decisions = None
        self._c_deferred: dict = {}
        self._c_shed: dict = {}
        if registry is not None:
            self._c_decisions = registry.counter(
                "streambench_admission_decisions_total",
                "admission gate changes (defer/shed/release) with "
                "blame evidence journaled")

    # -- hot path ------------------------------------------------------
    def admit(self, tenant: str) -> str:
        """What the host should do with this tenant's next ingest
        batch.  One dict lookup; ``"admit"`` when ungated."""
        g = self._gates.get(str(tenant))
        if g is None:
            return ACTION_ADMIT
        return g["mode"]

    def note_deferred(self, tenant: str, batches: int = 1) -> None:
        """The host left this many of ``tenant``'s batches queued under
        a defer gate (accounting only — the batches are NOT lost)."""
        self.deferred += int(batches)
        if self._reg is not None:
            c = self._c_deferred.get(tenant)
            if c is None:
                c = self._c_deferred[tenant] = self._reg.counter(
                    "streambench_admission_deferred_total",
                    "ingest batches held back by an admission defer "
                    "gate", labels={"tenant": str(tenant)})
            c.inc(batches)

    def note_shed(self, tenant: str, batches: int = 1) -> None:
        """The host dropped this many of ``tenant``'s batches under a
        shed gate (these ARE lost, and say so)."""
        self.shed += int(batches)
        if self._reg is not None:
            c = self._c_shed.get(tenant)
            if c is None:
                c = self._c_shed[tenant] = self._reg.counter(
                    "streambench_admission_shed_total",
                    "ingest batches dropped by an admission shed gate",
                    labels={"tenant": str(tenant)})
            c.inc(batches)

    # -- plumbing ------------------------------------------------------
    def _journal(self, dec: dict) -> None:
        self.decisions.append(dec)
        if len(self.decisions) > DECISIONS_MAX:
            del self.decisions[0]
        self.actions[dec["decision"]] = \
            self.actions.get(dec["decision"], 0) + 1
        if self.sampler is not None:
            self.sampler.annotate(
                "admission_decision",
                **{k: v for k, v in dec.items() if k != "ts_ms"})
        if self.flightrec is not None:
            self.flightrec.record("admission", **dec)
        if self._c_decisions is not None:
            self._c_decisions.inc()

    def _decision(self, action: str, *, aggressor: str, victim: str,
                  burn: float, blame_ms: float, **extra) -> dict:
        dec = {"decision": action, "tenant": aggressor,
               "victim": victim, "burn": round(float(burn), 3),
               "blame_ms": round(float(blame_ms), 3),
               "step": self.steps, "ts_ms": now_ms()}
        if self.lags is not None:
            try:
                lag = {str(k): int(v)
                       for k, v in (self.lags() or {}).items()}
            except Exception:
                lag = {}
            if lag:
                dec["lag"] = lag
        dec.update(extra)
        self._journal(dec)
        return dec

    # -- the loop body -------------------------------------------------
    def step(self, now: "float | None" = None) -> "dict | None":
        """One watch-maybe-gate pass.  Returns the decision dict when a
        gate changed, else None."""
        now = self._clock() if now is None else now
        self.steps += 1
        burns = {str(t): float(b) for t, b in (self.burns() or {}).items()}
        if not self._primed:
            self._primed = True
            return None   # priming: history must not read as a breach
        breaching = {t: b for t, b in burns.items()
                     if b >= self.breach_burn}
        for t in list(self._breach_streak):
            if t not in breaching:
                self._breach_streak[t] = 0
        for t in breaching:
            self._breach_streak[t] = self._breach_streak.get(t, 0) + 1

        if not breaching:
            self._healthy_streak += 1
            if self._gates and self._healthy_streak >= self.healthy_ticks:
                released = sorted(self._gates)
                g0 = self._gates[released[0]]
                self._gates.clear()
                self._healthy_streak = 0
                return self._decision(
                    "release", aggressor=",".join(released),
                    victim=g0["victim"], burn=max(burns.values(), default=0.0),
                    blame_ms=0.0, released=released)
            return None
        self._healthy_streak = 0

        # highest-burn victim with a confirmed (hysteresis-cleared)
        # breach drives the decision this step
        victim = max(breaching, key=lambda t: breaching[t])
        if self._breach_streak[victim] < self.breach_ticks:
            return None
        blame = self.ledger.aggressor_for(victim)
        if blame is None:
            return None   # no cross-tenant evidence -> never actuate
        aggressor, blame_ms = blame
        if aggressor == victim:
            return None
        gate = self._gates.get(aggressor)
        if gate is not None:
            # escalate a defer that isn't working to shed
            if (gate["mode"] == ACTION_DEFER
                    and self.steps - gate["since_step"]
                    >= self.escalate_ticks):
                if not self._cool(now):
                    self.holds += 1
                    return None
                gate["mode"] = ACTION_SHED
                gate["since_step"] = self.steps
                self._last_act = now
                return self._decision(
                    ACTION_SHED, aggressor=aggressor, victim=victim,
                    burn=breaching[victim], blame_ms=blame_ms,
                    escalated=True)
            return None
        if not self._cool(now):
            self.holds += 1
            return None
        self._gates[aggressor] = {"mode": ACTION_DEFER,
                                  "victim": victim,
                                  "since_step": self.steps}
        self._last_act = now
        return self._decision(
            ACTION_DEFER, aggressor=aggressor, victim=victim,
            burn=breaching[victim], blame_ms=blame_ms)

    def _cool(self, now: float) -> bool:
        return (self._last_act is None
                or now - self._last_act >= self.cooldown_s)

    # -- reporting -----------------------------------------------------
    def gates(self) -> dict:
        return {t: dict(g) for t, g in self._gates.items()}

    def summary(self) -> dict:
        out = {
            "steps": self.steps,
            "decisions": len(self.decisions),
            "defers": self.actions.get(ACTION_DEFER, 0),
            "sheds": self.actions.get(ACTION_SHED, 0),
            "releases": self.actions.get("release", 0),
            "holds": self.holds,
            "batches_deferred": self.deferred,
            "batches_shed": self.shed,
            "gates": self.gates(),
            "breach_burn": self.breach_burn,
        }
        if self.decisions:
            last = self.decisions[-1]
            out["last"] = {k: last.get(k) for k in
                           ("decision", "tenant", "victim", "burn",
                            "blame_ms", "ts_ms")}
        return out
