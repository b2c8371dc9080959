"""Obs-actuated replica autoscaler.

The port's copy of ``streambench_tpu/obs/autoscale.py`` (host code, no
torch).  :class:`AutoscaleController` closes the loop from diagnosis to
knob: run :func:`~streambench_tpu_torch.obs.diagnose.diagnose` over a
window of fleet evidence on a cadence, and turn the prescribed knob —

- ``replica_count``: spawn through an injected ``spawn_replica()``
  hook (the smoke wires it to ``FleetSupervisor.spawn()`` + ``router.
  add_replica``), retire through ``retire_replica()`` (graceful:
  deregister -> drain -> stop) after a sustained healthy streak;
- ``ship_cadence``: halve ``SnapshotShipper.interval_ms`` down to a
  floor;
- ``poll_interval``: halve the replica tail poll through a
  ``set_poll_ms(new_ms)`` hook down to a floor;
- ``batch_cadence``: an opaque ``tune_batch(verdict)`` hook (the
  serving tier owns its own batch/drain semantics).

Safety is structural, not hopeful: **hysteresis** (a breach must
persist ``breach_ticks`` consecutive steps before anything actuates),
**per-knob cooldowns** (chaos-induced noise inside a cooldown is
counted as a ``hold``, never acted on — ROBUSTNESS.md "controller x
fleet chaos"), **bounds** (min/max replicas, cadence/poll floors), and
a **priming step** (the first window only records state, so a
controller attached to an old journal can't mistake history for a
live breach).  The clock is injectable (the FleetSupervisor
testing pattern) so every one of those behaviors unit-tests against a
fake clock.

Every decision is journaled as a ``kind="event"`` record
(``event="autoscale_decision"``) carrying the verdict + freshness-hop
p99 evidence that justified it, mirrored into the FlightRecorder, and
counted on ``streambench_autoscale_{decisions,replicas,
shed_redirects}_total``; ``obs fleet`` renders the summary as a
controller sub-line.  Default-off like every obs layer: nothing
constructs one unless asked, and a constructed controller with no
hooks wired actuates nothing.
"""

from __future__ import annotations

import time

from streambench_tpu_torch.obs.diagnose import (
    KNOB_BATCH,
    KNOB_POLL,
    KNOB_REPLICAS,
    KNOB_SHIP,
    VERDICT_HEALTHY,
    diagnose,
    evidence_window,
)
from streambench_tpu_torch.utils.ids import now_ms

#: decision journal cap (the controller runs for a rung, not a
#: quarter — the bound is a leak guard, not a policy)
DECISIONS_MAX = 1024


class AutoscaleController:
    """Diagnose-then-actuate on a cadence.  ``collect`` is a callable
    returning the current attributed fleet records (live
    ``FleetCollector.collect`` or any test fake); everything that
    touches the world is an optional injected hook."""

    def __init__(self, collect, *, objective: dict,
                 spawn_replica=None, retire_replica=None,
                 shipper=None, min_ship_interval_ms: int = 100,
                 set_poll_ms=None, poll_ms: "int | None" = None,
                 min_poll_ms: int = 20, tune_batch=None,
                 replicas: int = 1, min_replicas: int = 1,
                 max_replicas: int = 4,
                 breach_ticks: int = 2, healthy_ticks: int = 6,
                 cooldown_s: float = 5.0,
                 cooldowns: "dict | None" = None,
                 window_steps: int = 8,
                 sampler=None, flightrec=None, registry=None,
                 clock=time.monotonic, sleep=time.sleep):
        self.collect = collect
        self.objective = dict(objective)
        self.spawn_replica = spawn_replica
        self.retire_replica = retire_replica
        self.shipper = shipper
        self.min_ship_interval_ms = int(min_ship_interval_ms)
        self.set_poll_ms = set_poll_ms
        self._poll_ms = int(poll_ms) if poll_ms is not None else None
        self.min_poll_ms = int(min_poll_ms)
        self.tune_batch = tune_batch
        self.replicas = int(replicas)
        self.min_replicas = max(int(min_replicas), 1)
        self.max_replicas = max(int(max_replicas), self.min_replicas)
        self.breach_ticks = max(int(breach_ticks), 1)
        self.healthy_ticks = max(int(healthy_ticks), 1)
        self.cooldown_s = float(cooldown_s)
        self._cooldowns = dict(cooldowns or {})
        self.window_steps = max(int(window_steps), 1)
        self.sampler = sampler
        self.flightrec = flightrec
        self._clock = clock
        self._sleep = sleep
        self._history: list = []       # evidence windows, oldest first
        self._last_act: dict = {}      # knob -> monotonic stamp
        self._last_failovers = 0
        self._breach_streak = 0
        self._healthy_streak = 0
        self.steps = 0
        self.holds = 0                 # breach confirmed, knob cooling
        self.at_limit = 0              # knob already at its bound
        self.shed_redirects = 0
        self.decisions: list = []
        self.actions: dict = {}
        self.last_verdicts: list = []
        self._c_decisions = self._g_replicas = self._c_redirects = None
        if registry is not None:
            self._c_decisions = registry.counter(
                "streambench_autoscale_decisions_total",
                "autoscale knob actuations (scale up/down, cadence and "
                "poll tunes) with verdict evidence journaled")
            self._g_replicas = registry.gauge(
                "streambench_autoscale_replicas_total",
                "replica count the controller currently holds")
            self._g_replicas.set(self.replicas)
            self._c_redirects = registry.counter(
                "streambench_autoscale_shed_redirects_total",
                "replica sheds the router converted into failover "
                "answers while the controller held the fleet")

    # -- plumbing ------------------------------------------------------
    def _cooldown_for(self, knob: str) -> float:
        return float(self._cooldowns.get(knob, self.cooldown_s))

    def _cool(self, knob: str, now: float) -> bool:
        last = self._last_act.get(knob)
        return last is None or now - last >= self._cooldown_for(knob)

    def _journal(self, dec: dict) -> None:
        self.decisions.append(dec)
        if len(self.decisions) > DECISIONS_MAX:
            del self.decisions[0]
        self.actions[dec["decision"]] = \
            self.actions.get(dec["decision"], 0) + 1
        if self.sampler is not None:
            self.sampler.annotate(
                "autoscale_decision",
                **{k: v for k, v in dec.items() if k != "ts_ms"})
        if self.flightrec is not None:
            self.flightrec.record("autoscale", **dec)
        if self._c_decisions is not None:
            self._c_decisions.inc()
        if self._g_replicas is not None:
            self._g_replicas.set(self.replicas)

    def _decision(self, action: str, verdict: dict, **extra) -> dict:
        dec = {"decision": action, "verdict": verdict["verdict"],
               "knob": verdict.get("knob"),
               "replicas": self.replicas, "step": self.steps,
               "why": verdict.get("why"),
               "evidence": verdict.get("evidence"),
               "ts_ms": now_ms()}
        dec.update(extra)
        self._journal(dec)
        return dec

    # -- the loop body -------------------------------------------------
    def step(self, now: "float | None" = None) -> "dict | None":
        """One diagnose-maybe-actuate pass.  Returns the decision dict
        when a knob was turned (or a replica retired), else None."""
        now = self._clock() if now is None else now
        window = evidence_window(self.collect())
        prev = self._history[0] if self._history else None
        self._history.append(window)
        if len(self._history) > self.window_steps:
            del self._history[0]
        self.steps += 1
        # shed-redirect accounting rides along every step: failovers
        # are exactly "a replica shed/failed and the router answered
        # from another" — the gauge that shows the grown fleet working
        fo = int(window.get("router_failovers") or 0)
        if fo > self._last_failovers:
            d = fo - self._last_failovers
            self.shed_redirects += d
            if self._c_redirects is not None:
                self._c_redirects.inc(d)
        self._last_failovers = max(self._last_failovers, fo)
        if prev is None:
            return None   # priming: history must not read as a breach
        verdicts = diagnose(window, objective=self.objective, prev=prev)
        self.last_verdicts = verdicts
        top = verdicts[0]

        if top["verdict"] == VERDICT_HEALTHY:
            self._breach_streak = 0
            self._healthy_streak += 1
            if (self._healthy_streak >= self.healthy_ticks
                    and self.replicas > self.min_replicas
                    and self.retire_replica is not None):
                if not self._cool(KNOB_REPLICAS, now):
                    self.holds += 1
                    return None
                if self.retire_replica():
                    self.replicas -= 1
                    self._last_act[KNOB_REPLICAS] = now
                    self._healthy_streak = 0
                    return self._decision("scale_down", top)
            return None

        self._healthy_streak = 0
        self._breach_streak += 1
        if self._breach_streak < self.breach_ticks:
            return None   # hysteresis: one noisy window never actuates
        # actuate the highest-scored verdict whose knob is actionable:
        # a cooling top verdict must not starve a runner-up (fix
        # freshness first, capacity next — not freshness or nothing)
        cooling = False
        for v in verdicts:
            knob = v.get("knob")
            if v["verdict"] == VERDICT_HEALTHY or knob is None:
                continue
            if not self._cool(knob, now):
                cooling = True
                continue
            dec = self._actuate(knob, v, now)
            if dec is not None:
                return dec
        if cooling:
            self.holds += 1
        return None

    def _actuate(self, knob: str, top: dict,
                 now: float) -> "dict | None":
        if knob == KNOB_REPLICAS:
            if self.spawn_replica is None:
                return None
            if self.replicas >= self.max_replicas:
                self.at_limit += 1
                return None
            if not self.spawn_replica():
                return None
            self.replicas += 1
            self._last_act[knob] = now
            return self._decision("scale_up", top)
        if knob == KNOB_SHIP:
            if self.shipper is None:
                return None
            cur = int(self.shipper.interval_ms)
            new = max(cur // 2, self.min_ship_interval_ms)
            if new >= cur:
                self.at_limit += 1
                return None
            self.shipper.interval_ms = new
            self._last_act[knob] = now
            return self._decision("ship_faster", top,
                                  from_ms=cur, to_ms=new)
        if knob == KNOB_POLL:
            if self.set_poll_ms is None or self._poll_ms is None:
                return None
            cur = self._poll_ms
            new = max(cur // 2, self.min_poll_ms)
            if new >= cur:
                self.at_limit += 1
                return None
            self.set_poll_ms(new)
            self._poll_ms = new
            self._last_act[knob] = now
            return self._decision("poll_faster", top,
                                  from_ms=cur, to_ms=new)
        if knob == KNOB_BATCH:
            if self.tune_batch is None:
                return None
            self.tune_batch(top)
            self._last_act[knob] = now
            return self._decision("batch_tune", top)
        return None

    def run(self, duration_s: float, interval_s: float = 0.5) -> int:
        """Convenience poll loop; returns decisions made.  Bench rungs
        drive :meth:`step` from their own thread instead."""
        deadline = self._clock() + float(duration_s)
        n = 0
        while self._clock() < deadline:
            if self.step() is not None:
                n += 1
            self._sleep(interval_s)
        return n

    # -- reporting -----------------------------------------------------
    def summary(self) -> dict:
        out = {
            "replicas": self.replicas, "steps": self.steps,
            "decisions": len(self.decisions),
            "scale_ups": self.actions.get("scale_up", 0),
            "scale_downs": self.actions.get("scale_down", 0),
            "ship_tunes": self.actions.get("ship_faster", 0),
            "poll_tunes": self.actions.get("poll_faster", 0),
            "batch_tunes": self.actions.get("batch_tune", 0),
            "holds": self.holds, "at_limit": self.at_limit,
            "shed_redirects": self.shed_redirects,
            "objective": dict(self.objective),
        }
        if self.decisions:
            last = self.decisions[-1]
            out["last"] = {k: last.get(k) for k in
                           ("decision", "verdict", "knob", "replicas",
                            "ts_ms")}
        return out
