"""The SLO autopilot in the port (``streambench_tpu_torch/obs/diagnose.py``
and ``obs/autoscale.py``), on the CPU.

``evidence_window`` and ``diagnose`` are pure: over seeded fleet
journals both packages give JSON byte-identical windows and verdicts.
``AutoscaleController`` is driven under one fake clock through the same
seeded evidence sequence in both packages, against fake shippers,
spawn and retire hooks: the decision sequences are equal.  The safety
rails are the reference's ``tests/test_autoscale.py`` cases on the
port: the priming step, hysteresis, per-knob cooldowns with a cooling
top verdict falling through, bounds counted on ``at_limit``, scale-down
after a healthy streak through the supervisor's graceful retire, no
hooks -> no actuation, and every decision journaled with its
freshness-hop evidence.  Last, phase 20 (c)'s scenario on the CPU at the
reference's reduced schedule, under a time limit of its own."""

import importlib
import json
import os
import threading

import numpy as np
import pytest

from streambench_tpu_torch.chaos.fleet_supervisor import FleetSupervisor
from streambench_tpu_torch.obs import (
    AutoscaleController,
    FlightRecorder,
    MetricsRegistry,
    MetricsSampler,
)
from streambench_tpu_torch.obs.diagnose import (
    VERDICT_CONTENTION,
    VERDICT_FOLD,
    VERDICT_HEALTHY,
    VERDICT_SERVE,
    VERDICT_TAIL,
    diagnose,
    evidence_window,
)
from streambench_tpu_torch.obs.fleet import render_fleet, summarize_fleet

# the modules (the packages export functions of the same names)
jax_autoscale = importlib.import_module("streambench_tpu.obs.autoscale")
jax_diagnose = importlib.import_module("streambench_tpu.obs.diagnose")
port_autoscale = importlib.import_module(
    "streambench_tpu_torch.obs.autoscale")
dg = importlib.import_module("streambench_tpu_torch.obs.diagnose")

OBJECTIVE = {"staleness_ms": 1000, "p99_ms": 100}
HOPS = ("fold_lag", "ship_wait", "tail_lag", "serve", "total")


def _dump(x) -> str:
    return json.dumps(x, sort_keys=True)


def _seeded_records(rng, ts=1_000) -> list:
    """One window of seeded fleet evidence: replicas (some with hops,
    query obs), a router, the writer's ship block, an SLO block."""
    recs = []
    for i in range(int(rng.integers(0, 4))):
        rq = {"staleness_ms": float(round(rng.uniform(0, 2500), 1)),
              "p99_ms": float(round(rng.uniform(0, 250), 2)),
              "qps": float(round(rng.uniform(0, 200), 1)),
              "served": int(rng.integers(0, 900)),
              "shed": int(rng.integers(0, 40)),
              "shed_stale": int(rng.integers(0, 10)),
              "queue_high_water": int(rng.integers(0, 64))}
        if rng.random() < 0.8:
            rq["freshness"] = {"hops": {h: {"p99": float(round(
                rng.uniform(0, 1500), 1))} for h in HOPS}}
        if rng.random() < 0.5:
            rq["query_obs"] = {
                "contention": {"ratio": float(round(rng.random(), 4))},
                "segments": {s: {"p99": float(round(rng.uniform(0, 90), 2))}
                             for s in ("queue", "batch", "dispatch",
                                       "reply")}}
        recs.append({"kind": "snapshot" if rng.random() < 0.9 else "final",
                     "role": "replica", "pid": 1000 + i, "ts_ms": ts + i,
                     "reach_query": rq})
    if rng.random() < 0.8:
        recs.append({"kind": "snapshot", "role": "router", "pid": 2,
                     "ts_ms": ts + 9, "router": {
                         "routed": int(rng.integers(0, 900)),
                         "answered": int(rng.integers(0, 900)),
                         "shed": int(rng.integers(0, 30)),
                         "failovers": int(rng.integers(0, 30)),
                         "replicas": [{}] * int(rng.integers(1, 4)),
                         "e2e_p99_ms": (float(round(rng.uniform(0, 300), 2))
                                        if rng.random() < 0.7 else None)}})
    if rng.random() < 0.6:
        recs.append({"kind": "snapshot", "role": "writer", "pid": 3,
                     "ts_ms": ts + 5, "reach_ship": {
                         "interval_ms": int(rng.integers(100, 3000)),
                         "ships": int(rng.integers(0, 50))}})
    if rng.random() < 0.4:
        recs.append({"kind": "snapshot", "role": "writer", "pid": 3,
                     "ts_ms": ts + 6, "slo": {"burn": {
                         "reach": float(round(rng.uniform(0, 20), 2))}}})
    if rng.random() < 0.2:
        recs.append({"kind": "event", "event": "restart", "ts_ms": ts + 7})
    return recs


@pytest.mark.parametrize("seed", range(8))
def test_evidence_and_verdicts_equal_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    prev = None
    for step in range(12):
        recs = _seeded_records(rng, ts=1_000 * (step + 1))
        w = evidence_window(recs)
        assert _dump(w) == _dump(jax_diagnose.evidence_window(recs))
        obj = {"staleness_ms": int(rng.integers(200, 2000)),
               "p99_ms": int(rng.integers(10, 200))}
        if rng.random() < 0.2:
            obj.pop("p99_ms")
        got = diagnose(w, objective=obj, prev=prev)
        assert _dump(got) == _dump(jax_diagnose.diagnose(
            w, objective=obj, prev=prev))
        assert got and got[0]["score"] >= got[-1]["score"]
        prev = w


class _Shipper:
    def __init__(self, interval_ms=2000):
        self.interval_ms = interval_ms


def _drive(mod, seed: int) -> str:
    """One seeded evidence sequence through ``mod.AutoscaleController``
    under a fake clock, with fake hooks; every decision and the summary
    as one JSON string (wall stamps stripped)."""
    rng = np.random.default_rng(seed)
    windows = [_seeded_records(rng, ts=1_000 * (i + 1)) for i in range(40)]
    clock = {"t": 0.0}
    ship = _Shipper(int(rng.integers(800, 4000)))
    polls = []
    state = {"spawned": 0, "retired": 0, "i": 0}

    def collect():
        recs = windows[min(state["i"], len(windows) - 1)]
        state["i"] += 1
        return recs

    def spawn():
        state["spawned"] += 1
        return bool(rng.random() < 0.9)

    def retire():
        state["retired"] += 1
        return True

    ctrl = mod.AutoscaleController(
        collect, objective={"staleness_ms": 900, "p99_ms": 60},
        spawn_replica=spawn, retire_replica=retire, shipper=ship,
        min_ship_interval_ms=200, set_poll_ms=polls.append, poll_ms=400,
        min_poll_ms=50, replicas=1, max_replicas=3, breach_ticks=2,
        healthy_ticks=3, cooldown_s=1.0,
        cooldowns={"poll_interval": 2.5}, window_steps=4,
        clock=lambda: clock["t"], sleep=lambda s: None)
    steps = []
    for _ in range(len(windows)):
        clock["t"] += float(rng.uniform(0.1, 1.2))
        dec = ctrl.step()
        steps.append(None if dec is None else
                     {k: v for k, v in dec.items() if k != "ts_ms"})
    summ = dict(ctrl.summary())
    summ.pop("last", None)
    return _dump({"steps": steps, "summary": summ, "polls": polls,
                  "ship": ship.interval_ms, "hooks": state,
                  "verdicts": ctrl.last_verdicts})


@pytest.mark.parametrize("seed", range(6))
def test_controller_decisions_equal_the_jax_package(seed):
    assert _drive(port_autoscale, seed) == _drive(jax_autoscale, seed)


# ------------------------------------------------- the verdict table
def replica_rec(pid=1000, *, staleness_ms=100.0, p99_ms=5.0, qps=10.0,
                served=50, shed=0, shed_stale=0, hops=None,
                contention=None, segments=None):
    rq = {"staleness_ms": staleness_ms, "p99_ms": p99_ms, "qps": qps,
          "served": served, "shed": shed, "shed_stale": shed_stale}
    rq["freshness"] = {"hops": {h: {"p99": v} for h, v in
                               (hops or {"serve": staleness_ms}).items()}}
    if contention is not None or segments is not None:
        rq["query_obs"] = {"contention": {"ratio": contention},
                           "segments": {s: {"p99": v} for s, v in
                                        (segments or {}).items()}}
    return {"kind": "snapshot", "role": "replica", "pid": pid,
            "ts_ms": 1_000, "reach_query": rq}


def router_rec(**kw):
    rt = {"routed": 100, "answered": 100, "shed": 0, "failovers": 0,
          "replicas": [{}]}
    rt.update(kw)
    return {"kind": "snapshot", "role": "router", "pid": 2,
            "ts_ms": 1_001, "router": rt}


@pytest.mark.parametrize("recs,verdict", [
    ([replica_rec(staleness_ms=1500, hops={"fold_lag": 5, "tail_lag": 60,
                                           "serve": 1400})], VERDICT_FOLD),
    ([replica_rec(staleness_ms=1500, hops={"fold_lag": 5, "tail_lag": 900,
                                           "serve": 100})], VERDICT_TAIL),
    ([replica_rec(), router_rec(e2e_p99_ms=250.0)], VERDICT_SERVE),
    ([replica_rec(p99_ms=300.0, contention=0.8,
                  segments={"queue": 250.0, "dispatch": 10.0})],
     VERDICT_CONTENTION),
    ([replica_rec()], VERDICT_HEALTHY),
], ids=["fold", "tail", "serve", "contention", "healthy"])
def test_verdict_table(recs, verdict):
    top = diagnose(evidence_window(recs), objective=OBJECTIVE)[0]
    assert top["verdict"] == verdict
    assert top["knob"] == dg.KNOB_FOR[verdict]


def test_counters_are_differenced_against_the_previous_window():
    burst = evidence_window([replica_rec(shed=40, shed_stale=0)])
    assert diagnose(burst, objective=OBJECTIVE)[0]["verdict"] == \
        VERDICT_SERVE
    later = evidence_window([replica_rec(shed=40, shed_stale=0)])
    assert diagnose(later, objective=OBJECTIVE, prev=burst)[0][
        "verdict"] == VERDICT_HEALTHY


# ------------------------------------------ the controller's safety rails
def stale_recs():
    return [replica_rec(staleness_ms=1500,
                        hops={"fold_lag": 5, "tail_lag": 60, "serve": 1400})]


def tail_recs():
    return [replica_rec(staleness_ms=1500,
                        hops={"fold_lag": 5, "tail_lag": 900, "serve": 100})]


def hot_recs():
    return [replica_rec(staleness_ms=100, p99_ms=4),
            router_rec(e2e_p99_ms=250.0)]


def healthy_recs():
    return [replica_rec(staleness_ms=100, p99_ms=4)]


def _ctrl(collect, **kw):
    clock = {"t": 0.0}
    kw.setdefault("objective", OBJECTIVE)
    ctrl = AutoscaleController(collect, clock=lambda: clock["t"],
                               sleep=lambda s: None, **kw)
    return ctrl, clock


def test_priming_step_never_actuates():
    ship = _Shipper(2000)
    ctrl, _ = _ctrl(stale_recs, shipper=ship, min_ship_interval_ms=500,
                    breach_ticks=1)
    assert ctrl.step() is None
    assert ship.interval_ms == 2000 and not ctrl.decisions
    dec = ctrl.step()
    assert dec["decision"] == "ship_faster"
    assert (dec["from_ms"], dec["to_ms"]) == (2000, 1000)


def test_hysteresis_requires_consecutive_breach_windows():
    ship = _Shipper(2000)
    ctrl, _ = _ctrl(stale_recs, shipper=ship, min_ship_interval_ms=500,
                    breach_ticks=3)
    assert [ctrl.step() for _ in range(3)] == [None, None, None]
    assert ctrl.step()["decision"] == "ship_faster"


def test_cooldown_holds_then_reacts_after_expiry():
    ship = _Shipper(2000)
    ctrl, clock = _ctrl(stale_recs, shipper=ship, min_ship_interval_ms=500,
                        breach_ticks=1, cooldown_s=10.0)
    ctrl.step()
    assert ctrl.step()["decision"] == "ship_faster"
    clock["t"] = 1.0
    assert ctrl.step() is None and ctrl.holds == 1
    assert ship.interval_ms == 1000
    clock["t"] = 11.0
    assert ctrl.step()["to_ms"] == 500


def test_poll_knob_and_its_floor():
    polls = []
    ctrl, clock = _ctrl(tail_recs, set_poll_ms=polls.append, poll_ms=200,
                        min_poll_ms=100, breach_ticks=1, cooldown_s=0.0)
    ctrl.step()
    assert ctrl.step()["decision"] == "poll_faster" and polls == [100]
    clock["t"] = 1.0
    assert ctrl.step() is None and ctrl.at_limit == 1   # at its floor


def test_bounds_are_refusals_counted_on_at_limit():
    spawned = []
    ctrl, clock = _ctrl(hot_recs, spawn_replica=lambda: spawned.append(1)
                        or True, replicas=2, max_replicas=2,
                        breach_ticks=1)
    ctrl.step()
    assert ctrl.step() is None
    assert not spawned and ctrl.at_limit == 1 and not ctrl.decisions


def test_default_off_no_hooks_actuates_nothing():
    for recs in (stale_recs, hot_recs, tail_recs):
        ctrl, _ = _ctrl(recs, breach_ticks=1)
        for _ in range(5):
            assert ctrl.step() is None
        assert not ctrl.decisions and ctrl.replicas == 1


class _FakeProc:
    def __init__(self):
        self.pid = 4242
        self.code = None
        self.terminated = False

    def poll(self):
        return self.code

    def kill(self):
        self.code = -9

    def terminate(self):
        self.terminated = True
        self.code = 0


def test_scale_up_then_retire_over_a_supervisor_of_fake_procs(tmp_path):
    """Hot evidence grows the fleet through ``FleetSupervisor.spawn``;
    a healthy streak retires the newest slot gracefully (deregistered
    first, terminated, never respawned); every decision is journaled
    with its hop evidence, into the sampler and the flight recorder."""
    procs = []

    def spawn(idx, attempt):
        procs.append(_FakeProc())
        return procs[-1]

    clock = {"t": 0.0}
    sup = FleetSupervisor(spawn, 1, clock=lambda: clock["t"],
                          sleep=lambda s: None).start()
    deregistered = []
    phase = {"recs": hot_recs}
    reg = MetricsRegistry()
    path = str(tmp_path / "controller" / "metrics.jsonl")
    sampler = MetricsSampler(path, interval_ms=60_000, registry=reg,
                             role="controller")
    fr = FlightRecorder(str(tmp_path))

    def retire():
        for idx in range(len(sup.slots) - 1, 0, -1):
            if not sup.slots[idx].retired and sup.alive(idx):
                return sup.retire(idx, deregister=deregistered.append,
                                  drain_s=0.0, grace_s=0.0)
        return False

    ctrl = AutoscaleController(
        lambda: phase["recs"](), objective=OBJECTIVE,
        spawn_replica=lambda: sup.spawn() is not None,
        retire_replica=retire, replicas=1, max_replicas=3,
        breach_ticks=1, healthy_ticks=2, cooldown_s=1.0, sampler=sampler,
        flightrec=fr, registry=reg, clock=lambda: clock["t"],
        sleep=lambda s: None)
    ctrl.step()
    dec = ctrl.step()
    assert dec["decision"] == "scale_up" and dec["replicas"] == 2
    assert len(sup.slots) == 2 and sup.alive(1)
    phase["recs"] = healthy_recs
    for _ in range(3):
        clock["t"] += 2.0
        dec = ctrl.step() or dec
    assert dec["decision"] == "scale_down" and ctrl.replicas == 1
    assert deregistered == [1] and procs[1].terminated
    assert sup.slots[1].retired and sup.summary()["retired"] == 1
    clock["t"] += 10.0
    assert sup.step() == 0 and len(procs) == 2     # never respawned
    assert ctrl.summary()["scale_ups"] == 1
    assert ctrl.summary()["scale_downs"] == 1
    for d in ctrl.decisions:
        assert d["evidence"]["hop_p99_ms"]
    sampler.close(final={"autoscale": ctrl.summary()})
    recs = [json.loads(ln) for ln in open(path)]
    events = [r for r in recs if r.get("event") == "autoscale_decision"]
    assert len(events) == 2
    assert all(r["role"] == "controller" for r in recs)
    assert [r["kind"] for r in fr.snapshot()].count("autoscale") == 2
    s = summarize_fleet([dict(r, role="controller") for r in recs])
    assert s["roles"][0]["autoscale"]["decisions"] == 2
    assert "autoscale: replicas" in render_fleet(s)


def test_shed_redirects_ride_the_failover_counter():
    fo = {"n": 0}

    def recs():
        return [replica_rec(), router_rec(failovers=fo["n"])]

    ctrl, _ = _ctrl(recs)
    ctrl.step()
    fo["n"] = 5
    ctrl.step()
    fo["n"] = 7
    ctrl.step()
    assert ctrl.shed_redirects == 7


def test_qps_ramp_schedule_is_seed_deterministic():
    import chip_smoke

    a = chip_smoke._qps_ramp_schedule(seed=13, duration_s=8.0, qps0=5.0,
                                      qps1=30.0, burst_n=24)
    assert a == chip_smoke._qps_ramp_schedule(
        seed=13, duration_s=8.0, qps0=5.0, qps1=30.0, burst_n=24)
    assert a != chip_smoke._qps_ramp_schedule(
        seed=14, duration_s=8.0, qps0=5.0, qps1=30.0, burst_n=24)
    assert a == sorted(a) and 0 < a[0] and a[-1] < 8.0
    # the ramp: the last quarter holds more arrivals than the first
    assert sum(t > 6.0 for t in a) > sum(t < 2.0 for t in a)


# ----------------------------------------- phase 20 (c) on the CPU
def test_chip_smoke_autoscale_scenario_runs_on_the_cpu(tmp_path,
                                                       monkeypatch):
    """Phase 20 (c) through the smoke's own code on the CPU, at the
    reference's reduced schedule (8 s + 8 s, 5 -> 30 qps) and a K, R
    cut to 1,024 and 512; its own time limit of 150 s."""
    import chip_smoke

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        return str(path)

    monkeypatch.setattr(chip_smoke, "_workdir", workdir)
    box: dict = {}

    def run():
        try:
            box["out"] = chip_smoke._fleet_autoscale(
                "cpu", duration_s=8.0, tail_s=8.0, qps0=5.0, qps1=30.0,
                K=1024, R=512)
        except BaseException as e:      # reported below, in this thread
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=150)
    assert not t.is_alive(), "the autoscale scenario outran its limit"
    if "err" in box:
        raise box["err"]
    out = box["out"]
    assert out["breach_ratio_on"] < out["breach_ratio_off"]
    assert out["on"]["controller"]["scale_ups"] >= 1
    assert all(d["evidence"]["hop_p99_ms"] for d in out["on"]["decisions"])
    assert out["off"]["sent"] == out["on"]["sent"] == out["schedule_n"]
    assert not os.path.exists(str(tmp_path / "smoke_fleet_autoscale"))
