"""The multi-tenant host of the port against the JAX package's, on the CPU.

The tenant-scoped registry views, the device-time ledger (blame matrix,
aggressor, partition check), the admission controller (priming,
hysteresis, no evidence, cooldown holds, release, escalation, the
decision cap) and the per-tenant SLO trackers are pure host code: the
same inputs go through both packages and must give equal dicts.  The
``MultiTenantHost`` runs on ``device="cpu"`` beside the JAX host on the
same seeded batches: the same Redis rows per tenant (HLL and reach
estimates within 1, the reach planes bit for bit), the same folded,
queued and dropped counts, and the same admission decisions under
scripted burns and a scripted clock.  Then the ``--tenants`` CLI against
the JAX CLI, ``TORCH_TEST`` with ``TENANTS``, and ``obs/diagnose.py``
naming the aggressor from a journal the port's host wrote.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import streambench_tpu.engine.sketches as jax_sketches
from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import tenants as jax_tenants
from streambench_tpu.io.fakeredis import make_store as jax_make_store
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu.obs import MetricsRegistry as JaxRegistry
from streambench_tpu.obs import MetricsSampler as JaxSampler
from streambench_tpu.obs import SloTracker as JaxSlo
from streambench_tpu.obs.admission import (
    AdmissionController as JaxAdmission,
)
from streambench_tpu.obs.tenancy import DeviceTimeLedger as JaxLedger
from streambench_tpu.obs.tenancy import TenantRegistry as JaxView
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import sketches
from streambench_tpu_torch.engine import tenants
from streambench_tpu_torch.io.fakeredis import make_store
from streambench_tpu_torch.io.redis_schema import (
    as_redis,
    read_seen_counts,
    seed_campaigns,
)
from streambench_tpu_torch.obs import (
    AdmissionController,
    DeviceTimeLedger,
    MetricsRegistry,
    MetricsSampler,
    SloTracker,
    TenantRegistry,
    diagnose,
    evidence_window,
)
from streambench_tpu_torch.obs import admission as admission_mod
from streambench_tpu_torch.obs.diagnose import (
    KNOB_ADMISSION,
    VERDICT_TENANT,
)
from tests.test_torch_engine import REPO, TOPIC, write_journal

MS = 1_000_000  # ns per ms
CLOCK_MS = 1_700_000_100_000
TABLE = default_config().redis_hashtable

torch.set_num_threads(1)


# ----------------------------------------------------------------------
# tenant-scoped registry views
def _registry_ops(registry_cls, view_cls):
    reg = registry_cls()
    a, b = view_cls(reg, "alpha"), view_cls(reg, "beta")
    a.counter("streambench_events_total", "events folded").inc(7)
    b.counter("streambench_events_total", "events folded").inc(2)
    a.gauge("streambench_events_per_s", "rate").set(3.5)
    h = b.histogram("streambench_window_latency_ms", "latency")
    for v in (1.0, 12.0, 400.0):
        h.observe(v)
    a.predeclare("counter", "streambench_compiles_total", "builds")
    b.counter("streambench_x_total", labels={"tenant": "beta",
                                             "k": "v"}).inc()
    bleed = []
    for view, other in ((a, "beta"), (b, "alpha")):
        try:
            view.counter("streambench_events_total",
                         labels={"tenant": other})
        except ValueError as e:
            bleed.append(str(e))
    try:
        view_cls(reg, "")
    except ValueError as e:
        bleed.append(str(e))
    collected = {name: sorted((m.name, sorted(m.labels.items()))
                              for m in v.collect())
                 for name, v in (("alpha", a), ("beta", b))}
    return reg.render_prometheus(), a.render_prometheus(), collected, bleed


def test_tenant_registry_collect_and_render_equal_jax():
    got = _registry_ops(MetricsRegistry, TenantRegistry)
    want = _registry_ops(JaxRegistry, JaxView)
    assert got == want
    assert len(got[3]) == 3                  # every bleed raised
    assert 'tenant="alpha"' in got[0] and 'tenant="beta"' in got[0]
    assert 'streambench_compiles_total{tenant="alpha"} 0' in got[0]


# ----------------------------------------------------------------------
# the device-time ledger on seeded synthetic intervals
def _intervals(seed):
    rng = np.random.default_rng(seed)
    names = ["alpha", "beta", "gamma", "delta"][:2 + seed % 3]
    busy, wait = [], []
    for _ in range(60):
        t = names[int(rng.integers(len(names)))]
        s = int(rng.integers(0, 2_000)) * MS // 4
        busy.append((t, s, s + int(rng.integers(0, 40)) * MS // 8))
    for _ in range(40):
        t = names[int(rng.integers(len(names)))]
        s = int(rng.integers(0, 2_000)) * MS // 4
        wait.append((t, s, s + int(rng.integers(0, 200)) * MS // 8))
    return names, busy, wait


def _ledger_reads(ledger_cls, names, busy, wait, max_intervals):
    led = ledger_cls(max_intervals=max_intervals)
    for n in names:
        led.declare(n)
    for i, (t, s, e) in enumerate(busy):
        if i % 2:
            led.busy_sink(t)(s, e)
        else:
            led.note_busy(t, s, e)
    for t, s, e in wait:
        led.note_wait(t, s, e)
    measured = dict(led.busy_ns)
    off = dict(measured, **{names[0]: measured[names[0]] * 2 + MS})
    return {"blame": led.blame_matrix(),
            "aggressor": {n: led.aggressor_for(n) for n in names + ["x"]},
            "partition_ok": led.partition_check(measured),
            "partition_off": led.partition_check(off, slack=0.05),
            "summary": led.summary(), "tenants": led.tenants(),
            "merged": {n: led.merged_busy(n) for n in names}}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("max_intervals", [4096, 16])
def test_ledger_reads_equal_jax(seed, max_intervals):
    names, busy, wait = _intervals(seed)
    got = _ledger_reads(DeviceTimeLedger, names, busy, wait, max_intervals)
    want = _ledger_reads(JaxLedger, names, busy, wait, max_intervals)
    assert got == want
    assert got["partition_ok"]["ok"] and not got["partition_off"]["ok"]


def test_ledger_counters_land_in_the_registry():
    reg = MetricsRegistry()
    led = DeviceTimeLedger(registry=reg)
    led.busy_sink("beta")(10 * MS, 30 * MS)
    led.note_wait("gamma", 0, 5 * MS)
    body = reg.render_prometheus()
    assert ('streambench_tenant_device_busy_ms_total{tenant="beta"} 20'
            in body)
    assert 'streambench_tenant_wait_ms_total{tenant="gamma"} 5' in body


# ----------------------------------------------------------------------
# the admission controller under scripted burns and a scripted clock
def _canned(ledger_cls, kind):
    led = ledger_cls()
    if kind == "self":                   # the victim waits on itself
        led.note_busy("gamma", 0, 100 * MS)
        led.note_wait("gamma", 10 * MS, 60 * MS)
    else:
        led.note_busy("beta", 0, 100 * MS)
        led.note_busy("alpha", 200 * MS, 220 * MS)
        led.note_wait("gamma", 10 * MS, 60 * MS)     # beta blames 50 ms
        led.note_wait("gamma", 205 * MS, 210 * MS)   # alpha 5 ms
    return led


#: (burn series, clock series, controller kwargs, ledger kind)
ADMISSION_CASES = {
    "priming": ([99.0, 99.0, 99.0], None,
                {"breach_ticks": 1, "cooldown_s": 0.0}, "blame"),
    "hysteresis": ([0.0, 9.0, 0.0, 9.0, 9.0, 9.0], None,
                   {"breach_ticks": 2, "cooldown_s": 0.0}, "blame"),
    "no_evidence": ([9.0] * 6, None,
                    {"breach_ticks": 1, "cooldown_s": 0.0}, "self"),
    "cooldown_holds": ([9.0] * 8, [0, 0, 0, 1, 10, 10, 10, 30],
                       {"breach_ticks": 1, "cooldown_s": 5.0,
                        "escalate_ticks": 1}, "blame"),
    "release": ([9.0, 9.0, 0.0, 0.0, 0.0, 9.0, 9.0], None,
                {"breach_ticks": 1, "healthy_ticks": 3,
                 "cooldown_s": 0.0}, "blame"),
    "escalation": ([9.0] * 9, None,
                   {"breach_ticks": 2, "escalate_ticks": 3,
                    "cooldown_s": 0.0}, "blame"),
    "below_threshold": ([0.5, 0.9, 0.99, 1.0, 1.0], None,
                        {"breach_ticks": 2, "breach_burn": 1.0,
                         "cooldown_s": 0.0}, "blame"),
}


def _drive(ctl_cls, ledger_cls, case, lags=None, flightrec=None,
           sampler=None):
    burns, clocks, kw, kind = ADMISSION_CASES[case]
    it = iter(burns)
    state = {"i": 0}
    clocks = clocks or [0.0] * len(burns)

    def clock():
        return float(clocks[min(state["i"], len(clocks) - 1)])

    ctl = ctl_cls(_canned(ledger_cls, kind),
                  lambda: {"gamma": next(it), "alpha": 0.0},
                  clock=clock, lags=lags, flightrec=flightrec,
                  sampler=sampler, **kw)
    trail = []
    for state["i"] in range(len(burns)):
        dec = ctl.step()
        trail.append((None if dec is None else
                       {k: v for k, v in dec.items() if k != "ts_ms"},
                       {t: ctl.admit(t) for t in ("alpha", "beta",
                                                  "gamma")},
                       ctl.holds))
    ctl.note_deferred("beta", 3)
    ctl.note_shed("beta", 2)
    s = ctl.summary()
    s.get("last", {}).pop("ts_ms", None)
    return trail, s, ctl.gates()


@pytest.mark.parametrize("case", list(ADMISSION_CASES))
def test_admission_decisions_equal_jax(case):
    got = _drive(AdmissionController, DeviceTimeLedger, case)
    want = _drive(JaxAdmission, JaxLedger, case)
    assert got == want
    trail, summary, _ = got
    assert trail[0][0] is None                  # priming never actuates
    assert summary["batches_deferred"] == 3
    assert summary["batches_shed"] == 2
    decisions = [d for d, _, _ in trail if d is not None]
    if case == "no_evidence":
        assert not decisions
    if case == "escalation":
        assert [d["decision"] for d in decisions] == ["defer", "shed"]
    for d in decisions:
        assert d["tenant"] != d["victim"]
        if d["decision"] != "release":
            assert d["tenant"] == "beta" and d["blame_ms"] == 50.0
    for _, gates, _ in trail:
        assert gates["gamma"] == "admit"        # the victim never gated


class _Recorder:
    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append((kind, fields))

    def annotate(self, event, **fields):
        self.events.append((event, fields))


def test_admission_journals_lags_to_sampler_and_flightrec():
    out = {}
    for side, ctl_cls, ledger_cls in (
            ("port", AdmissionController, DeviceTimeLedger),
            ("jax", JaxAdmission, JaxLedger)):
        fr, sm = _Recorder(), _Recorder()
        _drive(ctl_cls, ledger_cls, "release",
               lags=lambda: {"beta": 1234}, flightrec=fr, sampler=sm)
        strip = [(k, {f: v for f, v in d.items() if f != "ts_ms"})
                 for k, d in fr.events]
        out[side] = (strip, sm.events)
    assert out["port"] == out["jax"]
    kinds = [d["decision"] for _, d in out["port"][0]]
    assert kinds == ["defer", "release", "defer"]
    assert all(d["lag"] == {"beta": 1234} for _, d in out["port"][0])
    assert [e for e, _ in out["port"][1]] == ["admission_decision"] * 3


def test_admission_decision_journal_is_capped(monkeypatch):
    monkeypatch.setattr(admission_mod, "DECISIONS_MAX", 4)
    ctl = AdmissionController(_canned(DeviceTimeLedger, "blame"),
                              lambda: {"gamma": 9.0}, breach_ticks=1,
                              healthy_ticks=1, cooldown_s=0.0,
                              clock=lambda: 0.0)
    burns = iter([9.0, 9.0, 0.0] * 6)
    ctl.burns = lambda: {"gamma": next(burns)}
    for _ in range(18):
        ctl.step()
    assert len(ctl.decisions) == 4
    assert ctl.summary()["decisions"] == 4
    assert ctl.actions["defer"] == 6 and ctl.actions["release"] == 6


# ----------------------------------------------------------------------
# per-tenant SLO trackers and the host's sampler records
def _slo_run(registry_cls, view_cls, slo_cls, tenant):
    reg = registry_cls()
    view = view_cls(reg, tenant) if tenant else reg
    events = []
    now = {"t": 0.0}
    slo = slo_cls(view, p99_ms=100, budget=0.01, fast_s=2.0, slow_s=6.0,
                  tenant=tenant, clock=lambda: now["t"],
                  annotate=lambda ev, **f: events.append((ev, f)))
    hist = view.histogram("streambench_window_latency_ms", "latency")
    recs = []
    for i, lat in enumerate([5, 5, 500, 500, 500, 5, 5, 5, 5, 5, 5, 5]):
        now["t"] = float(i)
        for _ in range(10):
            hist.observe(float(lat))
        rec = {}
        slo.collect(rec, 1.0)
        recs.append((rec, round(slo.fast_burn(), 6)))
    return recs, events, slo.verdict()


@pytest.mark.parametrize("tenant", [None, "gamma"])
def test_slo_tenant_tracker_equals_jax(tenant):
    got = _slo_run(MetricsRegistry, TenantRegistry, SloTracker, tenant)
    want = _slo_run(JaxRegistry, JaxView, JaxSlo, tenant)
    assert got == want
    recs, events, verdict = got
    assert [e for e, _ in events] == ["slo_breach", "slo_recovered"]
    if tenant is None:
        assert all("slo" in r and "slo_tenants" not in r for r, _ in recs)
        assert "tenant" not in verdict
    else:
        assert all(set(r) == {"slo_tenants"} and set(r["slo_tenants"])
                   == {"gamma"} for r, _ in recs)
        assert all(f["tenant"] == "gamma" for _, f in events)
        assert verdict["tenant"] == "gamma" and not verdict["pass"]
    assert max(b for _, b in recs) > 1.0


@pytest.mark.parametrize("role", [None, "host"])
def test_sampler_records_equal_jax(tmp_path, role):
    """The sampler the host journals through writes the JAX package's
    records: an annotated event and the final record with the same keys,
    and no ``tenant`` stamp (the host nests per-tenant blocks instead;
    the reference's ``MetricsSampler(tenant=)`` has no caller and is not
    ported)."""
    keys = {}
    for side, cls in (("port", MetricsSampler), ("jax", JaxSampler)):
        path = str(tmp_path / f"{side}.jsonl")
        s = cls(path, interval_ms=10_000, role=role)
        s.add_collector(lambda rec, dt: rec.update(x=1))
        s.annotate("admission_decision", decision="defer")
        s.close(final={"y": 2})
        recs = [json.loads(ln) for ln in open(path)]
        keys[side] = [(r["kind"], sorted(set(r) - {"ts_ms", "uptime_ms",
                                                   "pid", "seq"}),
                       r.get("role")) for r in recs]
    assert keys["port"] == keys["jax"]
    assert all(r == role for _, _, r in keys["port"])
    assert all("tenant" not in k for _, k, _ in keys["port"])
    assert {k for k, _, _ in keys["port"]} >= {"event", "final"}


# ----------------------------------------------------------------------
# the host, on the CPU, against the JAX host
@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("mt"))
    campaigns = write_journal(wd, 6_000, 10, seed=23)
    mapping = gen.load_ad_mapping_file(
        os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE))
    with open(os.path.join(wd, gen.KAFKA_JSON_FILE), "rb") as f:
        lines = f.read().splitlines()
    return wd, campaigns, mapping, lines


@pytest.fixture(autouse=True)
def one_clock(monkeypatch):
    """Both packages' sketch engines read the same fixed host clock."""
    monkeypatch.setattr(jax_sketches, "now_ms", lambda: CLOCK_MS)
    monkeypatch.setattr(sketches, "now_ms", lambda: CLOCK_MS)


def _host(side, specs, campaigns, mapping, **kw):
    if side == "jax":
        cfg = jax_default_config(kafka_topic=TOPIC, jax_batch_size=512)

        def factory():
            r = jax_as_redis(jax_make_store())
            jax_seed(r, campaigns)
            return r

        return jax_tenants.MultiTenantHost(
            cfg, specs, mapping, campaigns=campaigns,
            registry=JaxRegistry(), redis_factory=factory, **kw)
    cfg = default_config(kafka_topic=TOPIC, jax_batch_size=512)

    def factory():
        r = as_redis(make_store())
        seed_campaigns(r, campaigns)
        return r

    return tenants.MultiTenantHost(
        cfg, specs, mapping, campaigns=campaigns, registry=MetricsRegistry(),
        redis_factory=factory, device="cpu", **kw)


def _tenant_rows(kind, engine):
    r = engine.redis
    if kind in ("exact", "hll", "sliding"):
        out = {(c, w): n for c, ws in (read_seen_counts(r) if engine.__module__
                                       .startswith("streambench_tpu_torch")
                                       else jax_seen(r)).items()
               for w, n in ws.items()}
        return out
    table = {"session": "_hh", "reach": "_reach", "hllx": "_hllx"}[kind]
    return r.hgetall(f"{TABLE}{table}")


def _assert_rows(kind, got, want):
    assert set(got) == set(want) and got
    for k, w in want.items():
        g = got[k]
        if kind in ("hll", "reach") or (kind == "hllx"
                                        and k.endswith(":distinct")):
            assert abs(int(g) - int(w)) <= 1, (kind, k)
        elif kind == "hllx" and not k.endswith(":views"):
            assert abs(float(g) - float(w)) <= 0.1, (kind, k)
        else:
            assert str(g) == str(w), (kind, k)


def _run_host(side, specs, journal, batches=6, queue_max=4):
    wd, campaigns, mapping, lines = journal
    host = _host(side, specs, campaigns, mapping, queue_max=queue_max,
                 sample_every=1)
    host.warmup()
    step = len(lines) // batches
    for i in range(batches):
        for name in host.tenants():
            host.offer(name, lines[i * step:(i + 1) * step])
    counts = []
    while True:
        folded = host.step()
        counts.append(folded)
        if not folded:
            break
    summary = host.close(final=True)
    rows = {s["name"]: _tenant_rows(s["kind"],
                                    host.tenant(s["name"]).engine)
            for s in specs}
    planes = {}
    for s in specs:
        if s["kind"] == "reach":
            p = host.tenant(s["name"]).engine.planes()
            planes[s["name"]] = (np.asarray(p["mins"]),
                                 np.asarray(p["registers"]))
    return summary, rows, planes, counts


@pytest.mark.parametrize("spec", [
    "ex:exact,se:session,hl:hll,rc:reach", "sl:sliding,hx:hllx"],
    ids=["exact_session_hll_reach", "sliding_hllx"])
def test_host_rows_and_counts_equal_jax(journal, spec):
    specs = tenants.parse_tenants(spec)
    assert specs == jax_tenants.parse_tenants(spec)
    got, grows, gplanes, gcounts = _run_host("port", specs, journal)
    want, wrows, wplanes, wcounts = _run_host("jax", specs, journal)
    assert gcounts == wcounts
    for s in specs:
        name = s["name"]
        g, w = got["tenants"][name], want["tenants"][name]
        for key in ("kind", "events", "folded_batches", "queued_batches",
                    "dropped_batches"):
            assert g[key] == w[key], (name, key)
        # 6 batches into a queue of 4: the 2 oldest dropped, 4 folded
        assert (g["folded_batches"], g["dropped_batches"]) == (4, 2)
        _assert_rows(s["kind"], grows[name], wrows[name])
    for name in wplanes:
        for a, b in zip(gplanes[name], wplanes[name]):
            np.testing.assert_array_equal(a, b)
    assert got["multitenant"]["partition"]["ok"]
    assert set(got["multitenant"]["tenants"]) == set(
        want["multitenant"]["tenants"])
    assert set(got["multitenant"]) == set(want["multitenant"])


def test_parse_tenants_errors_equal_jax():
    for spec in ("", "a:exact,a:hll", ":exact", "a:bogus", "a,b:reach"):
        outs = []
        for mod in (tenants, jax_tenants):
            try:
                outs.append(("ok", mod.parse_tenants(spec)))
            except ValueError as e:
                outs.append(("err", str(e)))
        assert outs[0] == outs[1], spec
    assert tenants.TENANT_KINDS == jax_tenants.TENANT_KINDS
    assert tenants.QUEUE_MAX == jax_tenants.QUEUE_MAX


#: burns by control step: a breach the hysteresis confirms at step 3,
#: then health until release, then a breach that persists into shed
BURNS = [0.0, 5.0, 5.0, 5.0, 0.0, 0.0, 0.0, 5.0, 5.0, 5.0, 5.0, 5.0,
         5.0, 5.0, 5.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]


def _gated_run(side, journal):
    wd, campaigns, mapping, lines = journal
    specs = [{"name": "rb", "kind": "reach"},
             {"name": "ex", "kind": "exact"}]
    now = {"t": 0.0}
    host = _host(side, specs, campaigns, mapping, queue_max=16,
                 sample_every=10 ** 9, admission=True,
                 admission_kw={"breach_ticks": 2, "healthy_ticks": 3,
                               "escalate_ticks": 4, "cooldown_s": 1.0,
                               "clock": lambda: now["t"]})
    # the blame evidence, identical in both packages: rb held the device
    # for 50 ms of ex's wait (no sampled window of the run lands here)
    host.ledger.note_busy("rb", 0, 100 * MS)
    host.ledger.note_wait("ex", 10 * MS, 60 * MS)
    burns = iter(BURNS)
    host.admission.burns = lambda: {"ex": next(burns)}
    host.warmup()
    step = len(lines) // 12
    for i in range(12):
        host.offer("rb", lines[i * step:(i + 1) * step])
        host.offer("ex", lines[i * step:(i + 1) * step])
    trail = []
    for i in range(len(BURNS)):
        now["t"] = float(i)
        dec = host.control_step()
        host.step()
        trail.append((
            None if dec is None else
            {k: v for k, v in dec.items() if k != "ts_ms"},
            {n: (host.tenant(n).folded_batches, len(host.tenant(n).queue))
             for n in host.tenants()}))
    while host.step():
        pass
    summary = host.close(final=True)
    adm = summary["admission"]
    adm.get("last", {}).pop("ts_ms", None)
    rows = {s["name"]: _tenant_rows(s["kind"], host.tenant(s["name"]).engine)
            for s in specs}
    return trail, adm, rows, {n: {k: summary["tenants"][n][k] for k in (
        "events", "folded_batches", "queued_batches", "dropped_batches")}
        for n in summary["tenants"]}


def test_host_admission_decisions_equal_jax(journal):
    got = _gated_run("port", journal)
    want = _gated_run("jax", journal)
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    _assert_rows("exact", got[2]["ex"], want[2]["ex"])
    _assert_rows("reach", got[2]["rb"], want[2]["rb"])
    decisions = [d for d, _ in got[0] if d is not None]
    assert [d["decision"] for d in decisions] == [
        "defer", "release", "defer", "shed", "release"]
    assert all(d["tenant"] == "rb" and d["victim"] == "ex"
               and d["blame_ms"] == 50.0 for d in decisions
               if d["decision"] != "release")
    # the defer holds rb's batches: its folds stop while ex goes on
    i_defer = next(i for i, (d, _) in enumerate(got[0])
                   if d and d["decision"] == "defer")
    assert got[0][i_defer][1]["rb"][0] == got[0][i_defer + 1][1]["rb"][0]
    assert got[0][i_defer + 1][1]["ex"][0] > got[0][i_defer][1]["ex"][0]
    tot = got[3]["rb"]
    assert got[1]["batches_shed"] > 0
    assert 12 == (tot["folded_batches"] + got[1]["batches_shed"]
                  + tot["dropped_batches"] + tot["queued_batches"])


def test_admission_off_never_calls_admission(journal, monkeypatch):
    """With admission off the fold loop never reaches the controller
    (the reference's byte-identity pin): an armed controller whose
    threshold is unreachable folds the same rows."""
    def boom(*a, **k):
        raise AssertionError("admission called with admission off")

    for name in ("admit", "step", "note_deferred", "note_shed"):
        monkeypatch.setattr(AdmissionController, name, boom)
    specs = tenants.parse_tenants("ex:exact,se:session")
    plain = _run_host("port", specs, journal)
    monkeypatch.undo()
    armed_specs = [dict(s) for s in specs]
    wd, campaigns, mapping, lines = journal
    host = _host("port", armed_specs, campaigns, mapping, queue_max=4,
                 sample_every=1, admission=True,
                 admission_kw={"breach_burn": 1e9})
    host.warmup()
    step = len(lines) // 6
    for i in range(6):
        for name in host.tenants():
            host.offer(name, lines[i * step:(i + 1) * step])
    while host.step():
        pass
    host.close(final=True)
    for s in specs:
        assert _tenant_rows(s["kind"], host.tenant(s["name"]).engine) == \
            plain[1][s["name"]]


def test_host_journals_disjoint_tenant_blocks(journal, tmp_path):
    wd, campaigns, mapping, lines = journal
    registry = MetricsRegistry()
    sampler = MetricsSampler(str(tmp_path / "metrics.jsonl"),
                             interval_ms=50, registry=registry, role="host")
    cfg = default_config(kafka_topic=TOPIC, jax_batch_size=512)
    host = tenants.MultiTenantHost(
        cfg, [{"name": "alpha", "kind": "exact"},
              {"name": "beta", "kind": "session", "p99_ms": 100}],
        mapping, campaigns=campaigns, registry=registry, sampler=sampler,
        sample_every=1, device="cpu")
    host.warmup()
    sampler.start()
    host.offer("alpha", lines)
    host.offer("beta", lines)
    while host.step():
        pass
    host.flush_all()
    time.sleep(0.2)
    summary = host.close()
    sampler.close(final={"multitenant": summary["multitenant"]})
    assert summary["tenants"]["alpha"]["events"] == len(lines)
    assert summary["tenants"]["beta"]["events"] == len(lines)
    assert summary["multitenant"]["partition"]["ok"]
    seen = {m.labels["tenant"] for m in registry.collect()
            if "tenant" in m.labels}
    assert seen == {"alpha", "beta"}
    recs = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    blocks = [r["tenants"] for r in recs if isinstance(r.get("tenants"),
                                                       dict)]
    assert blocks and all(set(b) == {"alpha", "beta"} for b in blocks)
    assert any(set(r.get("slo_tenants", {})) == {"beta"} for r in recs)
    final = next(r for r in recs if r.get("kind") == "final")
    assert final["multitenant"]["partition"]["ok"]


# ----------------------------------------------------------------------
# the CLI, the harness and diagnose
def _cli(module, wd, spec, extra=(), conf_extra=""):
    conf = os.path.join(wd, "conf.yaml")
    with open(conf, "w") as f:
        f.write(f'redis.host: ":inprocess:"\nkafka.topic: "{TOPIC}"\n'
                "jax.metrics.interval.ms: 50\njax.batch.size: 512\n"
                + conf_extra)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    args = ["--tenants", spec] if spec else []
    p = subprocess.run(
        [sys.executable, "-m", module, "--confPath", conf, "--workdir", wd,
         "--catchup", *args, *extra],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    return [ln for ln in p.stdout.splitlines() if ln.strip()]


@pytest.mark.parametrize("how", ["flag", "config"])
def test_tenants_cli_on_cpu_matches_the_jax_cli(tmp_path, how):
    wd = str(tmp_path)
    write_journal(wd, 5_000, 10, seed=41)
    spec = "alpha:exact,beta:session,gamma:reach"
    conf_extra = "" if how == "flag" else f'jax.tenants: "{spec}"\n'
    port = _cli("streambench_tpu_torch.engine", wd,
                spec if how == "flag" else None, ["--device", "cpu"],
                conf_extra)
    recs = [json.loads(ln) for ln in open(os.path.join(wd, "metrics.jsonl"))]
    jax = _cli("streambench_tpu.engine", wd, spec if how == "flag" else None,
               conf_extra=conf_extra)
    assert port[0] == jax[0] == "tenants up: alpha,beta,gamma"
    got, want = json.loads(port[-1]), json.loads(jax[-1])
    assert got["engine"] == want["engine"] == "multitenant"
    assert got["events"] == want["events"] == 15_000
    for name, block in want["tenants"].items():
        g = got["tenants"][name]
        assert (g["kind"], g["events"], g["folded_batches"]) == (
            block["kind"], block["events"], block["folded_batches"])
    assert got["partition_ok"] is want["partition_ok"] is True
    blocks = [r["tenants"] for r in recs if isinstance(r.get("tenants"),
                                                       dict)]
    assert blocks and set(blocks[-1]) == {"alpha", "beta", "gamma"}
    assert all(r.get("role") == "host" for r in recs)


def test_tenants_cli_with_admission_keys(tmp_path):
    wd = str(tmp_path)
    write_journal(wd, 3_000, 10, seed=43)
    out = _cli("streambench_tpu_torch.engine", wd, "a:exact,b:hll",
               ["--device", "cpu"],
               "jax.admission.enabled: true\n"
               "jax.admission.breach.ticks: 3\njax.slo.p99.ms: 1000\n")
    assert out[0] == "tenants up: a,b (admission on)"
    stats = json.loads(out[-1])
    assert set(stats["admission"]) == {"defers", "sheds", "releases",
                                       "holds", "batches_deferred",
                                       "batches_shed"}
    assert stats["tenants"]["a"]["events"] == 3_000
    assert "slo_pass" in stats["tenants"]["a"]


def test_harness_torch_test_with_tenants_on_cpu(tmp_path):
    from tests.test_torch_harness import free_port, run_harness

    wd = str(tmp_path / "run")
    # one intra-op thread in the engine, as every in-process test here:
    # on a busy CPU torch's thread pool stalls each small op for tens of
    # ms, and the host's fold-and-flush loop falls seconds behind
    p = run_harness(["TORCH_TEST"], {
        "WORKDIR": wd, "REDIS_PORT": str(free_port()), "LOAD": "400",
        "TEST_TIME": "6", "STOP_STATS_GRACE": "3", "DEVICE": "cpu",
        "TENANTS": "a:exact,b:session", "OMP_NUM_THREADS": "1"},
        timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "TORCH_TEST evidence:" in p.stdout
    conf = open(os.path.join(wd, "localConf.yaml")).read()
    assert "jax.tenants: a:exact,b:session" in conf
    log = open(os.path.join(wd, "logs", "engine.log")).read()
    assert "tenants up: a,b" in log
    stats = json.loads(log.strip().splitlines()[-1])
    assert stats["engine"] == "multitenant" and stats["partition_ok"]
    assert stats["tenants"]["a"]["events"] == stats["tenants"]["b"][
        "events"] > 0
    seen = open(os.path.join(wd, "seen.txt")).read().split()
    assert seen and all(int(s) > 0 for s in seen)
    assert not os.listdir(os.path.join(wd, "pids"))


@pytest.mark.parametrize("env,conf_keys", [
    ({"TENANTS": "a:exact,b:hll"}, ["jax.tenants: a:exact,b:hll",
                                   "jax.admission.enabled: false"]),
    ({"TENANTS": "a:reach", "ADMISSION": "1"},
     ["jax.tenants: a:reach", "jax.admission.enabled: true"]),
    ({"ADMISSION": "1"}, ["jax.admission.enabled: true"])],
    ids=["tenants", "tenants_admission", "admission"])
def test_harness_setup_writes_the_host_keys_as_jax(tmp_path, env, conf_keys):
    """SETUP writes ``jax.tenants`` and ``jax.admission.enabled`` from
    ``TENANTS`` and ``ADMISSION``, as ``stream_bench.py`` does."""
    from tests.test_torch_harness import free_port, run_harness

    wd = str(tmp_path / "run")
    p = run_harness(["SETUP"], {"WORKDIR": wd, "REDIS_PORT":
                                str(free_port()), "DEVICE": "cpu", **env})
    assert p.returncode == 0, p.stdout + p.stderr
    conf = open(os.path.join(wd, "localConf.yaml")).read()
    for key in conf_keys:
        assert key in conf


def test_diagnose_names_the_aggressor_from_the_ports_journal(journal,
                                                             tmp_path):
    """A victim with a window-latency objective every window breaches
    (the journal's events are years old), and the blame evidence that
    names ``rb``: the port's ``diagnose`` reads the tenant verdict from
    the journal the port's host wrote, as the JAX package's does."""
    from streambench_tpu.obs.diagnose import diagnose as jax_diagnose
    from streambench_tpu.obs.diagnose import (
        evidence_window as jax_evidence,
    )

    wd, campaigns, mapping, lines = journal
    registry = MetricsRegistry()
    path = str(tmp_path / "metrics.jsonl")
    sampler = MetricsSampler(path, interval_ms=20, registry=registry,
                             role="host")
    cfg = default_config(kafka_topic=TOPIC, jax_batch_size=512)
    host = tenants.MultiTenantHost(
        cfg, [{"name": "rb", "kind": "reach"},
              {"name": "ex", "kind": "exact", "p99_ms": 1}],
        mapping, campaigns=campaigns, registry=registry, sampler=sampler,
        sample_every=10 ** 9, device="cpu")
    host.ledger.note_busy("rb", 0, 100 * MS)
    host.ledger.note_wait("ex", 10 * MS, 60 * MS)
    sampler.start()
    for i in range(0, len(lines), 1000):
        host.offer("rb", lines[i:i + 1000])
        host.offer("ex", lines[i:i + 1000])
        while host.step():
            pass
        host.flush_all()
        time.sleep(0.05)
    time.sleep(0.2)
    host.close()
    sampler.close()
    recs = [json.loads(ln) for ln in open(path)]
    got = diagnose(evidence_window(recs), objective={})
    want = jax_diagnose(jax_evidence(recs), objective={})
    assert got == want
    top = got[0]
    assert top["verdict"] == VERDICT_TENANT
    assert (top["victim"], top["aggressor"]) == ("ex", "rb")
    assert top["knob"] == KNOB_ADMISSION


def test_concurrent_drain_waits_attribute_each_wait_once(journal):
    """``drain_waits`` runs on the fold loop and on the sampler's thread
    at once: each of the serving tenant's wait pairs lands in the ledger
    once (a lost update of the high-water mark attributed some twice)."""
    import sys
    import threading

    wd, campaigns, mapping, lines = journal
    host = _host("port", [{"name": "gm", "kind": "reach", "serve": True}],
                 campaigns, mapping)
    ring = host.tenant("gm").serve._wait_ring
    ring.extend((10 * i, 10 * i + 7) for i in range(1, 4001))
    go = threading.Barrier(8)

    def drain():
        go.wait()
        host.drain_waits()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=drain) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
        host.close()
    assert not any(t.is_alive() for t in threads)
    assert host.ledger.wait_ns["gm"] == 4000 * 7
