"""Fleet chaos in the port (``streambench_tpu_torch/chaos/``: the fleet
draws of ``FaultInjector``, ``ShipChaosFilter``, ``netchaos.ChaosPubSub``,
``fleet_supervisor`` and the fleet checks of ``verify``), on the CPU.

For one plan and seed the port draws what the JAX package draws: the
plans are field-equal, the injectors' ``net_fault`` / ``ship_fault``
sequences and counters equal, ``ShipChaosFilter`` writes the same
bytes, the two proxies fault the same frames of the same sequential
traffic, and ``FleetSupervisor`` backs off, respawns and gives up at the
same moments under one fake clock.  The fleet checks give the JAX
package's verdicts.  The reference's ``tests/test_fleet_chaos.py``
cases run on the port: ship faults skipped and resynced by the port's
replica, the proxy's pass-through, retry + dedup exactly-once under
drops and dups, torn frames, severed connections, the pidfile, the
supervisor's rules.  ``cli_spawn`` launches the port's replica CLI with
an explicit ``--device`` (``cuda`` by default, which raises without
CUDA) and respawns a SIGKILLed replica at its pinned port.  Last, phase
20 (b)'s scenario on the CPU at a reduced size, under a time limit of its
own.  The reference's 20-seed sweep is marked ``slow`` here as it is
there."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from streambench_tpu.chaos import FaultInjector as JaxInjector
from streambench_tpu.chaos import FaultPlan as JaxPlan
from streambench_tpu.chaos import FleetSupervisor as JaxSupervisor
from streambench_tpu.chaos import netchaos as jax_netchaos
from streambench_tpu.chaos import verify as jax_verify
from streambench_tpu.dimensions import pubsub as jax_pubsub
from streambench_tpu.dimensions.store import (
    DurableDimensionStore as JaxStore,
)
from streambench_tpu_torch.chaos import (
    ChaosPubSub,
    FaultInjector,
    FaultPlan,
    FleetSupervisor,
    check_fleet_accounting,
    check_fleet_convergence,
    check_staleness_bound,
    durable_epoch_at,
    ship_epoch_timeline,
)
from streambench_tpu_torch.chaos.fleet_supervisor import cli_spawn, wait_ready
from streambench_tpu_torch.dimensions.pubsub import (
    PubSubClient,
    PubSubServer,
)
from streambench_tpu_torch.dimensions.store import (
    LOG_NAME,
    DurableDimensionStore,
)
from streambench_tpu_torch.reach.replica import ReachReplica, SnapshotShipper
from streambench_tpu_torch.utils.ids import now_ms
from streambench_tpu_torch.utils.pidfile import (
    acquire_pidfile,
    pidfile_alive,
    proc_starttime,
    read_pidfile,
    release_pidfile,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_KW = dict(net_drop_rate=0.2, net_delay_rate=0.1, net_delay_ms=7,
                net_dup_rate=0.1, net_torn_rate=0.05, net_msgs=300,
                partition_windows=((30, 10),), ship_rate=0.3, ship_ops=40)


# ------------------------------------------------ plans and fault draws
@pytest.mark.parametrize("seed", range(4))
def test_fleet_plans_and_draws_equal_the_jax_package(seed):
    a = FaultPlan.generate(seed, **FLEET_KW)
    b = JaxPlan.generate(seed, **FLEET_KW)
    assert a.net_faults == b.net_faults and a.ship_faults == b.ship_faults
    assert a.partition_windows == b.partition_windows
    assert a.net_delay_ms == b.net_delay_ms and a.is_zero == b.is_zero
    ours, theirs = FaultInjector(a), JaxInjector(b)
    assert [ours.net_fault() for _ in range(400)] == \
        [theirs.net_fault() for _ in range(400)]
    assert [ours.ship_fault() for _ in range(50)] == \
        [theirs.ship_fault() for _ in range(50)]
    assert ours.counters.snapshot() == theirs.counters.snapshot()
    assert ours.net_delay_s == theirs.net_delay_s


def test_fleet_plan_seeded_deterministic():
    a = FaultPlan.generate(7, **FLEET_KW)
    assert a == FaultPlan.generate(7, **FLEET_KW)
    assert a != FaultPlan.generate(8, **FLEET_KW)
    assert a.net_faults and a.ship_faults and not a.is_zero


def test_fleet_knobs_off_is_bit_identical_to_the_plan_without_them():
    legacy = dict(sink_rate=0.3, sink_ops=50, journal_rate=0.2,
                  journal_polls=30, crashes=3)
    a = FaultPlan.generate(42, **legacy)
    b = FaultPlan.generate(42, **legacy, net_drop_rate=0.0,
                           net_delay_rate=0.0, net_dup_rate=0.0,
                           net_torn_rate=0.0, net_msgs=500,
                           ship_rate=0.0, ship_ops=100)
    assert a == b and not b.net_faults and not b.ship_faults


def test_partition_window_outranks_rolled_kind():
    inj = FaultInjector(FaultPlan.generate(3, net_dup_rate=1.0, net_msgs=20,
                                           partition_windows=((5, 5),)))
    kinds = [inj.net_fault() for _ in range(20)]
    assert kinds[5:10] == ["drop"] * 5
    assert all(k == "dup" for k in kinds[:5] + kinds[10:])
    assert inj.counters.get("net_partition_drops") == 5


# --------------------------------------------------- the ship-log filter
def _planes(seed, camps, k=16, r=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 32, size=(len(camps), k), dtype=np.uint32),
            rng.integers(0, 20, size=(len(camps), r)).astype(np.int32))


@pytest.mark.parametrize("seed", range(3))
def test_ship_filter_writes_the_bytes_of_the_jax_package(tmp_path, seed):
    camps = ["a", "b", "c"]
    plan = dict(ship_rate=0.5, ship_ops=12)
    logs = []
    for name, store_cls, inj in (
            ("port", DurableDimensionStore,
             FaultInjector(FaultPlan.generate(seed, **plan))),
            ("jax", JaxStore, JaxInjector(JaxPlan.generate(seed, **plan)))):
        store = store_cls(str(tmp_path / name))
        inj.attach_ship_chaos(store)
        for epoch in range(1, 15):
            m, r = _planes(epoch, camps)
            store.put_reach_sketches(m, r, camps, epoch, update_time_ms=9,
                                     submit_ms=1000 + epoch,
                                     folded_ms=999 + epoch)
        store.close()
        logs.append(open(tmp_path / name / LOG_NAME, "rb").read())
        assert inj.counters.get("ship_faults") > 0
    assert logs[0] == logs[1]
    assert ship_epoch_timeline(str(tmp_path / "port" / LOG_NAME)) == \
        jax_verify.ship_epoch_timeline(str(tmp_path / "jax" / LOG_NAME))


def test_ship_faults_skip_and_resync_into_the_ports_replica(tmp_path):
    """Torn eats itself and the next append (one garbage line), corrupt
    eats itself, delayed lands late; the store's own view and the
    decodable timeline hold only intact records, and the port's replica
    tails the damaged log to the newest intact planes."""
    camps = ["a", "b"]
    store = DurableDimensionStore(str(tmp_path))
    FaultInjector(FaultPlan(ship_faults={1: "torn", 3: "delayed"})
                  ).attach_ship_chaos(store)
    for epoch in range(1, 6):
        m, r = _planes(epoch, camps)
        store.put_reach_sketches(m, r, camps, epoch, submit_ms=now_ms(),
                                 folded_ms=now_ms())
    store.close()
    log = str(tmp_path / LOG_NAME)
    assert [e for _, e in ship_epoch_timeline(log)] == [1, 4, 5]
    re = DurableDimensionStore(str(tmp_path))
    assert re.reach_sketches()["epoch"] == 5
    re.close()
    rep = ReachReplica(log, poll_ms=20_000, max_staleness_ms=10**9,
                       device="cpu")
    try:
        assert rep.poll_once()
        assert rep.server.epoch == 5
        m, _ = _planes(5, camps)
        from streambench_tpu_torch.ops import minhash

        np.testing.assert_array_equal(
            minhash.mins_numpy(rep.server._state[0]), m)
    finally:
        rep.close()


def test_ship_fault_hook_default_off_is_byte_identical(tmp_path):
    camps = ["a", "b"]
    m, r = _planes(1, camps)
    out = []
    for name, wire in (("plain", False), ("wired", True)):
        st = DurableDimensionStore(str(tmp_path / name))
        if wire:
            FaultInjector(FaultPlan.zeros()).attach_ship_chaos(st)
        st.put_reach_sketches(m, r, camps, 1, update_time_ms=123,
                              submit_ms=456, folded_ms=455)
        st.close()
        out.append(open(tmp_path / name / LOG_NAME, "rb").read())
    assert out[0] == out[1]


# --------------------------------------------------- the chaos proxy
def _echo_server(counts: dict, server_cls=PubSubServer):
    srv = server_cls(port=0)
    lock = threading.Lock()

    def handle(msg, reply):
        with lock:
            counts[msg.get("id")] = counts.get(msg.get("id"), 0) + 1
        reply({"id": msg.get("id"), "v": msg.get("v"), "estimate": 1.0,
               "plane_epoch": 1})

    srv.register_query("reach", handle)
    return srv.start()


def test_chaos_proxy_no_injector_is_passthrough():
    counts: dict = {}
    srv = _echo_server(counts)
    proxy = ChaosPubSub(srv.address).start()
    try:
        direct = PubSubClient(*srv.address, timeout_s=10)
        proxied = PubSubClient(*proxy.address, timeout_s=10)
        for i in range(10):
            a = direct.request({"type": "reach", "id": f"d{i}", "v": i},
                               timeout_s=5.0)
            b = proxied.request({"type": "reach", "id": f"d{i}~p", "v": i},
                                timeout_s=5.0)
            assert a["v"] == b["v"] == i
        direct.close()
        proxied.close()
        assert proxy.stats["dropped"] == proxy.stats["torn"] == 0
        assert proxy.stats["dupped"] == proxy.stats["delayed"] == 0
        assert proxy.stats["msgs"] >= 20
        assert proxy.summary()["upstream"] == "%s:%d" % srv.address
    finally:
        proxy.close()
        srv.close()


def _sequential_traffic(proxy_cls, injector, server_cls, client_cls, n):
    """``n`` sequential requests through ``proxy_cls`` over one plan;
    returns the proxy's stats, the injector's counters and what the
    client got back."""
    counts: dict = {}
    srv = _echo_server(counts, server_cls)
    proxy = proxy_cls(srv.address, injector).start()
    got = []
    try:
        c = client_cls(*proxy.address, timeout_s=10)
        for i in range(n):
            try:
                # a timeout long against a loaded host: only a lost
                # frame may time out, or the two runs' frames diverge
                d = c.request({"type": "reach", "id": f"q{i}", "v": i},
                              timeout_s=1.0, retries=3)
                got.append((d["id"], d["v"]))
            except TimeoutError:
                got.append(None)
        c.close()
        time.sleep(0.05)
    finally:
        proxy.close()
        srv.close()
    return dict(proxy.stats), injector.counters.snapshot(), got


def test_the_proxies_fault_the_same_frames_of_one_plan():
    kw = dict(net_drop_rate=0.08, net_delay_rate=0.05, net_delay_ms=5,
              net_dup_rate=0.1, net_torn_rate=0.04, net_msgs=400)
    ours = _sequential_traffic(ChaosPubSub,
                               FaultInjector(FaultPlan.generate(5, **kw)),
                               PubSubServer, PubSubClient, 25)
    theirs = _sequential_traffic(jax_netchaos.ChaosPubSub,
                                 JaxInjector(JaxPlan.generate(5, **kw)),
                                 jax_pubsub.PubSubServer,
                                 jax_pubsub.PubSubClient, 25)
    assert ours[0]["dropped"] + ours[0]["torn"] + ours[0]["dupped"] > 0
    assert ours == theirs


def test_retry_plus_dedup_exactly_once_under_drops_and_dups():
    counts: dict = {}
    srv = _echo_server(counts)
    plan = FaultPlan.generate(11, net_drop_rate=0.4, net_dup_rate=0.2,
                              net_msgs=2000)
    proxy = ChaosPubSub(srv.address, FaultInjector(plan)).start()
    try:
        c = PubSubClient(*proxy.address, timeout_s=30)
        got = []
        for i in range(30):
            try:
                got.append(c.request({"type": "reach", "id": f"q{i}",
                                      "v": i}, timeout_s=0.5, retries=8))
            except TimeoutError:
                pass
        c.close()
        vals = [d["v"] for d in got]
        assert len(vals) == len(set(vals)) and len(vals) >= 20
        assert all(n == 1 for n in counts.values()), counts
        assert proxy.stats["dropped"] > 0 and proxy.stats["dupped"] > 0
    finally:
        proxy.close()
        srv.close()


def test_proxy_torn_frames_resync():
    counts: dict = {}
    srv = _echo_server(counts)
    proxy = ChaosPubSub(srv.address, FaultInjector(
        FaultPlan(net_faults={1: "torn"}))).start()
    try:
        c = PubSubClient(*proxy.address, timeout_s=10)
        a = c.request({"type": "reach", "id": "t0", "v": 0}, timeout_s=1.0,
                      retries=2)
        assert a["v"] == 0 and a["id"] == "t0~r1"
        c.close()
        assert proxy.stats["torn"] == 1
    finally:
        proxy.close()
        srv.close()


def test_proxy_drop_conns_severs_but_keeps_listening():
    counts: dict = {}
    srv = _echo_server(counts)
    proxy = ChaosPubSub(srv.address).start()
    try:
        c = PubSubClient(*proxy.address, timeout_s=10)
        assert c.request({"type": "reach", "id": "a", "v": 1},
                         timeout_s=5.0)["v"] == 1
        assert proxy.drop_conns() >= 2
        with pytest.raises((TimeoutError, ConnectionError, OSError)):
            c.request({"type": "reach", "id": "b", "v": 2}, timeout_s=0.5)
        c.close()
        c2 = PubSubClient(*proxy.address, timeout_s=10)
        assert c2.request({"type": "reach", "id": "c", "v": 3},
                          timeout_s=5.0)["v"] == 3
        c2.close()
    finally:
        proxy.close()
        srv.close()


# ----------------------------------------------------------- pidfile
def test_pidfile_format_and_refusal(tmp_path):
    path = str(tmp_path / "pids" / "replica_0")
    assert acquire_pidfile(path) == os.getpid()
    pid, started = read_pidfile(path)
    assert pid == os.getpid() and started == proc_starttime(os.getpid())
    assert acquire_pidfile(path) is None
    assert pidfile_alive(path) == os.getpid()
    release_pidfile(path)
    assert not os.path.exists(path)


def test_pidfile_recycled_pid_is_dead(tmp_path):
    path = str(tmp_path / "replica_1")
    with open(path, "w") as f:
        f.write(f"{os.getpid()} 1\n")
    assert pidfile_alive(path) is None
    assert acquire_pidfile(path) == os.getpid()
    release_pidfile(path)


# ------------------------------------------------- the fleet supervisor
class _FakeProc:
    def __init__(self):
        self.pid = 4242
        self.code = None

    def poll(self):
        return self.code

    def kill(self):
        self.code = -9

    terminate = kill


def _stepper(cls, **kw):
    clock = {"t": 0.0}
    spawned = []

    def spawn(idx, attempt):
        p = _FakeProc()
        spawned.append((idx, attempt, p))
        return p

    sup = cls(spawn, 2, clock=lambda: clock["t"], sleep=lambda s: None, **kw)
    return sup, clock, spawned


def _supervise(cls, seed: int) -> str:
    """A seeded schedule of deaths (young and old, by kill and by exit)
    under one fake clock; every slot's ledger, restart deadline and the
    summary after each pass, as one JSON string."""
    rng = np.random.default_rng(seed)
    sup, clock, spawned = _stepper(
        cls, backoff_base_ms=float(rng.integers(10, 100)),
        backoff_cap_ms=float(rng.integers(200, 900)),
        healthy_after_s=float(rng.uniform(0.5, 3.0)),
        max_restarts=int(rng.integers(2, 5)), seed=seed)
    sup.start()
    trail = []
    for _ in range(80):
        clock["t"] += float(rng.uniform(0.01, 1.0))
        r = rng.random()
        idx = int(rng.integers(0, 2))
        if r < 0.25:
            sup.kill(idx, hard=bool(rng.random() < 0.7))
        elif r < 0.4 and spawned:
            spawned[-1][2].code = int(rng.integers(1, 3))
        trail.append((sup.step(), [
            (s.attempt, s.restarts, s.consecutive_young_deaths, s.gave_up,
             None if s.restart_at is None else round(s.restart_at, 9),
             list(s.exit_codes), s.kills) for s in sup.slots]))
    trail.append(sup.summary())
    trail.append([(i, a) for i, a, _ in spawned])
    return json.dumps(trail)


@pytest.mark.parametrize("seed", range(4))
def test_supervisor_backoff_and_give_up_equal_the_jax_package(seed):
    assert _supervise(FleetSupervisor, seed) == _supervise(JaxSupervisor,
                                                           seed)


def test_supervisor_respawns_after_backoff_and_hooks_restart():
    restarts = []
    sup, clock, spawned = _stepper(
        FleetSupervisor, backoff_base_ms=100.0, backoff_cap_ms=1000.0,
        healthy_after_s=1.0, max_restarts=3, seed=0,
        on_restart=lambda idx, attempt: restarts.append((idx, attempt)))
    sup.start()
    assert len(spawned) == 2
    clock["t"] = 5.0
    assert sup.kill(0) and sup.step() == 0
    slot = sup.slots[0]
    assert 0.05 <= slot.restart_at - 5.0 <= 0.1
    clock["t"] = slot.restart_at + 0.001
    assert sup.step() == 1
    assert spawned[-1][:2] == (0, 2) and restarts == [(0, 2)]
    assert sup.summary()["restarts"] == 1
    assert not sup.kill(0) or sup.slots[0].kills == 2


def test_supervisor_gives_up_on_consecutive_young_deaths():
    sup, clock, spawned = _stepper(
        FleetSupervisor, backoff_base_ms=10.0, backoff_cap_ms=50.0,
        healthy_after_s=10.0, max_restarts=3, seed=1)
    sup.start()
    for _ in range(3):
        next(p for i, _, p in reversed(spawned) if i == 0).code = 1
        sup.step()
        if sup.slots[0].gave_up:
            break
        clock["t"] = sup.slots[0].restart_at + 0.001
        sup.step()
    assert sup.slots[0].gave_up and sup.summary()["gave_up"] == 1
    n = len(spawned)
    sup.step()
    assert len(spawned) == n


def test_supervisor_spawn_retire_and_stop():
    sup, clock, spawned = _stepper(FleetSupervisor, seed=2)
    sup.start()
    idx = sup.spawn()
    assert idx == 2 and len(sup.slots) == 3 and sup.alive(2)
    gone = []
    assert sup.retire(2, deregister=gone.append, drain_s=0.0, grace_s=0.0)
    assert gone == [2] and sup.slots[2].retired and not sup.alive(2)
    assert not sup.retire(2)
    clock["t"] += 100.0
    assert sup.step() == 0                 # a retired slot stays down
    assert sup.counters.get("retires") == 1
    assert sup.counters.get("crash_kills") == 0
    sup.stop(grace_s=0.0)
    assert sup.summary()["active"] == 0
    with pytest.raises(RuntimeError):
        sup.spawn()


def test_cli_spawn_raises_without_cuda_and_never_falls_back(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawn = cli_spawn(str(tmp_path / LOG_NAME), str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        spawn(0, 1)
    assert not os.path.exists(tmp_path / "replica_0.out")


def test_cli_spawn_respawns_a_killed_replica_at_its_pinned_port(tmp_path):
    """``cli_spawn`` on ``cpu``: the replica CLI comes up at its pinned
    port (``wait_ready``), answers, is SIGKILLed, and the supervisor
    respawns it at the same address; SIGTERM then stops it with its
    stats line."""
    import socket

    store = DurableDimensionStore(str(tmp_path / "ship"))
    m, r = _planes(3, ["a", "b"])
    SnapshotShipper(store, ["a", "b"], interval_ms=1).note_state(m, r, 2, 7)
    store.close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env_pp = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = REPO
    work = str(tmp_path / "fleet")
    spawn = cli_spawn(str(tmp_path / "ship" / LOG_NAME), work, ports=[port],
                      max_staleness_ms=10**9, poll_ms=20, fleet=True,
                      metrics=True, device="cpu")
    sup = FleetSupervisor(spawn, 1, backoff_base_ms=10.0,
                          backoff_cap_ms=50.0, healthy_after_s=0.1, seed=3)
    out_path = os.path.join(work, "replica_0.out")

    def answer():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                c = PubSubClient("127.0.0.1", port, timeout_s=5)
                d = c.request({"type": "reach", "campaigns": ["a"],
                               "op": "union", "id": time.monotonic()},
                              timeout_s=5.0)
                c.close()
                if "estimate" in d:
                    return d
            except (TimeoutError, ConnectionError, OSError):
                pass
            time.sleep(0.05)
        raise AssertionError("the replica never answered")

    try:
        sup.start()
        assert wait_ready(out_path, timeout_s=60) == ("127.0.0.1", port)
        assert answer()["plane_epoch"] == 2
        first_pid = sup.slots[0].handle.pid
        assert sup.kill(0)
        deadline = time.monotonic() + 30
        while not (sup.slots[0].restarts and sup.alive(0)):
            assert time.monotonic() < deadline
            sup.step()
            time.sleep(0.02)
        assert sup.slots[0].handle.pid != first_pid
        d = answer()
        assert d["plane_epoch"] == 2 and "freshness" in d
        sup.stop(grace_s=30.0)
        assert sup.slots[0].handle.poll() == 0
        lines = open(out_path).read().splitlines()
        assert sum("replica: pubsub=" in ln for ln in lines) == 2
        stats = json.loads([ln for ln in lines if ln.startswith("{")][-1])
        assert stats["device"] == "cpu" and stats["fleet"] is True
        assert sup.summary()["restarts"] == 1
    finally:
        sup.stop(grace_s=5.0)
        if env_pp is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = env_pp


# --------------------------------------------------- the fleet checks
def test_accounting_exact_by_id():
    ok = check_fleet_accounting(
        ["a", "b", "c"], [{"id": "a", "estimate": 1.0},
                          {"id": "b", "shed": True},
                          {"id": "c", "error": "bad_request"}])
    assert ok.ok and ok.answered == 2 and ok.shed == 1
    bad = check_fleet_accounting(
        ["a", "b"], [{"id": "a", "estimate": 1.0},
                     {"id": "a", "estimate": 1.0},
                     {"id": "z", "estimate": 1.0}])
    assert not bad.ok and bad.duplicate_ids == ["a"]
    assert bad.missing_ids == ["b"] and bad.unexpected_ids == ["z"]


def test_staleness_bound_floor():
    timeline = [(1000, 1), (2000, 2), (3000, 3)]
    assert durable_epoch_at(timeline, 999) is None
    assert durable_epoch_at(timeline, 2500) == 2
    v = check_staleness_bound(
        [(3500, {"id": "ok", "plane_epoch": 2}),
         (3500, {"id": "old", "plane_epoch": 1}),
         (3500, {"id": "shed", "shed": True, "plane_epoch": 0})],
        timeline, max_staleness_ms=1000)
    assert not v.ok and [x[0] for x in v.stale_violations] == ["old"]


@pytest.mark.parametrize("seed", range(3))
def test_fleet_checks_equal_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    sent = [f"q{i}" for i in range(60)]
    replies, stamped = [], []
    timeline = sorted((int(t), int(e)) for t, e in zip(
        rng.integers(0, 20_000, 12), rng.integers(1, 9, 12)))
    for i, qid in enumerate(sent):
        r = rng.random()
        if r < 0.05:
            continue                                  # missing
        rep = ({"id": qid, "shed": True, "reason": "all_stale"}
               if r < 0.2 else {"id": qid, "estimate": 1.0,
                                "plane_epoch": int(rng.integers(0, 9))})
        replies.append(rep)
        if r > 0.97:
            replies.append(dict(rep))                 # duplicate
        stamped.append((int(rng.integers(0, 25_000)), rep))
    replies.append({"id": "stray", "estimate": 2.0})
    ours = check_fleet_accounting(sent, replies, repro="r")
    check_staleness_bound(stamped, timeline, 4_000, verdict=ours,
                          slack_ms=50)
    theirs = jax_verify.check_fleet_accounting(sent, replies, repro="r")
    jax_verify.check_staleness_bound(stamped, timeline, 4_000,
                                     verdict=theirs, slack_ms=50)
    assert ours.summary() == theirs.summary()
    assert (ours.duplicate_ids, ours.missing_ids, ours.unexpected_ids,
            ours.stale_violations) == (
                theirs.duplicate_ids, theirs.missing_ids,
                theirs.unexpected_ids,
                [tuple(x) for x in theirs.stale_violations])


def test_convergence_and_bit_identity(tmp_path):
    camps = ["a", "b"]
    m, r = _planes(9, camps)
    for name in ("clean", "chaos", "diverged"):
        st = DurableDimensionStore(str(tmp_path / name))
        st.put_reach_sketches(m if name != "diverged" else m + 1, r, camps,
                              7, submit_ms=now_ms())
        st.close()
    chaos = str(tmp_path / "chaos" / LOG_NAME)
    clean = str(tmp_path / "clean" / LOG_NAME)
    v = check_fleet_convergence(chaos, [7, 7], clean_ship_path=clean)
    assert v.ok and v.writer_epoch == 7 and not v.divergent
    lag = check_fleet_convergence(chaos, [7, 6], clean_ship_path=clean)
    assert not lag.ok and lag.lagging_replicas == [(1, 6, 7)]
    div = check_fleet_convergence(str(tmp_path / "diverged" / LOG_NAME),
                                  [7], clean_ship_path=clean)
    assert not div.ok and div.divergent
    j = jax_verify.check_fleet_convergence(chaos, [7, 6],
                                           clean_ship_path=clean)
    assert j.summary() == lag.summary()


# ----------------------------------------- phase 20 (b) on the CPU
def test_chip_smoke_fleet_chaos_scenario_runs_on_the_cpu(tmp_path,
                                                         monkeypatch):
    """Phase 20 (b) through the smoke's own code on the CPU, at 40
    queries over 6 epochs (the card runs 160 over 14): two in-process
    replicas behind chaos proxies and the router, each killed once and
    respawned at its port with its planes freed first; sent = answered
    + shed by id, no stale answer, the final record bit-identical to the
    fault-free arm's.  Its own time limit of 150 s."""
    import chip_smoke

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        return str(path)

    monkeypatch.setattr(chip_smoke, "_workdir", workdir)
    box: dict = {}

    def run():
        try:
            box["out"] = chip_smoke._fleet_chaos("cpu", queries_n=40,
                                                 epochs_n=6,
                                                 ship_gap_s=0.25)
        except BaseException as e:      # reported below, in this thread
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=150)
    assert not t.is_alive(), "the fleet chaos scenario outran its limit"
    if "err" in box:
        raise box["err"]
    out = box["out"]
    assert out["accounting_exact"] and out["stale_violations"] == 0
    assert out["bit_identical_final"] and not out["lagging_replicas"]
    assert out["sent"] == out["answered"] + out["shed"] == 40
    assert out["supervisor"]["restarts"] >= 2
    assert [k["freed"] for k in out["kills"]] == [True, True]
    assert out["router"]["failovers"] >= 1


# ------------------------------------------------ the 20-seed sweep
@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("seed", range(20))
def test_exactly_once_sweep_over_seeds(seed):
    counts: dict = {}
    srv = _echo_server(counts)
    plan = FaultPlan.generate(seed, net_drop_rate=0.18, net_delay_rate=0.05,
                              net_delay_ms=5, net_dup_rate=0.15,
                              net_torn_rate=0.08, net_msgs=4000,
                              partition_windows=((30 + seed, 8),))
    proxy = ChaosPubSub(srv.address, FaultInjector(plan)).start()
    try:
        c = PubSubClient(*proxy.address, timeout_s=60)
        got = []
        for i in range(24):
            try:
                got.append(c.request({"type": "reach", "id": f"s{seed}q{i}",
                                      "v": i}, timeout_s=0.25, retries=10))
            except (TimeoutError, ConnectionError, OSError):
                c.close()
                c = PubSubClient(*proxy.address, timeout_s=60)
        c.close()
        vals = [d["v"] for d in got]
        assert len(vals) == len(set(vals)), "double-answered request"
        assert all(n == 1 for n in counts.values()), counts
        assert len(vals) >= 18
    finally:
        proxy.close()
        srv.close()
