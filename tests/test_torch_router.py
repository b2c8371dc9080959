"""The port's freshness-aware failover router (``streambench_tpu_torch/
reach/router.py``) on the CPU.

``campaign_shard`` equals the JAX package's bit for bit over seeded
campaign sets.  The routing cases are the reference's router cases of
``tests/test_fleet_chaos.py``: sticky primaries, failover to the next
freshest replica with the dead primary demoted, each honest shed reason
(``all_stale``, ``overloaded``, ``no_replica``), client errors forwarded
without failover, ``add_replica`` / ``remove_replica``.  Then the router
over two of the port's replicas serving on ``cpu``: a routed reply is
byte-identical to the direct one, the answers agree exactly with the JAX
server's on the same planes (estimates within rtol 1e-6), and ``sent ==
answered + shed`` by request id through a replica crash.  The CLI starts,
journals as role ``router`` and prints its stats line on SIGTERM."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.reach import query as jax_rq
from streambench_tpu.reach import router as jax_router
from streambench_tpu.reach.serve import ReachQueryServer as JaxServer
from streambench_tpu_torch.chaos import check_fleet_accounting
from streambench_tpu_torch.dimensions.pubsub import (
    PubSubClient,
    PubSubServer,
)
from streambench_tpu_torch.dimensions.store import DurableDimensionStore
from streambench_tpu_torch.ops import minhash
from streambench_tpu_torch.reach.replica import ReachReplica, SnapshotShipper
from streambench_tpu_torch.reach.router import (
    SUSPECT_AFTER,
    ReachRouter,
    ReplicaHandle,
    campaign_shard,
)
from streambench_tpu_torch.reach.serve import ReachQueryServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [f"c{i}" for i in range(6)]
K, R = 64, 128


# ----------------------------------------------------- campaign_shard
@pytest.mark.parametrize("seed", range(6))
def test_campaign_shard_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        sel = [f"camp-{int(x)}" for x in rng.integers(0, 10_000,
                                                      rng.integers(0, 6))]
        got = campaign_shard(sel, n)
        assert got == jax_router.campaign_shard(sel, n)
        assert 0 <= got < n
        assert campaign_shard(list(reversed(sel)), n) == got


def test_campaign_shard_degenerate_counts():
    for n in (0, -3, 1):
        assert campaign_shard(["a", "b"], n) == 0
        assert campaign_shard(["a", "b"], n) == \
            jax_router.campaign_shard(["a", "b"], n)


# --------------------------------------------------------- the ledger
def test_replica_handle_ledger_and_suspect_window(monkeypatch):
    h = ReplicaHandle("127.0.0.1:9")
    assert h.freshness_key() == float("inf") and not h.suspect()
    h.note_served({"staleness_ms": 12.5, "plane_epoch": 3})
    assert h.freshness_key() == 12.5 and h.last_epoch == 3
    h.note_shed({"reason": "stale", "staleness_ms": 99.0,
                 "plane_epoch": 4})
    assert h.stale_sheds == 1 and h.freshness_key() == 99.0
    t = {"now": 100.0}
    monkeypatch.setattr(time, "monotonic", lambda: t["now"])
    for _ in range(SUSPECT_AFTER):
        h.note_failure(timeout=True)
    assert h.suspect() and h.timeouts == SUSPECT_AFTER
    t["now"] += 60.0
    assert not h.suspect()
    health = h.health()
    assert health["staleness_ms"] == 99.0 and health["plane_epoch"] == 4
    assert health["stale_sheds"] == 1


# ------------------------------------------- routing over fake replicas
def _fake_replica(tag: str, *, shed=None, staleness_ms=5.0, epoch=3):
    srv = PubSubServer(port=0)

    def handle(msg, reply):
        if shed is not None:
            reply({"shed": True, "reason": shed, "plane_epoch": epoch,
                   "staleness_ms": staleness_ms, "id": msg.get("id")})
            return
        reply({"estimate": 1.0, "plane_epoch": epoch, "tag": tag,
               "staleness_ms": staleness_ms, "id": msg.get("id")})

    srv.register_query("reach", handle)
    return srv.start()


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _addr(srv) -> str:
    return f"127.0.0.1:{srv.address[1]}"


def test_router_sticky_by_campaign_set_hash():
    reps = [_fake_replica("r0"), _fake_replica("r1")]
    router = ReachRouter([_addr(r) for r in reps], timeout_s=5.0,
                         retries=0).start()
    try:
        c = PubSubClient(*router.address, timeout_s=10)
        for sel in [[f"c{i}"] for i in range(8)] + [["c1", "c2"]]:
            want = campaign_shard(sel, 2)
            for n in range(2):
                d = c.request({"type": "reach", "campaigns": sel,
                               "op": "union", "id": f"{sel}-{n}"},
                              timeout_s=5.0)
                assert d["tag"] == f"r{want}", (sel, d)
        c.close()
        assert router.failovers == 0
    finally:
        router.close()
        for r in reps:
            r.close()


def test_router_failover_to_the_freshest_and_demotes_the_dead():
    """Dead primary: the query lands on the FRESHEST of the others, the
    episode is recorded, and the primary is demoted once suspect."""
    fresh = _fake_replica("fresh", staleness_ms=5.0)
    stale = _fake_replica("stale", staleness_ms=900.0)
    dead = _dead_port()
    sel = next([f"s{i}"] for i in range(256)
               if campaign_shard([f"s{i}"], 3) == 0)
    router = ReachRouter([f"127.0.0.1:{dead}", _addr(stale), _addr(fresh)],
                         timeout_s=1.0, retries=0).start()
    # both live replicas have answered once: their freshness is known
    router.handles[1].note_served({"staleness_ms": 900.0})
    router.handles[2].note_served({"staleness_ms": 5.0})
    try:
        c = PubSubClient(*router.address, timeout_s=30)
        for n in range(3):
            d = c.request({"type": "reach", "campaigns": sel,
                           "op": "union", "id": n}, timeout_s=10.0)
            assert d["tag"] == "fresh"
        c.close()
        s = router.summary()
        assert s["failovers"] == SUSPECT_AFTER and s["answered"] == 3
        assert s["failover_p99_ms"] >= 0
        assert router.handles[0].suspect()
        assert s["replicas"][0]["suspect"] is True
    finally:
        router.close()
        fresh.close()
        stale.close()


@pytest.mark.parametrize("kind,want", [("stale", "all_stale"),
                                       ("depth", "overloaded"),
                                       (None, "no_replica")])
def test_router_sheds_honestly_with_its_reason(kind, want):
    if kind is None:
        reps = []
        addrs = [f"127.0.0.1:{_dead_port()}" for _ in range(2)]
    else:
        reps = [_fake_replica("r0", shed=kind),
                _fake_replica("r1", shed=kind)]
        addrs = [_addr(r) for r in reps]
    router = ReachRouter(addrs, timeout_s=1.0, retries=0).start()
    try:
        c = PubSubClient(*router.address, timeout_s=10)
        d = c.request({"type": "reach", "campaigns": ["x"],
                       "op": "union", "id": "q"}, timeout_s=10.0)
        assert d == {"shed": True, "reason": want, "id": "q"}
        c.close()
        s = router.summary()
        assert s["shed"] == 1 and s["answered"] == 0
        assert s["shed_ratio"] == 1.0
    finally:
        router.close()
        for r in reps:
            r.close()


def test_router_forwards_client_errors_without_failover():
    srv = PubSubServer(port=0)
    srv.register_query("reach", lambda msg, reply: reply(
        {"error": "bad_request", "id": msg.get("id")}))
    srv.start()
    other = _fake_replica("other")
    router = ReachRouter([_addr(srv), _addr(other)], timeout_s=5.0,
                         retries=0).start()
    try:
        sel = next([f"s{i}"] for i in range(64)
                   if campaign_shard([f"s{i}"], 2) == 0)
        c = PubSubClient(*router.address, timeout_s=10)
        d = c.request({"type": "reach", "campaigns": sel, "op": "nope",
                       "id": "e"}, timeout_s=5.0)
        assert d["error"] == "bad_request" and d["id"] == "e"
        c.close()
        assert router.failovers == 0
    finally:
        router.close()
        srv.close()
        other.close()


def test_add_and_remove_replica():
    a, b = _fake_replica("a"), _fake_replica("b")
    router = ReachRouter([_addr(a)], timeout_s=5.0, retries=0).start()
    try:
        router.add_replica(_addr(b))
        assert [h.addr for h in router.handles] == [_addr(a), _addr(b)]
        c = PubSubClient(*router.address, timeout_s=10)
        tags = {c.request({"type": "reach", "campaigns": [f"k{i}"],
                           "op": "union", "id": i},
                          timeout_s=5.0)["tag"] for i in range(16)}
        assert tags == {"a", "b"}
        assert router.remove_replica(_addr(b)) is True
        assert router.remove_replica("127.0.0.1:1") is False
        with pytest.raises(ValueError):
            router.remove_replica(_addr(a))
        tags = {c.request({"type": "reach", "campaigns": [f"k{i}"],
                           "op": "union", "id": f"x{i}"},
                          timeout_s=5.0)["tag"] for i in range(8)}
        assert tags == {"a"}
        c.close()
    finally:
        router.close()
        a.close()
        b.close()
    with pytest.raises(ValueError):
        ReachRouter([])


# ------------------------------------- routing over the port's replicas
def _planes(seed=3):
    rng = np.random.default_rng(seed)
    mins = rng.integers(0, 1 << 32, size=(len(NAMES), K), dtype=np.uint32)
    regs = rng.integers(0, 30, size=(len(NAMES), R)).astype(np.int32)
    return mins, regs


def _queries(n, seed=4):
    rng = np.random.default_rng(seed)
    return [(sorted(NAMES[j] for j in rng.choice(
        len(NAMES), size=int(rng.integers(1, 5)), replace=False)),
        "overlap" if i % 3 == 0 else "union") for i in range(n)]


def _served(server) -> PubSubServer:
    ps = PubSubServer(port=0)
    ps.register_query("reach", server.handle)
    return ps.start()


def test_routed_reply_is_byte_identical_to_the_direct_reply():
    mins, regs = _planes()
    servers, endpoints = [], []
    for _ in range(2):
        srv = ReachQueryServer(NAMES, batch=8)
        srv.update_state(minhash.mins_tensor(mins, "cpu"),
                         torch.from_numpy(regs.copy()), 5)
        servers.append(srv)
        endpoints.append(_served(srv))
    router = ReachRouter([_addr(e) for e in endpoints], timeout_s=5.0,
                         retries=0).start()
    try:
        rc = PubSubClient(*router.address, timeout_s=10)
        for i, (sel, op) in enumerate(_queries(12)):
            primary = endpoints[campaign_shard(sel, 2)]
            dc = PubSubClient(*primary.address, timeout_s=10)
            msg = {"type": "reach", "campaigns": sel, "op": op,
                   "id": f"q{i}"}
            direct = dc.request(dict(msg), timeout_s=5.0)
            routed = rc.request(dict(msg), timeout_s=5.0)
            dc.close()
            assert json.dumps(routed) == json.dumps(direct)
        rc.close()
    finally:
        router.close()
        for e, s in zip(endpoints, servers):
            e.close()
            s.close()


def _ship_log(tmp_path, mins, regs, epoch=2):
    store = DurableDimensionStore(str(tmp_path))
    SnapshotShipper(store, NAMES, interval_ms=1).note_state(
        mins, regs, epoch, 70_000)
    store.close()
    return os.path.join(str(tmp_path), "dimensions.log")


def test_routed_answers_agree_exactly_with_the_jax_server(tmp_path):
    """Two port replicas on ``cpu`` behind the router against the JAX
    package's server on the same planes: ``jaccard`` (the exact agree
    count over k) equal, estimates and unions within rtol 1e-6, every
    routed reply stamped with the shipped epoch."""
    mins, regs = _planes(11)
    log = _ship_log(tmp_path, mins, regs)
    reps = [ReachReplica(log, poll_ms=20, max_staleness_ms=600_000,
                         cache_capacity=0, device="cpu").start()
            for _ in range(2)]
    jsrv = JaxServer(NAMES, batch=8)
    jsrv.update_state(jnp.asarray(mins), jnp.asarray(regs), 2)
    router = ReachRouter([f"{h}:{p}" for h, p in (r.address for r in reps)],
                         timeout_s=5.0, retries=1).start()
    try:
        deadline = time.monotonic() + 30
        while any(r.server is None for r in reps):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        qs = _queries(24, seed=12)
        rc = PubSubClient(*router.address, timeout_s=10)
        got = [rc.request({"type": "reach", "campaigns": sel, "op": op,
                           "id": i}, timeout_s=10.0)
               for i, (sel, op) in enumerate(qs)]
        rc.close()
        want = []
        for i, (sel, op) in enumerate(qs):
            box = []
            jsrv.submit(sel, op, box.append, query_id=i)
            deadline = time.monotonic() + 10
            while not box:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            want.append(box[0])
        masks = np.zeros((len(qs), len(NAMES)), bool)
        for i, (sel, _) in enumerate(qs):
            masks[i, [NAMES.index(c) for c in sel]] = True
        agree = np.asarray(jax_rq.batch_query(
            jnp.asarray(mins), jnp.asarray(regs), jnp.asarray(masks),
            jnp.ones(len(qs), bool))[3])
        for i, (g, w) in enumerate(zip(got, want)):
            assert g["id"] == i and g["plane_epoch"] == 2
            assert g["jaccard"] == w["jaccard"] == round(
                float(agree[i]) / K, 5)
            assert g["estimate"] == pytest.approx(w["estimate"], rel=1e-6)
            assert g["union"] == pytest.approx(w["union"], rel=1e-6)
            assert g["bound"] == w["bound"] and g["op"] == w["op"]
        # sticky: each replica answered its own shard of the sets
        served = [r.server.served for r in reps]
        assert sum(served) == len(qs)
        want_split = [sum(campaign_shard(sel, 2) == j for sel, _ in qs)
                      for j in range(2)]
        assert served == want_split
    finally:
        router.close()
        jsrv.close()
        for r in reps:
            r.close()


def test_sent_equals_answered_plus_shed_through_a_replica_crash(tmp_path):
    mins, regs = _planes(21)
    log = _ship_log(tmp_path, mins, regs)
    reps = [ReachReplica(log, poll_ms=20, max_staleness_ms=600_000,
                         device="cpu").start() for _ in range(2)]
    router = ReachRouter([f"{h}:{p}" for h, p in (r.address for r in reps)],
                         timeout_s=1.0, retries=0).start()
    sent, replies = [], []
    try:
        deadline = time.monotonic() + 30
        while any(r.server is None for r in reps):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        c = PubSubClient(*router.address, timeout_s=30)
        for i, (sel, op) in enumerate(_queries(40, seed=22)):
            if i == 15:
                reps[0].close()          # a crash: its endpoint is gone
            qid = f"q{i}"
            sent.append(qid)
            replies.append(c.request({"type": "reach", "campaigns": sel,
                                      "op": op, "id": qid},
                                     timeout_s=30.0))
        reps[1].close()                  # the whole fleet down: sheds
        for i in range(3):
            qid = f"down{i}"
            sent.append(qid)
            replies.append(c.request(
                {"type": "reach", "campaigns": ["c0"], "op": "union",
                 "id": qid}, timeout_s=30.0))
        c.close()
    finally:
        router.close()
        for r in reps:
            r.close()
    v = check_fleet_accounting(sent, replies)
    assert v.ok, v.summary()
    assert v.sent == v.answered + v.shed == 43
    assert v.shed >= 3
    assert all(d.get("reason") == "no_replica"
               for d in replies[-3:])
    s = router.summary()
    assert s["routed"] == 43 and s["answered"] + s["shed"] == 43
    assert s["failovers"] >= 1


def test_the_jax_router_in_front_of_port_replicas_routes_the_same():
    """One wire format: the JAX package's router over the port's
    servers gives the replies the port's router gives."""
    mins, regs = _planes(31)
    servers, endpoints = [], []
    for _ in range(2):
        srv = ReachQueryServer(NAMES, batch=8)
        srv.update_state(minhash.mins_tensor(mins, "cpu"),
                         torch.from_numpy(regs.copy()), 7)
        servers.append(srv)
        endpoints.append(_served(srv))
    addrs = [_addr(e) for e in endpoints]
    ours = ReachRouter(addrs, timeout_s=5.0, retries=0).start()
    theirs = jax_router.ReachRouter(addrs, timeout_s=5.0,
                                    retries=0).start()
    try:
        a = PubSubClient(*ours.address, timeout_s=10)
        b = PubSubClient(*theirs.address, timeout_s=10)
        for i, (sel, op) in enumerate(_queries(10, seed=32)):
            msg = {"type": "reach", "campaigns": sel, "op": op, "id": i}
            assert json.dumps(a.request(dict(msg), timeout_s=5.0)) == \
                json.dumps(b.request(dict(msg), timeout_s=5.0))
        a.close()
        b.close()
    finally:
        ours.close()
        theirs.close()
        for e, s in zip(endpoints, servers):
            e.close()
            s.close()


# ---------------------------------------------------------------- CLI
def test_router_cli_journals_and_prints_its_stats(tmp_path):
    rep = _fake_replica("cli")
    env = dict(os.environ, PYTHONPATH=REPO)
    mdir = tmp_path / "router"
    proc = subprocess.Popen(
        [sys.executable, "-m", "streambench_tpu_torch.reach.router",
         "--replicas", _addr(rep), "--metrics-dir", str(mdir),
         "--metrics-interval-ms", "100", "--pid-file",
         str(tmp_path / "pids" / "router")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line.startswith("router: pubsub=") and "replicas=1" in line
        host, port = line.split()[1].split("=")[1].rsplit(":", 1)
        c = PubSubClient(host, int(port), timeout_s=10)
        d = c.request({"type": "reach", "campaigns": ["a"], "op": "union",
                       "id": "x"}, timeout_s=10.0)
        c.close()
        assert d["tag"] == "cli" and d["id"] == "x"
        time.sleep(0.3)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        rep.close()
    assert proc.returncode == 0, err[-2000:]
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["routed"] == 1 and stats["answered"] == 1
    recs = [json.loads(ln) for ln in open(mdir / "metrics.jsonl")]
    assert recs and all(r["role"] == "router" for r in recs)
    assert recs[-1]["kind"] == "final" and "router" in recs[-1]
    assert not os.path.exists(tmp_path / "pids" / "router")


def test_concurrent_clients_through_the_router_each_get_one_answer():
    """Eight client threads through one router over two fake replicas:
    every request id answered exactly once (the router's own ids never
    collide across threads)."""
    reps = [_fake_replica("r0"), _fake_replica("r1")]
    router = ReachRouter([_addr(r) for r in reps], timeout_s=5.0,
                         retries=0).start()
    got, lock = [], threading.Lock()

    def client(t):
        c = PubSubClient(*router.address, timeout_s=10)
        for i in range(25):
            d = c.request({"type": "reach", "campaigns": [f"k{i % 7}"],
                           "op": "union", "id": f"{t}-{i}"}, timeout_s=10)
            with lock:
                got.append(d["id"])
        c.close()

    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        router.close()
        for r in reps:
            r.close()
    assert sorted(got) == sorted(f"{t}-{i}" for t in range(8)
                                 for i in range(25))
    assert router.summary()["routed"] == 200
