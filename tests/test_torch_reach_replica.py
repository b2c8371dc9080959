"""Snapshot-shipped reach read replicas in the port (``streambench_tpu_torch
/reach/replica.py``), on the CPU; the reference's
``tests/test_reach_replica.py`` as cases of the port.

The shipper's cadence and epoch-bump immediacy, the ship-log tailer
(torn tails), replica serving with ``plane_epoch`` / ``staleness_ms``
stamps, the staleness-bound shed, and shed-or-answer exactness under a
storm with re-ships.  The ship log is a wire format: a log the JAX
package's shipper wrote tails into the port's replica, and the port's
log tails into the JAX package's ``ShipLogTailer`` / ``ChainTailer``,
with identical planes.  The replica runs on the device it is given
(``cuda`` by default, raising without it), fleet mode included.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.dimensions.store import (
    DurableDimensionStore as JaxStore,
)
from streambench_tpu.ops import minhash as jax_minhash
from streambench_tpu.reach import replica as jax_replica
from streambench_tpu.reach.deltaship import ChainTailer as JaxChainTailer
from streambench_tpu.reach.deltaship import DeltaShipper as JaxDeltaShipper
from streambench_tpu_torch.dimensions.pubsub import PubSubClient
from streambench_tpu_torch.dimensions.store import DurableDimensionStore
from streambench_tpu_torch.ops import minhash
from streambench_tpu_torch.reach import query as rq
from streambench_tpu_torch.reach.deltaship import DeltaShipper
from streambench_tpu_torch.reach.replica import (
    DEFAULT_MAX_STALENESS_MS,
    ReachReplica,
    ShipLogTailer,
    SnapshotShipper,
    decode_ship_record,
)
from streambench_tpu_torch.utils.ids import now_ms
from tests.test_torch_engine import REPO

NAMES = ["c0", "c1", "c2"]


def fold_planes(users, C=3, k=16, R=16):
    """(mins uint32, registers int32) numpy planes of the users folded
    into campaign 0 by the port's fold."""
    st = minhash.init_state(C, k, R)
    B = len(users)
    st = minhash.step(
        st, torch.arange(C, dtype=torch.int32),
        torch.zeros(B, dtype=torch.int32),
        torch.from_numpy(np.asarray(users, np.int32)),
        torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32),
        torch.ones(B, dtype=torch.bool))
    return minhash.mins_numpy(st.mins), st.registers.numpy().copy()


def rec_b64(arr, dtype=np.uint32):
    import base64

    return base64.b64encode(
        np.ascontiguousarray(np.asarray(arr), dtype=dtype).tobytes()
    ).decode()


def ask(host, port, campaigns, qid, op="union"):
    c = PubSubClient(host, port, timeout_s=20)
    c.request({"type": "reach", "campaigns": campaigns, "op": op,
               "id": qid})
    out = c.recv()["data"]
    c.close()
    return out


def expected_estimate(mins, regs, idx, overlap=False):
    m = np.zeros((1, mins.shape[0]), bool)
    m[0, idx] = True
    est = rq.batch_query(minhash.mins_tensor(mins),
                         torch.from_numpy(regs.copy()), m,
                         np.array([overlap]))[0]
    return round(float(est[0]), 2)


# ------------------------------------------------------------ shipper
def test_shipper_cadence_and_epoch_bump(tmp_path):
    store = DurableDimensionStore(str(tmp_path))
    ship = SnapshotShipper(store, NAMES, interval_ms=10_000)
    mins, regs = fold_planes([1, 2, 3])
    assert ship.note_state(mins, regs, 0, 70_000)
    # within the cadence, same epoch: suppressed
    assert not ship.due(0)
    assert not ship.note_state(mins, regs, 0, 70_000)
    # an epoch bump ships at once
    assert ship.due(1)
    assert ship.note_state(mins, regs, 1, 70_000)
    # force bypasses the cadence (the writer's close-time ship)
    assert ship.note_state(mins, regs, 1, 80_000, force=True)
    assert ship.ships == 3
    store.close()
    for store_cls in (DurableDimensionStore, JaxStore):
        rec = store_cls(str(tmp_path)).reach_sketches()
        assert rec["epoch"] == 1 and rec["watermark"] == 80_000
        np.testing.assert_array_equal(rec["mins"], mins)
        np.testing.assert_array_equal(rec["registers"], regs)


def test_tailer_incremental_and_torn_tail(tmp_path):
    store = DurableDimensionStore(str(tmp_path))
    ship = SnapshotShipper(store, NAMES, interval_ms=1)
    tail = ShipLogTailer(store.path)
    assert tail.poll() is None
    mins, regs = fold_planes([1])
    ship.note_state(mins, regs, 0, 1)
    rec = tail.poll()
    assert rec is not None and rec["epoch"] == 0
    assert tail.poll() is None            # nothing new
    ship.note_state(mins, regs, 1, 2)
    ship.note_state(mins, regs, 2, 3)
    assert tail.poll()["epoch"] == 2      # the newest of the batch wins
    # a torn tail line stays buffered until its newline lands
    good = json.dumps({"kind": "reach_sketch", "t": now_ms(),
                       "epoch": 7, "c": NAMES, "k": 16, "r": 16,
                       "mins": rec_b64(mins),
                       "regs": rec_b64(regs, np.int32)})
    with open(store.path, "a") as f:
        f.write(good[: len(good) // 2])
        f.flush()
    assert tail.poll() is None
    with open(store.path, "a") as f:
        f.write(good[len(good) // 2:] + "\n")
    assert tail.poll()["epoch"] == 7
    assert decode_ship_record({"kind": "reach_sketch", "c": NAMES}) is None
    store.close()


# ------------------------------------------------------------ replica
def test_replica_serves_epoch_stamped_and_staleness_bounded(tmp_path):
    store = DurableDimensionStore(str(tmp_path))
    ship = SnapshotShipper(store, NAMES, interval_ms=1)
    mins, regs = fold_planes([10, 20, 30])
    shipped_at = now_ms()
    ship.note_state(mins, regs, 3, 70_000)
    rep = ReachReplica(store.path, poll_ms=20_000, device="cpu")
    rep.pubsub.start()
    try:
        assert rep.poll_once()
        d = ask(*rep.address, ["c0", "c1"], 1)
        assert "estimate" in d and d["plane_epoch"] == 3
        assert 0 <= d["staleness_ms"] <= (now_ms() - shipped_at) + 50
        assert d["staleness_ms"] <= DEFAULT_MAX_STALENESS_MS
        assert d["estimate"] == expected_estimate(mins, regs, [0, 1])
        # the served planes live on the replica's device, as new tensors
        st = rep.server._state
        assert st[0].device.type == "cpu" and st[0].dtype == torch.int64
        np.testing.assert_array_equal(minhash.mins_numpy(st[0]), mins)
        assert rep.summary()["device"] == "cpu"
    finally:
        rep.close()
        store.close()


def test_replica_sheds_before_first_epoch_and_past_bound(tmp_path):
    store = DurableDimensionStore(str(tmp_path))
    ship = SnapshotShipper(store, NAMES, interval_ms=1)
    rep = ReachReplica(store.path, poll_ms=20_000, max_staleness_ms=300,
                       device="cpu")
    rep.pubsub.start()
    try:
        host, port = rep.address
        d = ask(host, port, ["c0"], 1)
        assert d.get("shed") and d.get("reason") == "stale"
        assert d["plane_epoch"] is None and rep.shed_before_load == 1

        mins, regs = fold_planes([1, 2])
        ship.note_state(mins, regs, 0, 1)
        assert rep.poll_once()
        d = ask(host, port, ["c0"], 2)
        assert "estimate" in d and d["plane_epoch"] == 0

        # age the planes past the bound: shed, with the evidence
        time.sleep(0.4)
        d = ask(host, port, ["c0"], 3)
        assert d.get("shed") and d.get("reason") == "stale"
        assert d["plane_epoch"] == 0 and d["staleness_ms"] > 300
        assert rep.server.shed_stale >= 1

        # a fresh ship resumes service on the new record
        ship.note_state(mins, regs, 1, 2)
        assert rep.poll_once()
        d = ask(host, port, ["c0"], 4)
        assert "estimate" in d and d["plane_epoch"] == 1
        s = rep.server.summary()
        assert s["served"] + s["shed"] == 3     # q2..q4; q1 pre-server
    finally:
        rep.close()
        store.close()


def test_replica_chaos_storm_sheds_or_answers_exactly(tmp_path):
    """Concurrent epoch bumps and re-ships while a query storm runs
    against the replica: every query sheds or answers, every answer's
    plane epoch is a shipped one, and after the dust settles answers
    carry the live epoch."""
    store = DurableDimensionStore(str(tmp_path))
    ship = SnapshotShipper(store, NAMES, interval_ms=1)
    states = {e: fold_planes(list(range(1, 3 + e * 5))) for e in range(5)}
    ship.note_state(*states[0], 0, 1)
    rep = ReachReplica(store.path, poll_ms=5, max_staleness_ms=5_000,
                       device="cpu").start()
    stop = threading.Event()

    def chaos():
        rng = random.Random(9)
        e = 0
        while not stop.is_set():
            e = min(e + rng.choice([0, 1]), 4)
            ship.note_state(*states[e], e, 1 + e, force=True)
            time.sleep(0.02)

    t = threading.Thread(target=chaos)
    t.start()
    answers = []
    try:
        c = PubSubClient(*rep.address, timeout_s=30)
        for i in range(120):
            c.request({"type": "reach", "campaigns": [NAMES[i % 3]],
                       "op": "union", "id": i})
            answers.append(c.recv()["data"])
            time.sleep(0.002)
        c.close()
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert len(answers) == 120
    assert all(("estimate" in d) or d.get("shed") for d in answers)
    served = [d for d in answers if "estimate" in d]
    assert served, "storm served nothing"
    assert all(d["plane_epoch"] in range(5) for d in served)
    assert all("staleness_ms" in d for d in served)
    time.sleep(0.2)
    rep.poll_once()
    d = ask(*rep.address, ["c0"], "final")
    assert "estimate" in d and d["plane_epoch"] == rep.server.epoch
    s = rep.summary()
    assert (s["serve"]["served"] + s["serve"]["shed"]
            + s["shed_before_load"]) == 121
    rep.close()
    store.close()


# -------------------------------------------------- across the packages
def jax_planes(users, C=3, k=16, R=16):
    st = jax_minhash.init_state(C, k, R)
    B = len(users)
    st = jax_minhash.step(
        st, jnp.arange(C, dtype=jnp.int32), jnp.zeros(B, jnp.int32),
        jnp.asarray(np.asarray(users, np.int32)), jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.int32), jnp.ones(B, bool))
    return st


@pytest.mark.parametrize("mode", ["full", "delta"])
def test_a_jax_shipped_log_tails_into_the_ports_replica(tmp_path, mode):
    """The JAX package's shipper writes the log from JAX planes; the
    port's replica folds it (bases and deltas) to the same planes and
    answers as the port evaluates them."""
    store = JaxStore(str(tmp_path))
    cls = (JaxDeltaShipper if mode == "delta"
           else jax_replica.SnapshotShipper)
    ship = cls(store, NAMES, interval_ms=1)
    rep = ReachReplica(store.path, poll_ms=20_000, cache_capacity=0,
                       device="cpu")
    rep.pubsub.start()
    try:
        for e in range(4):
            st = jax_planes(list(range(1, 10 + 40 * e)))
            ship.note_state(st.mins, st.registers, 1, watermark=e,
                            dirty_rows=np.array([0]))
            time.sleep(0.002)
            assert rep.poll_once()
            srv = rep.server._state
            np.testing.assert_array_equal(minhash.mins_numpy(srv[0]),
                                          np.asarray(st.mins))
            np.testing.assert_array_equal(srv[1].numpy(),
                                          np.asarray(st.registers))
        d = ask(*rep.address, ["c0"], "x")
        assert d["estimate"] == expected_estimate(
            np.asarray(st.mins), np.asarray(st.registers), [0])
        if mode == "delta":
            assert rep.summary()["tailer"]["deltas_folded"] == 3
    finally:
        rep.close()
        store.close()


@pytest.mark.parametrize("mode", ["full", "delta"])
def test_the_ports_log_tails_into_the_jax_tailers(tmp_path, mode):
    """The port's shipper writes the log from the port's planes; the JAX
    package's ``ShipLogTailer`` (bases) and ``ChainTailer`` (bases and
    deltas) read the planes back bit for bit."""
    store = DurableDimensionStore(str(tmp_path))
    cls = DeltaShipper if mode == "delta" else SnapshotShipper
    ship = cls(store, NAMES, interval_ms=1)
    chain = JaxChainTailer(store.path)
    legacy = jax_replica.ShipLogTailer(store.path)
    for e in range(4):
        mins, regs = fold_planes(list(range(1, 10 + 40 * e)))
        ship.note_state(mins, regs, 2, watermark=e,
                        dirty_rows=np.array([0]))
        time.sleep(0.002)
        view = chain.poll()
        np.testing.assert_array_equal(view["mins"], mins)
        np.testing.assert_array_equal(view["registers"], regs)
        assert view["epoch"] == 2 and view["watermark"] == e
        base = legacy.poll()
        if mode == "full" or e == 0:
            np.testing.assert_array_equal(base["mins"], mins)
        else:
            assert base is None        # deltas are the chain tailer's
    assert chain.stats()["deltas_folded"] == (3 if mode == "delta" else 0)
    store.close()


# ---------------------------------------------------- device and CLI
def test_replica_defaults_to_cuda_and_refuses_fleet(monkeypatch, tmp_path,
                                                   capsys):
    """The replica, fleet mode included, runs on ``cuda`` unless asked
    for ``cpu``: without CUDA it raises rather than start on the CPU,
    and ``--fleet --device cpu`` serves and reports its fleet block."""
    from streambench_tpu_torch.reach import replica

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "dimensions.log")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReachReplica(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReachReplica(path, fleet=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        replica.main(["--ship", path, "--fleet"])
    assert "replica: pubsub=" not in capsys.readouterr().out
    assert replica.main(["--ship", path, "--fleet", "--device", "cpu",
                         "--duration", "0.2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("replica: pubsub=") and "fleet=on" in out[0]
    stats = json.loads(out[-1])
    assert stats["device"] == "cpu" and stats["fleet"] is True


def test_replica_cli_serves_a_log_and_exits_with_its_stats(tmp_path):
    store = DurableDimensionStore(str(tmp_path))
    mins, regs = fold_planes([5, 6, 7, 8])
    SnapshotShipper(store, NAMES, interval_ms=1).note_state(mins, regs,
                                                            4, 9)
    store.close()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "streambench_tpu_torch.reach.replica",
         "--ship", str(tmp_path), "--device", "cpu", "--poll-ms", "20",
         "--max-staleness-ms", "600000"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line.startswith("replica: pubsub="), line
        host, port = line.split()[1].split("=")[1].rsplit(":", 1)
        deadline = time.monotonic() + 60
        d = {}
        while time.monotonic() < deadline:
            d = ask(host, int(port), ["c0"], "cli")
            if "estimate" in d:
                break
            time.sleep(0.05)
        assert d.get("plane_epoch") == 4
        assert d["estimate"] == expected_estimate(mins, regs, [0])
        proc.terminate()
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["device"] == "cpu" and stats["plane_loads"] >= 1
    assert stats["serve"]["served"] >= 1
