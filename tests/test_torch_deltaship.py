"""Incremental delta ships in the port (``streambench_tpu_torch/reach/
deltaship.py``, a pure-numpy copy of the JAX package's), on the CPU; the
reference's ``tests/test_deltaship.py`` as cases of the port.

Chain-stamped dirty-row records between periodic bases, the
chain-validating tailer (a gap or damage serves the last consistent
state and resyncs at the next base, never a half-folded plane), the Δ/C
cutover, a forced ship always a base, store replay, ship faults on delta
records, the seeded drop/tear sweep, and the replica over a delta log.
The log is a wire format shared with the JAX package: each tailer case
also runs the JAX package's ``ChainTailer`` over the port's log, and the
sweep also runs the JAX package's ``DeltaShipper`` into the port's
tailer; every view must agree bit for bit.
"""

import hashlib
import json
import os
import time

import numpy as np
import pytest

from streambench_tpu.reach.deltaship import ChainTailer as JaxChainTailer
from streambench_tpu.reach.deltaship import DeltaShipper as JaxDeltaShipper
from streambench_tpu_torch.dimensions.store import (
    LOG_NAME,
    DurableDimensionStore,
)
from streambench_tpu_torch.obs import MetricsRegistry
from streambench_tpu_torch.reach.deltaship import (
    DELTA_KIND,
    REACH_PLANES,
    ChainTailer,
    DeltaShipper,
    decode_delta_record,
    merge_rows,
)
from streambench_tpu_torch.reach.replica import SnapshotShipper

TAILERS = {"port": ChainTailer, "jax": JaxChainTailer}

C, K, R = 24, 4, 4
EMPTY = np.uint32(0xFFFFFFFF)
NAMES = [f"c{i}" for i in range(C)]


def fresh_planes(c=C):
    return (np.full((c, K), EMPTY, np.uint32),
            np.zeros((c, R), np.int32))


def touch(rng, mins, regs, n=5):
    """One tick's worth of row touches; returns the touched indices."""
    idx = np.unique(rng.integers(0, mins.shape[0], n))
    mins[idx] = np.minimum(
        mins[idx], rng.integers(0, 2**32, (idx.size, K), dtype=np.uint32))
    regs[idx] = np.maximum(
        regs[idx], rng.integers(0, 30, (idx.size, R), dtype=np.int32))
    return idx


def digest(view):
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(view["mins"], np.uint32).tobytes())
    h.update(np.ascontiguousarray(view["registers"], np.int32).tobytes())
    return h.hexdigest()


def ship_path(tmp_path):
    return os.path.join(str(tmp_path), LOG_NAME)


# --------------------------------------------------------- wire format
def test_delta_record_roundtrip(tmp_path):
    store = DurableDimensionStore(str(tmp_path))
    idx = np.array([3, 7], np.int32)
    rows = {"mins": np.arange(2 * K, dtype=np.uint32).reshape(2, K),
            "regs": np.arange(2 * R, dtype=np.int32).reshape(2, R)}
    n = store.put_reach_delta(idx, rows, epoch=2, seq=5, prev_seq=4,
                              watermark=70_000, folded_ms=1, submit_ms=2)
    assert n > 0
    line = open(ship_path(tmp_path)).read().strip()
    rec = json.loads(line)
    assert rec["kind"] == DELTA_KIND and len(line) + 1 == n
    d = decode_delta_record(rec)
    assert d is not None
    assert d["seq"] == 5 and d["ps"] == 4 and d["epoch"] == 2
    assert np.array_equal(d["idx"], idx)
    assert np.array_equal(d["rows"]["mins"], rows["mins"])
    assert np.array_equal(d["rows"]["registers"], rows["regs"])
    assert d["watermark"] == 70_000


def test_decode_delta_rejects_damage():
    assert decode_delta_record({"kind": "nope"}) is None
    # missing chain stamps / unparseable payloads are None, not raises
    assert decode_delta_record({"kind": DELTA_KIND, "seq": 1}) is None
    # payload/index length skew (a corrupt tail): reshape must fail
    import base64 as b64
    assert decode_delta_record(
        {"kind": DELTA_KIND, "seq": 1, "ps": 0, "k": K, "r": R,
         "idx": b64.b64encode(np.zeros(2, np.int32).tobytes()).decode(),
         "mins": b64.b64encode(np.zeros(K, np.uint32).tobytes()).decode(),
         "regs": b64.b64encode(
             np.zeros(2 * R, np.int32).tobytes()).decode()}) is None


def test_merge_rows_is_min_max_and_copies_readonly():
    mins, regs = fresh_planes()
    ro = {"mins": np.frombuffer(mins.tobytes(), np.uint32).reshape(C, K),
          "registers": np.frombuffer(regs.tobytes(),
                                     np.int32).reshape(C, R)}
    assert not ro["mins"].flags.writeable
    idx = np.array([1], np.int32)
    rows = {"mins": np.full((1, K), 9, np.uint32),
            "registers": np.full((1, R), 9, np.int32)}
    merge_rows(ro, idx, rows, REACH_PLANES)
    assert ro["mins"].flags.writeable           # lazily copied
    assert (ro["mins"][1] == 9).all() and (ro["registers"][1] == 9).all()
    # idempotent re-fold: min/max absorb the same rows
    merge_rows(ro, idx, rows, REACH_PLANES)
    assert (ro["mins"][1] == 9).all() and (ro["registers"][1] == 9).all()


# ------------------------------------------------------------- shipper
def test_deltashipper_chain_base_cadence_and_counts(tmp_path):
    store = DurableDimensionStore(str(tmp_path))
    ship = DeltaShipper(store, NAMES, interval_ms=1, base_every=4)
    rng = np.random.default_rng(3)
    mins, regs = fresh_planes()
    for t in range(9):
        idx = touch(rng, mins, regs)
        assert ship.note_state(mins, regs, 1, watermark=t,
                               dirty_rows=idx)
        time.sleep(0.002)
    # first ship is a base (new epoch), then 4 deltas per base period
    assert ship.bases == 2 and ship.deltas == 7 and ship.ships == 9
    # the log carries a contiguous seq chain
    kinds, seqs = [], []
    for line in open(ship_path(tmp_path)):
        rec = json.loads(line)
        kinds.append(rec["kind"])
        seqs.append(rec["seq"])
    assert seqs == list(range(1, 10))
    assert kinds[0] == "reach_sketch" and kinds.count("reach_sketch") == 2


def test_cutover_large_dirty_set_ships_base(tmp_path):
    store = DurableDimensionStore(str(tmp_path))
    ship = DeltaShipper(store, NAMES, interval_ms=1, cutover_frac=0.5)
    mins, regs = fresh_planes()
    assert ship.note_state(mins, regs, 1, dirty_rows=np.arange(2))
    time.sleep(0.002)
    # dirty covers >= cutover_frac * C: a delta would cost more than
    # the base it replaces — ship the base, restart the chain
    assert ship.note_state(mins, regs, 1,
                           dirty_rows=np.arange(C // 2 + 1))
    assert ship.bases == 2 and ship.cutovers == 1 and ship.deltas == 0


@pytest.mark.parametrize("reader", TAILERS)
def test_empty_dirty_set_ships_heartbeat_delta(tmp_path, reader):
    store = DurableDimensionStore(str(tmp_path))
    ship = DeltaShipper(store, NAMES, interval_ms=1)
    mins, regs = fresh_planes()
    assert ship.note_state(mins, regs, 1, dirty_rows=np.arange(1))
    time.sleep(0.002)
    # a quiet cadence tick still ships a zero-row delta: the chain and
    # the replica's staleness anchor stay alive without plane bytes
    assert ship.note_state(mins, regs, 1, watermark=5,
                           dirty_rows=np.array([], np.int64))
    assert ship.deltas == 1 and ship.rows_last == 0
    tail = TAILERS[reader](ship_path(tmp_path))
    view = tail.poll()
    assert view["watermark"] == 5
    assert tail.stats()["deltas_folded"] == 1


@pytest.mark.parametrize("reader", TAILERS)
def test_force_ships_base_under_delta_mode(tmp_path, reader):
    """The restart-path forced ship must be a BASE — a respawned
    writer's dirty set is empty, and a forced delta would ship nothing
    and strand replicas."""
    store = DurableDimensionStore(str(tmp_path))
    ship = DeltaShipper(store, NAMES, interval_ms=10**9)
    rng = np.random.default_rng(5)
    mins, regs = fresh_planes()
    touch(rng, mins, regs)
    assert ship.note_state(mins, regs, 1, dirty_rows=np.arange(1))
    # same epoch, cadence closed, dirty EMPTY (the respawn case):
    # force must bypass the gate AND pick the base branch
    assert ship.note_state(mins, regs, 1, force=True,
                           dirty_rows=np.array([], np.int64))
    assert ship.bases == 2 and ship.deltas == 0
    tail = TAILERS[reader](ship_path(tmp_path))
    view = tail.poll()
    assert np.array_equal(view["mins"], mins)
    assert tail.stats()["bases_loaded"] == 2


def test_epoch_bump_ships_base_immediately(tmp_path):
    store = DurableDimensionStore(str(tmp_path))
    ship = DeltaShipper(store, NAMES, interval_ms=10**9)
    mins, regs = fresh_planes()
    assert ship.note_state(mins, regs, 1, dirty_rows=np.arange(1))
    # epoch bump: ships NOW (cadence bypassed) and as a base (replicas
    # must not fold cross-epoch deltas)
    assert ship.due(2)
    assert ship.note_state(mins, regs, 2, dirty_rows=np.arange(1))
    assert ship.bases == 2 and ship.deltas == 0


def test_shipper_gauges_and_summary(tmp_path):
    reg = MetricsRegistry()
    store = DurableDimensionStore(str(tmp_path))
    ship = DeltaShipper(store, NAMES, interval_ms=1, registry=reg)
    rng = np.random.default_rng(7)
    mins, regs = fresh_planes()
    ship.note_state(mins, regs, 1, dirty_rows=np.arange(1))
    time.sleep(0.002)
    idx = touch(rng, mins, regs, n=3)
    ship.note_state(mins, regs, 1, dirty_rows=idx)
    s = ship.summary()
    assert s["mode"] == "delta" and s["ships"] == 2
    assert s["rows_per_tick"] == idx.size
    assert 0 < s["bytes_per_tick"] < s["bytes_total"]
    assert s["ship_ms_per_tick"] >= 0
    text = reg.render_prometheus()
    assert "streambench_ship_bytes_per_tick" in text
    assert "streambench_ship_rows_per_tick" in text
    assert "streambench_ship_ms_per_tick" in text
    # the full-plane shipper reports the same surface (mode=full)
    full = SnapshotShipper(store, NAMES, interval_ms=1)
    full.note_state(mins, regs, 9)
    assert full.summary()["mode"] == "full"
    assert full.summary()["rows_per_tick"] == C


# -------------------------------------------------------- chain tailer
@pytest.mark.parametrize("reader", TAILERS)
def test_tailer_folds_chain_bit_identically(tmp_path, reader):
    store = DurableDimensionStore(str(tmp_path))
    ship = DeltaShipper(store, NAMES, interval_ms=1, base_every=100)
    tail = TAILERS[reader](ship_path(tmp_path))
    rng = np.random.default_rng(11)
    mins, regs = fresh_planes()
    for t in range(8):
        idx = touch(rng, mins, regs)
        assert ship.note_state(mins, regs, 1, watermark=t,
                               dirty_rows=idx)
        time.sleep(0.002)
        view = tail.poll()
        # every prefix of the chain folds to the writer's exact planes
        assert np.array_equal(view["mins"], mins)
        assert np.array_equal(view["registers"], regs)
        assert view["watermark"] == t
    st = tail.stats()
    assert st["bases_loaded"] == 1 and st["deltas_folded"] == 7
    assert st["gaps"] == 0 and st["damaged"] == 0


@pytest.mark.parametrize("reader", TAILERS)
def test_tailer_gap_freezes_view_until_next_base(tmp_path, reader):
    store = DurableDimensionStore(str(tmp_path))
    ship = DeltaShipper(store, NAMES, interval_ms=1, base_every=100)
    rng = np.random.default_rng(13)
    mins, regs = fresh_planes()
    assert ship.note_state(mins, regs, 1,
                           dirty_rows=np.arange(1))           # base
    frozen = (mins.copy(), regs.copy())
    time.sleep(0.002)
    idx = touch(rng, mins, regs)
    assert ship.note_state(mins, regs, 1, dirty_rows=idx)     # delta 2
    # drop delta seq=2 from the log: the tailer must detect ps skew
    lines = open(ship_path(tmp_path)).readlines()
    time.sleep(0.002)
    idx = touch(rng, mins, regs)
    ship.note_state(mins, regs, 1, dirty_rows=idx)            # delta 3
    tail = TAILERS[reader](ship_path(tmp_path))
    lines3 = open(ship_path(tmp_path)).readlines()
    with open(ship_path(tmp_path), "w") as f:
        f.writelines([lines3[0]] + lines3[2:])
    view = tail.poll()
    # base loaded; delta 3 does NOT chain off seq 1 — view is the
    # base, never a half-fold
    assert np.array_equal(view["mins"], frozen[0])
    assert np.array_equal(view["registers"], frozen[1])
    assert tail.stats()["gaps"] == 1 and tail.stats()["seq"] is None
    # further deltas stay dropped while desynced
    time.sleep(0.002)
    idx = touch(rng, mins, regs)
    ship.note_state(mins, regs, 1, dirty_rows=idx)            # delta 4
    assert tail.poll() is None
    assert tail.stats()["gaps"] == 2
    # next base resyncs to the live planes
    ship.note_state(mins, regs, 1, force=True)
    view = tail.poll()
    assert np.array_equal(view["mins"], mins)
    assert tail.stats()["resyncs"] == 1


@pytest.mark.parametrize("reader", TAILERS)
def test_ship_faults_land_on_delta_records(tmp_path, reader):
    """Torn and corrupt ship faults hit delta records through the same
    store hook; the tailer treats both as a broken chain."""
    store = DurableDimensionStore(str(tmp_path))
    faults = {2: "torn", 4: "corrupt"}     # 0-based appended-record idx
    count = {"n": 0}

    def hook(data):
        kind = faults.get(count["n"])
        count["n"] += 1
        if kind == "torn":
            return data[: len(data) // 2], False
        if kind == "corrupt":
            half = len(data) // 2
            return data[:half] + "\x00" * (len(data) - half - 1) + "\n", \
                False
        return data, True

    store.ship_fault_hook = hook
    ship = DeltaShipper(store, NAMES, interval_ms=1, base_every=100)
    tail = TAILERS[reader](ship_path(tmp_path))
    rng = np.random.default_rng(17)
    mins, regs = fresh_planes()
    for t in range(6):
        idx = touch(rng, mins, regs)
        ship.note_state(mins, regs, 1, dirty_rows=idx)
        time.sleep(0.002)
        view = tail.poll()
        if view is not None:
            # whatever the tailer serves is a consistent prefix fold —
            # between the torn record and the resync it simply stays
            # behind; it NEVER diverges from some writer state
            assert view["epoch"] == 1
    # recovery: a forced base resyncs the tailer to the live planes
    ship.note_state(mins, regs, 1, force=True)
    view = tail.poll()
    assert np.array_equal(view["mins"], mins)
    assert np.array_equal(view["registers"], regs)
    st = tail.stats()
    assert st["damaged"] + st["gaps"] >= 1
    assert st["resyncs"] >= 1


@pytest.mark.parametrize("reader", TAILERS)
def test_tailer_legacy_base_only_log(tmp_path, reader):
    """Full-ship logs (no seq, no deltas) read exactly like before:
    newest base wins."""
    store = DurableDimensionStore(str(tmp_path))
    ship = SnapshotShipper(store, NAMES, interval_ms=1)
    rng = np.random.default_rng(19)
    mins, regs = fresh_planes()
    for t in range(3):
        touch(rng, mins, regs)
        ship.note_state(mins, regs, t)     # epoch bump each tick
        time.sleep(0.002)
    tail = TAILERS[reader](ship_path(tmp_path))
    view = tail.poll()
    assert view["epoch"] == 2
    assert np.array_equal(view["mins"], mins)
    assert tail.stats()["bases_loaded"] == 3


# ------------------------------------------- seeded drop/tear property
@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6, 7, 8])
def test_property_chain_gap_resync(tmp_path, seed, writer):
    """Drop or tear arbitrary delta records: every polled view must be
    one of the writer's per-tick states (never half-folded), and the
    tailer must converge bit-identically after the next base."""
    rng = np.random.default_rng(seed)
    store = DurableDimensionStore(str(tmp_path))

    plan = {}       # appended-record index -> fault
    count = {"n": 0}

    def hook(data):
        kind = plan.get(count["n"])
        count["n"] += 1
        if kind == "drop":
            return "", False
        if kind == "torn":
            return data[: max(len(data) // 2, 1)], False
        return data, True

    store.ship_fault_hook = hook
    # the JAX package's shipper writes through the port's store: the
    # same record bytes (the store is a verbatim copy)
    ship = (DeltaShipper if writer == "port" else JaxDeltaShipper)(
        store, NAMES, interval_ms=1, base_every=6)
    tail = ChainTailer(ship_path(tmp_path))
    mins, regs = fresh_planes()
    tick_digests = set()
    gaps_seen = False
    for t in range(20):
        # ~1 in 3 records damaged, bases included
        if rng.random() < 0.34:
            plan[t] = "drop" if rng.random() < 0.5 else "torn"
        idx = touch(rng, mins, regs)
        ship.note_state(mins, regs, 1, watermark=t, dirty_rows=idx)
        tick_digests.add(digest({"mins": mins, "registers": regs}))
        time.sleep(0.002)
        view = tail.poll()
        if view is not None:
            # consistency invariant: the served fold equals SOME
            # writer tick state — no half-folded plane, ever
            assert digest(view) in tick_digests, \
                f"half-folded plane served (seed {seed}, tick {t})"
        st = tail.stats()
        gaps_seen = gaps_seen or st["gaps"] > 0 or st["damaged"] > 0
    # convergence: an undamaged forced base always resyncs exactly.
    # Two bases: a trailing torn record (no newline) glues onto the
    # next append, so the first recovery base may itself be lost —
    # exactly the torn-tail behavior of a ship-log fault.
    ship.note_state(mins, regs, 1, force=True)
    ship.note_state(mins, regs, 1, force=True)
    view = tail.poll()
    assert view is not None
    assert np.array_equal(view["mins"], mins)
    assert np.array_equal(view["registers"], regs)
    # the sweep is only meaningful if damage actually landed somewhere
    # across the seeds; per-seed it may or may not hit a delta
    if plan:
        assert count["n"] > max(plan)


# ------------------------------------------------- store replay/compact
def test_store_replay_folds_delta_chain(tmp_path):
    store = DurableDimensionStore(str(tmp_path))
    ship = DeltaShipper(store, NAMES, interval_ms=1, base_every=100)
    rng = np.random.default_rng(23)
    mins, regs = fresh_planes()
    for t in range(5):
        idx = touch(rng, mins, regs)
        ship.note_state(mins, regs, 1, watermark=t, dirty_rows=idx)
        time.sleep(0.002)
    store.close()
    re = DurableDimensionStore(str(tmp_path))
    rv = re.reach_sketches()
    assert np.array_equal(rv["mins"], mins)
    assert np.array_equal(rv["registers"], regs)
    assert rv["watermark"] == 4


def test_replica_poll_once_over_delta_log(tmp_path):
    """Replica-level integration: ReachReplica's tailer folds deltas
    and serves the folded planes (poll_once test hook, no threads)."""
    from streambench_tpu_torch.reach.replica import ReachReplica

    store = DurableDimensionStore(str(tmp_path))
    ship = DeltaShipper(store, NAMES, interval_ms=1, base_every=100)
    rng = np.random.default_rng(29)
    mins, regs = fresh_planes()
    for t in range(4):
        idx = touch(rng, mins, regs)
        ship.note_state(mins, regs, 1, watermark=70_000 + t,
                        dirty_rows=idx)
        time.sleep(0.002)
    rep = ReachReplica(ship_path(tmp_path), cache_capacity=0,
                       device="cpu")
    try:
        assert rep.poll_once()
        assert rep.server is not None and rep.server.epoch == 1
        s = rep.summary()
        assert s["tailer"]["deltas_folded"] == 3
        srv_mins, srv_regs = rep.server._state[0], rep.server._state[1]
        assert np.array_equal(srv_mins.numpy().astype(np.uint32), mins)
        assert np.array_equal(srv_regs.numpy(), regs)
    finally:
        rep.close()
