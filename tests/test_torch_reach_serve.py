"""Reach serving in the port (``streambench_tpu_torch/reach/serve.py``)
under load and under chaos, on the CPU; the reference's
``tests/test_reach_serve.py`` as cases of the port.

Shed-oldest admission, bad requests answered without queueing, the
stragglers of a close without state shed, epoch tagging across an engine
restore, the ``jax.reach.slo.p99.ms`` objective (against the JAX
package's ``SloTracker`` under one injected clock), and the acceptance
sweep: a pub/sub query storm concurrent with a supervised reach run whose
fault plan injects a sink outage and crashes, with a replica tailing the
ship log across the crashes.  Every query sheds or answers, and no
answer after the resume carries a stale epoch.

New here: the aliasing case.  The port's fold updates the planes in
place, so the engine pushes the server copies; an answer after more rows
were folded, but before the next push, is the pushed planes' answer.
"""

import random
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.obs import MetricsRegistry as JaxRegistry
from streambench_tpu.obs.slo import SloTracker as JaxSlo
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.engine.sketches import ReachSketchEngine
from streambench_tpu_torch.ops import minhash
from streambench_tpu_torch.reach import query as rq
from streambench_tpu_torch.reach.serve import (
    LATENCY_HIST,
    ReachQueryServer,
    freshness_hops,
)
from streambench_tpu_torch.utils.ids import make_ids


def tiny_state(C=4, k=16, R=16, seed=0):
    rng = np.random.default_rng(seed)
    st = minhash.init_state(C, k, R)
    B = 64
    return minhash.step(
        st, torch.arange(C, dtype=torch.int32),
        torch.from_numpy(rng.integers(0, C, B).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 1 << 20, B).astype(np.int32)),
        torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32),
        torch.ones(B, dtype=torch.bool))


def wait_for(got, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(got) >= n, (len(got), n)


def view_line(i, ad, user=None):
    return ('{"user_id": "%s", "page_id": "p", "ad_id": "%s", '
            '"ad_type": "banner", "event_type": "view", '
            '"event_time": "%d", "ip_address": "1.2.3.4"}'
            % (user or f"u{i}", ad, 1_000_000 + i * 10)).encode()


def small_engine(C=5, **kw):
    rng = random.Random(3)
    campaigns = make_ids(C, rng)
    ads = make_ids(2 * C, rng)
    mapping = {a: campaigns[i // 2] for i, a in enumerate(ads)}
    cfg = default_config(jax_num_campaigns=C, jax_batch_size=128)
    eng = ReachSketchEngine(cfg, mapping, campaigns=campaigns, k=16,
                            registers=16, device="cpu", **kw)
    return eng, campaigns, ads, mapping, cfg


# ----------------------------------------------------------- admission
def test_shed_oldest_beyond_depth_and_counters():
    st = tiny_state()
    srv = ReachQueryServer(list("abcd"), depth=5, batch=4, hold=True)
    srv.update_state(st.mins, st.registers, epoch=1)
    got = []
    try:
        for i in range(12):
            srv.submit(["a"], "union", lambda d: got.append(d),
                       query_id=i)
        # held: 12 in, depth 5 -> the 7 oldest shed already
        assert srv.shed == 7 and srv.pending() == 5
        assert sorted(d["id"] for d in got if d.get("shed")) == list(
            range(7))
        srv.resume()
        wait_for(got, 12)
        answered = [d for d in got if "estimate" in d]
        assert len(answered) == 5 and srv.served == 5
        assert {d["id"] for d in answered} == set(range(7, 12))
        # a drain of 5 at batch 4: exactly ceil(5/4) = 2 dispatches
        assert srv.dispatches == 2
        s = srv.summary()
        assert s["shed"] == 7 and s["served"] == 5 and s["p99_ms"] >= 0
    finally:
        srv.close()


def test_bad_requests_answer_without_queueing():
    srv = ReachQueryServer(["a"], depth=4, batch=2)
    got = []
    try:
        assert not srv.submit([], "union", lambda d: got.append(d))
        assert not srv.submit(["a"], "p99", lambda d: got.append(d))
        assert not srv.submit(["zzz"], "union", lambda d: got.append(d))
        assert srv.rejected == 3 and srv.pending() == 0
        assert all("error" in d for d in got)
    finally:
        srv.close()


def test_close_without_state_sheds_stragglers():
    srv = ReachQueryServer(["a"], depth=8, batch=4)   # no state pushed
    got = []
    srv.submit(["a"], "union", lambda d: got.append(d), query_id="s")
    srv.close()
    assert got and got[0].get("shed") is True


def test_answers_equal_the_jax_evaluation_of_the_pushed_planes():
    st = tiny_state(seed=5)
    srv = ReachQueryServer(list("abcd"), depth=16, batch=8)
    srv.update_state(st.mins, st.registers, epoch=3)
    sets = [["a"], ["a", "b"], ["b", "c", "d"], ["d"]]
    got = []
    try:
        for i, s in enumerate(sets):
            srv.submit(s, "overlap" if i % 2 else "union",
                       lambda d: got.append(d), query_id=i)
        wait_for(got, 4)
    finally:
        srv.close()
    from streambench_tpu.reach import query as jax_rq

    mask = np.zeros((4, 4), bool)
    for i, s in enumerate(sets):
        mask[i, ["abcd".index(c) for c in s]] = True
    est = np.asarray(jax_rq.batch_query(
        jnp.asarray(minhash.mins_numpy(st.mins)),
        jnp.asarray(st.registers.numpy()), jnp.asarray(mask),
        jnp.asarray([False, True, False, True]))[0])
    for d in got:
        assert d["epoch"] == d["plane_epoch"] == 3
        assert d["estimate"] == pytest.approx(
            round(float(est[d["id"]]), 2), abs=0.011)


def test_freshness_hops_partition_the_staleness():
    hops = freshness_hops({"folded_ms": 100, "submit_ms": 150,
                           "shipped_ms": 140, "loaded_ms": 400},
                          reply_ms=1000)
    assert hops == {"fold_lag": 50.0, "ship_wait": 0.0, "tail_lag": 250.0,
                    "serve": 600.0, "total": 900.0}


# ------------------------------------------------------------- aliasing
def test_answer_reads_the_pushed_planes_not_later_folds():
    """Push, fold more rows into the engine, then query before the next
    push: the answer is the pushed planes' answer.  A server holding
    references to the engine's planes (updated in place) would answer
    from the later fold."""
    eng, campaigns, ads, _, _ = small_engine()
    srv = ReachQueryServer(list(eng.encoder.campaigns), depth=16, batch=4,
                           hold=True)
    got = []
    try:
        eng.attach_reach(srv)
        eng.process_chunk([view_line(i, ads[0]) for i in range(20)])
        eng.flush()                                  # the push
        pushed = planes_answer(eng, campaigns[0])
        # more devices for the same campaign, folded after the push
        eng.process_chunk([view_line(100 + i, ads[0]) for i in range(300)])
        later = planes_answer(eng, campaigns[0])
        assert later != pushed
        srv.submit([campaigns[0]], "union", lambda d: got.append(d),
                   query_id="q")
        srv.resume()
        wait_for(got, 1)
        assert got[0]["estimate"] == pushed
        # the next push serves the new planes
        eng.flush()
        srv.submit([campaigns[0]], "union", lambda d: got.append(d),
                   query_id="q2")
        wait_for(got, 2)
        assert got[1]["estimate"] == later
    finally:
        srv.close()


def planes_answer(eng, campaign):
    mask = np.zeros((1, eng.encoder.num_campaigns), bool)
    mask[0, list(eng.encoder.campaigns).index(campaign)] = True
    est = rq.batch_query(eng.state.mins, eng.state.registers, mask,
                         np.zeros(1, bool))[0]
    return round(float(est[0]), 2)


# ------------------------------------------------------------- epochs
def test_engine_restore_bumps_epoch_and_pushes():
    eng, campaigns, ads, mapping, cfg = small_engine()
    srv = ReachQueryServer(list(eng.encoder.campaigns), depth=16, batch=4)
    try:
        eng.attach_reach(srv)
        assert srv.epoch == 0
        eng.process_chunk([view_line(i, ads[i % 10]) for i in range(400)])
        eng.flush()
        snap = eng.snapshot(offset=1)
        before = minhash.mins_numpy(eng.state.mins)
        eng.restore(snap)             # resume on the SAME engine
        assert eng.reach_epoch == 1 and srv.epoch == 1
        np.testing.assert_array_equal(minhash.mins_numpy(eng.state.mins),
                                      before)
        # a fresh engine restoring the same lineage moves PAST the
        # snapshot's recorded epoch (strictly increasing)
        eng2 = ReachSketchEngine(cfg, mapping, campaigns=campaigns, k=16,
                                 registers=16, device="cpu")
        eng2.restore(eng.snapshot(offset=2))     # carries reach_epoch=1
        assert eng2.reach_epoch == 2
        got = []
        srv.submit([campaigns[0]], "union", lambda d: got.append(d))
        wait_for(got, 1)
        assert got[0]["epoch"] == 1
    finally:
        srv.close()


# ------------------------------------------------------- SLO objective
def test_reach_slo_objective_burn_and_verdict_match_jax():
    from streambench_tpu_torch.obs import MetricsRegistry
    from streambench_tpu_torch.obs.slo import SloTracker

    clock = {"t": 0.0}
    sides = []
    for reg_cls, slo_cls in ((MetricsRegistry, SloTracker),
                             (JaxRegistry, JaxSlo)):
        reg = reg_cls()
        slo = slo_cls(reg, reach_p99_ms=100, budget=0.1, fast_s=5,
                      slow_s=20, clock=lambda: clock["t"])
        sides.append((slo, reg.histogram(LATENCY_HIST), []))
    for slo, _, _ in sides:
        assert slo.active
    for i in range(24):
        clock["t"] += 1
        for slo, hist, recs in sides:
            hist.observe(10 if i < 20 else 10_000)
            rec: dict = {}
            slo.collect(rec, 1.0)
            recs.append(rec["slo"])
    (port, _, precs), (ref, _, jrecs) = sides
    assert precs == jrecs
    burns = precs[-1]["burn"]["reach"]
    assert burns["fast"] == pytest.approx(8.0, rel=0.01)
    assert burns["slow"] == pytest.approx(2.0, rel=0.01)
    assert precs[-1]["in_breach"] and port.breaches == 1
    assert precs[-1]["total_reach"] == 24
    v = port.verdict()
    assert v == ref.verdict()
    assert v["objectives"]["reach_p99_ms"] == 100
    assert v["total_reach"] == 24 and v["bad_reach"] == 4
    assert v["pass"] is False


# ----------------------------------------------------- chaos acceptance
def test_query_storm_under_sink_outage_and_crashes(tmp_path):
    """A pub/sub query storm concurrent with a supervised reach run whose
    fault plan injects a sink outage and two crashes.  Every query sheds
    or answers (none lost, no crash reaches a client); once the run has
    resumed and completed, fresh answers carry the LIVE epoch; a replica
    tailing the ship log across the crashes answers with a published
    epoch and the planes' exact result."""
    from streambench_tpu_torch.chaos import (
        FaultInjector,
        FaultPlan,
        Supervisor,
    )
    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.dimensions.pubsub import (
        PubSubClient,
        PubSubServer,
    )
    from streambench_tpu_torch.dimensions.store import DurableDimensionStore
    from streambench_tpu_torch.engine.runner import StreamRunner
    from streambench_tpu_torch.io.fakeredis import FakeRedisStore
    from streambench_tpu_torch.io.journal import FileBroker
    from streambench_tpu_torch.io.redis_schema import as_redis
    from streambench_tpu_torch.reach.replica import (
        ReachReplica,
        SnapshotShipper,
    )

    # a flush every ~1 ms, so checkpoints land between batches and the
    # crashes find a snapshot to resume from (the epoch bump under test)
    cfg = default_config(jax_batch_size=256, jax_scan_batches=2,
                         jax_flush_interval_ms=1,
                         jax_sink_retry_base_ms=1,
                         jax_sink_retry_cap_ms=4)
    r = as_redis(FakeRedisStore())
    broker = FileBroker(str(tmp_path / "broker"))
    gen.do_setup(r, cfg, broker=broker, events_num=6_000,
                 rng=random.Random(7), workdir=str(tmp_path))
    mapping = gen.load_ad_mapping_file(
        str(tmp_path / gen.AD_TO_CAMPAIGN_FILE))
    campaigns = gen.load_ids(str(tmp_path))[0]

    plan = FaultPlan.generate(77, sink_rate=0.3, sink_ops=8,
                              sink_outage=(0, 4), crashes=0)
    plan = FaultPlan(seed=plan.seed, sink_faults=plan.sink_faults,
                     journal_faults=plan.journal_faults,
                     crashes=(("batch", 3), ("batch", 2)))
    inj = FaultInjector(plan)
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    srv = ReachQueryServer(campaigns, depth=8, batch=4)
    ps = PubSubServer(port=0).start()
    ps.register_query("reach", srv.handle)
    ship_store = DurableDimensionStore(str(tmp_path / "ship"))
    engines = []

    def make_runner():
        eng = ReachSketchEngine(cfg, mapping, campaigns=campaigns,
                                redis=inj.wrap_redis(r), k=16,
                                registers=16, device="cpu")
        eng.attach_reach(srv)
        eng.attach_shipper(SnapshotShipper(ship_store, campaigns,
                                           interval_ms=1))
        engines.append(eng)
        reader = inj.wrap_reader(broker.reader(cfg.kafka_topic))
        return StreamRunner(eng, reader, checkpointer=ckpt,
                            crash_points=inj.scheduler)

    host, port = ps.address
    done = threading.Event()
    storm: dict = {"sent": 0, "answers": [], "errors": []}

    def client():
        try:
            c = PubSubClient(host, port, timeout_s=30)
            while not done.is_set():
                sel = [campaigns[storm["sent"] % len(campaigns)]]
                c.request({"type": "reach", "campaigns": sel,
                           "op": "union", "id": storm["sent"]})
                storm["sent"] += 1
                storm["answers"].append(c.recv())
                time.sleep(0.005)
            c.close()
        except Exception as e:   # a crash must never reach a client
            storm["errors"].append(repr(e))

    t = threading.Thread(target=client)
    t.start()
    try:
        sup = Supervisor(make_runner, backoff_base_ms=1,
                         backoff_cap_ms=4, seed=1)
        st = sup.run(catchup=True)
        assert st.completed, st.errors
        assert st.crashes >= 2
        live = engines[-1]
        assert live.reach_epoch >= 1       # resumed lineages bumped
        assert live.events_processed == 6_000
        # the sink outage lands on the close-time reach-hash write (the
        # only sink op this engine issues); serving must survive it
        try:
            live.close()
        except Exception:
            pass
        assert inj.counters.get("chaos_sink_faults") > 0
        done.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert not storm["errors"], storm["errors"]
        c = PubSubClient(host, port, timeout_s=30)
        final = []
        for i in range(10):
            c.request({"type": "reach", "campaigns": campaigns[:3],
                       "op": "overlap", "id": f"final{i}"})
            final.append(c.recv()["data"])
        c.close()
        for d in final:
            assert d.get("shed") or d["epoch"] == live.reach_epoch, d
        assert any("estimate" in d for d in final)
        # the storm's ledger: every query shed or answered, none lost
        data = [a["data"] for a in storm["answers"]]
        assert len(data) == storm["sent"]
        assert all(("estimate" in d) or d.get("shed") for d in data)
        published = {e.reach_epoch for e in engines} | {0}
        assert {d["epoch"] for d in data if "epoch" in d} <= published
        # a replica across the chaos: it tails the records every crashed
        # and resumed lineage shipped, and answers exactly
        rep = ReachReplica(ship_store.path, poll_ms=20_000, device="cpu")
        rep.pubsub.start()
        try:
            assert rep.poll_once(), "no shipped record survived chaos"
            c = PubSubClient(*rep.address, timeout_s=30)
            c.request({"type": "reach", "campaigns": campaigns[:2],
                       "op": "union", "id": "rep"})
            d = c.recv()["data"]
            c.close()
            assert "estimate" in d, d
            assert d["plane_epoch"] in published and "staleness_ms" in d
            rec = ship_store.reach_sketches()
            m = np.zeros((1, len(campaigns)), bool)
            m[0, :2] = True
            want = rq.batch_query(minhash.mins_tensor(rec["mins"]),
                                  torch.from_numpy(rec["registers"].copy()),
                                  m, np.zeros(1, bool))[0]
            assert d["estimate"] == round(float(want[0]), 2)
        finally:
            rep.close()
            ship_store.close()
    finally:
        done.set()
        t.join(timeout=10)
        srv.close()
        ps.close()


def test_wait_intervals_while_the_worker_appends():
    """The multi-tenant host reads the wait ring (``drain_waits``) while
    the server's worker appends to it: a reader that walked the deque in
    Python met "deque mutated during iteration" on the card.  Twelve
    submitters and a reader, a 1 us switch interval, a full ring."""
    import sys

    st = tiny_state(seed=9)
    srv = ReachQueryServer(list("abcd"), depth=64, batch=1)
    srv.update_state(st.mins, st.registers, epoch=1)
    srv._wait_ring.extend((i, i + 1) for i in range(8192))
    stop = threading.Event()
    errors = []

    def submit(seed):
        rng = random.Random(seed)
        while not stop.is_set():
            srv.submit(rng.sample("abcd", 2), "union", lambda d: None)
            time.sleep(0)

    def read():
        try:
            while not stop.is_set():
                assert len(srv.wait_intervals()) == 8192
        except Exception as e:          # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=submit, args=(i,), daemon=True)
               for i in range(12)]
    threads.append(threading.Thread(target=read, daemon=True))
    try:
        for t in threads:
            t.start()
        time.sleep(2.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(old)
        srv.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert srv.served > 0
