"""The port's batched reach query (``streambench_tpu_torch/reach/query.py``)
against the JAX package's ``reach/query.py``, and the serving surfaces
it rides, on the CPU.

``batch_query`` on the same planes and masks: ``agree`` (the integer
collision count) bit-identical to JAX's and to the numpy oracle; the
floats within rtol 1e-6 (``hll.estimate`` may differ in the last place).
Also the reference's own cases: the estimates inside their error bounds
against exact set arithmetic, padding and empty rows evaluating to 0,
``query_chunks``' dispatch count (``ceil(Q/batch)``), a one-campaign
overlap as the identity, disjoint campaigns overlapping 0, the pub/sub
``reach`` verb end to end, reserved verbs refused, and the durable
store's sketch record round trip (read back by both packages' stores).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.dimensions.store import (
    DurableDimensionStore as JaxStore,
)
from streambench_tpu.reach import query as jax_rq
from streambench_tpu_torch.ops import minhash
from streambench_tpu_torch.reach import oracle as ro
from streambench_tpu_torch.reach import query as rq

C, K, R = 9, 128, 64
NAMES = [f"camp{i}" for i in range(C)]


@pytest.fixture(scope="module")
def world():
    """Per-campaign device sets with real overlap (a shared pool and a
    tail per campaign) and their sketch planes, as numpy."""
    rng = np.random.default_rng(42)
    shared = set(int(x) for x in rng.integers(0, 10**6, 300))
    sets = {}
    for i, name in enumerate(NAMES):
        own = set(int(x) for x in rng.integers(10**7 * (i + 1),
                                               10**7 * (i + 1) + 10**6,
                                               200 + 37 * i))
        take = set(x for x in shared if rng.random() < 0.5)
        sets[name] = own | take
    mins, regs = ro.expected_state(sets, NAMES, K, R)
    return sets, mins, regs


def tensors(mins, regs):
    return minhash.mins_tensor(mins), torch.from_numpy(regs.copy())


def make_queries(rng, n, c=C):
    masks = np.zeros((n, c), bool)
    overlap = np.zeros(n, bool)
    for i in range(n):
        sel = rng.choice(c, size=rng.integers(1, min(5, c + 1)),
                         replace=False)
        masks[i, sel] = True
        overlap[i] = bool(rng.integers(0, 2))
    return masks, overlap


@pytest.mark.parametrize("seed,q", [(1, 64), (2, 17), (3, 256)])
def test_batch_query_matches_jax(world, seed, q):
    _, mins, regs = world
    rng = np.random.default_rng(seed)
    masks, overlap = make_queries(rng, q)
    masks[0] = False                       # one padding row
    got = [x.numpy() for x in rq.batch_query(*tensors(mins, regs), masks,
                                             overlap)]
    want = [np.asarray(x) for x in jax_rq.batch_query(
        jnp.asarray(mins), jnp.asarray(regs), jnp.asarray(masks),
        jnp.asarray(overlap))]
    assert got[3].dtype == np.int32
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_agree_counts_bit_exact_vs_numpy_oracle(world):
    _, mins, regs = world
    masks, overlap = make_queries(np.random.default_rng(1), 100)
    counter = rq.DispatchCounter()
    est, union, jacc, agree = rq.query_chunks(
        *tensors(mins, regs), masks, overlap, batch=32, counter=counter)
    np.testing.assert_array_equal(agree, ro.query_oracle_np(mins, regs,
                                                            masks))
    assert counter.dispatches == int(np.ceil(100 / 32))
    np.testing.assert_allclose(jacc, agree / K, rtol=1e-6)
    jest, junion, jjacc, jagree = jax_rq.query_chunks(
        jnp.asarray(mins), jnp.asarray(regs), masks, overlap, batch=32)
    np.testing.assert_array_equal(agree, jagree)
    np.testing.assert_allclose(est, jest, rtol=1e-6)


@pytest.mark.parametrize("q,batch,dispatches", [(0, 8, 0), (1, 8, 1),
                                                (8, 8, 1), (9, 8, 2),
                                                (512, 256, 2)])
def test_query_chunks_dispatches_ceil_q_over_batch(world, q, batch,
                                                   dispatches):
    _, mins, regs = world
    masks, overlap = make_queries(np.random.default_rng(q), q)
    counter = rq.DispatchCounter()
    out = rq.query_chunks(*tensors(mins, regs), masks, overlap,
                          batch=batch, counter=counter)
    assert counter.dispatches == dispatches
    assert [len(x) for x in out] == [q] * 4
    assert out[3].dtype == np.int32 and out[0].dtype == np.float32


def test_estimates_inside_error_bounds(world):
    """Union within 2 standard errors of the truth; overlap (relative to
    the union) within its conservative bound."""
    sets, mins, regs = world
    masks, overlap = make_queries(np.random.default_rng(2), 200)
    est, union, _, _ = rq.query_chunks(*tensors(mins, regs), masks,
                                       overlap)
    u_err, o_err = [], []
    for i in range(200):
        names = [NAMES[j] for j in np.flatnonzero(masks[i])]
        op = "overlap" if overlap[i] else "union"
        truth, true_union = ro.exact_counts(sets, names, op)
        if overlap[i]:
            o_err.append(abs(est[i] - truth) / max(true_union, 1))
        else:
            u_err.append(abs(est[i] - truth) / max(truth, 1))
    assert np.mean(u_err) <= 2 * rq.union_bound(R)
    assert np.mean(o_err) <= rq.overlap_bound(K, R)


def test_empty_selection_and_padding_rows_evaluate_to_zero(world):
    _, mins, regs = world
    masks = np.zeros((4, C), bool)
    masks[1, 3] = True
    est, union, jacc, agree = rq.query_chunks(
        *tensors(mins, regs), masks, np.array([False, False, True, True]))
    for i in (0, 2, 3):
        assert est[i] == 0 and union[i] == 0 and agree[i] == 0
    assert est[1] > 0
    # a campaign never seen forces disagreement in every slot
    empty = minhash.init_state(2, K, R)
    m2 = minhash.mins_numpy(empty.mins)
    m2[0] = mins[0]
    est, _, _, agree = rq.query_chunks(
        minhash.mins_tensor(m2), empty.registers, np.ones((1, 2), bool),
        np.ones(1, bool))
    assert agree[0] == 0 and est[0] == 0


def test_single_campaign_overlap_is_identity(world):
    _, mins, regs = world
    masks = np.eye(C, dtype=bool)
    est, union, jacc, agree = rq.query_chunks(
        *tensors(mins, regs), masks, np.ones(C, bool))
    np.testing.assert_array_equal(agree, np.full(C, K))
    np.testing.assert_allclose(est, union, rtol=1e-6)


def test_disjoint_campaigns_overlap_zero():
    sets = {"a": set(range(1000)), "b": set(range(5000, 6000))}
    mins, regs = ro.expected_state(sets, ["a", "b"], K, R)
    est, union, jacc, agree = rq.query_chunks(
        *tensors(mins, regs), np.ones((1, 2), bool), np.ones(1, bool))
    assert agree[0] == 0 and est[0] == 0.0 and union[0] > 0


def test_error_bounds_are_the_references():
    for k, r in ((256, 1024), (64, 16), (128, 64)):
        assert rq.union_bound(r) == jax_rq.union_bound(r)
        assert rq.overlap_bound(k, r) == jax_rq.overlap_bound(k, r)
    assert rq.DEFAULT_BATCH == jax_rq.DEFAULT_BATCH


# -------------------------------------------------- pub/sub query verb
def test_pubsub_reach_verb_round_trip(world):
    from streambench_tpu_torch.dimensions.pubsub import (
        PubSubClient,
        PubSubServer,
    )
    from streambench_tpu_torch.reach.serve import ReachQueryServer

    _, mins, regs = world
    srv = ReachQueryServer(NAMES, depth=64, batch=16)
    srv.update_state(*tensors(mins, regs), epoch=7)
    ps = PubSubServer(port=0).start()
    ps.register_query("reach", srv.handle)
    host, port = ps.address
    try:
        c = PubSubClient(host, port)
        c.request({"type": "reach", "campaigns": NAMES[:2],
                   "op": "union", "id": "q1"})
        c.request({"type": "reach", "campaigns": NAMES[:3],
                   "op": "overlap", "id": "q2"})
        got = {m["data"]["id"]: m["data"] for m in (c.recv(), c.recv())}
        assert got["q1"]["epoch"] == 7 and got["q1"]["estimate"] > 0
        assert got["q2"]["op"] == "overlap"
        assert 0.0 < got["q2"]["bound"] < 1.0
        # the same answers as JAX's evaluation of the same planes
        m = np.zeros((2, C), bool)
        m[0, :2] = True
        m[1, :3] = True
        want = np.asarray(jax_rq.batch_query(
            jnp.asarray(mins), jnp.asarray(regs), jnp.asarray(m),
            jnp.asarray([False, True]))[0])
        assert got["q1"]["estimate"] == pytest.approx(
            round(float(want[0]), 2), abs=0.011)
        assert got["q2"]["estimate"] == pytest.approx(
            round(float(want[1]), 2), abs=0.011)
        # malformed verbs answer, never hang or kill the connection
        c.request({"type": "reach", "campaigns": ["nope"],
                   "op": "union", "id": "q3"})
        assert c.recv()["data"]["error"] == "unknown_campaign"
        c.request({"type": "reach", "campaigns": NAMES[:1],
                   "op": "median", "id": "q4"})
        assert "error" in c.recv()["data"]
        c.close()
    finally:
        srv.close()
        ps.close()


def test_register_query_refuses_reserved_verbs():
    from streambench_tpu_torch.dimensions.pubsub import PubSubServer

    ps = PubSubServer(port=0).start()
    try:
        with pytest.raises(ValueError):
            ps.register_query("subscribe", lambda m, r: None)
    finally:
        ps.close()


# ------------------------------------------------- durable-store leg
def test_store_sketch_round_trip(tmp_path, world):
    """Sketches survive the port's durable store (put, reopen, replay,
    compact), and the JAX package's store reads the same log."""
    from streambench_tpu_torch.dimensions.store import DurableDimensionStore

    _, mins, regs = world
    with DurableDimensionStore(str(tmp_path)) as st:
        st.put_rows([("campA", 0, {"clicks:SUM": 3})])
        st.put_reach_sketches(mins, regs, NAMES, epoch=5)
    for store_cls in (DurableDimensionStore, JaxStore):
        with store_cls(str(tmp_path)) as st2:
            rec = st2.reach_sketches()
            assert rec is not None and rec["epoch"] == 5
            np.testing.assert_array_equal(rec["mins"], mins)
            np.testing.assert_array_equal(rec["registers"], regs)
            assert rec["campaigns"] == NAMES
            assert st2.get("campA", 0)["clicks:SUM"] == 3
    with DurableDimensionStore(str(tmp_path)) as st:
        st.compact()
    with DurableDimensionStore(str(tmp_path)) as st3:
        rec = st3.reach_sketches()   # compaction kept the latest sketch
        assert rec is not None and rec["epoch"] == 5
        masks = np.zeros((2, C), bool)
        masks[0, :3] = True
        masks[1, [0, 4]] = True
        agree = rq.query_chunks(minhash.mins_tensor(rec["mins"]),
                                torch.from_numpy(rec["registers"].copy()),
                                masks, np.zeros(2, bool))[3]
        np.testing.assert_array_equal(
            agree, ro.query_oracle_np(mins, regs, masks))
