"""The reach result cache in the port (``streambench_tpu_torch/reach/
cache.py``, a copy of the JAX package's), on the CPU; the reference's
``tests/test_reach_cache.py`` as cases of the port.

Canonical keys, LRU bounds, wholesale epoch invalidation (a stale entry
is never served after a bump), and the port's query server with the
cache: hit replies identical to the miss and instrumented, and the
post-bump answer computed from the new planes.  Each pure case also runs
the JAX package's cache through the same calls, which must agree call
for call; and with query attribution on, a cache hit leaves one served
lifecycle record.
"""

import time

import numpy as np
import pytest
import torch

from streambench_tpu.obs import MetricsRegistry as JaxRegistry
from streambench_tpu.reach.cache import ReachQueryCache as JaxCache
from streambench_tpu_torch.obs import MetricsRegistry
from streambench_tpu_torch.ops import minhash
from streambench_tpu_torch.reach.cache import (
    CACHEABLE_KEYS,
    HIT_LATENCY_HIST,
    ReachQueryCache,
)
from streambench_tpu_torch.reach.serve import ReachQueryServer

SIDES = {"port": (ReachQueryCache, MetricsRegistry),
         "jax": (JaxCache, JaxRegistry)}


def fold_state(users, C=4, k=16, R=16):
    st = minhash.init_state(C, k, R)
    B = len(users)
    return minhash.step(
        st, torch.arange(C, dtype=torch.int32),
        torch.zeros(B, dtype=torch.int32),
        torch.from_numpy(np.asarray(users, np.int32)),
        torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32),
        torch.ones(B, dtype=torch.bool))


# ------------------------------------------------------------ unit
@pytest.mark.parametrize("side", SIDES)
def test_canonical_key_and_counts(side):
    c = SIDES[side][0](capacity=8)
    c.note_epoch(1)
    assert c.get(1, [2, 0, 1], "union") is None          # miss
    c.put(1, [2, 0, 1], "union", {"estimate": 5.0})
    assert c.get(1, [0, 1, 2], "union") == {"estimate": 5.0}  # order-free
    assert c.get(1, [0, 1, 2], "overlap") is None        # kind in key
    assert c.get(2, [0, 1, 2], "union") is None          # epoch in key
    s = c.summary()
    assert s["hits"] == 1 and s["misses"] == 3
    assert s["hit_ratio"] == 0.25


@pytest.mark.parametrize("side", SIDES)
def test_lru_eviction_bounded(side):
    cache_cls, reg_cls = SIDES[side]
    reg = reg_cls()
    c = cache_cls(capacity=3, registry=reg)
    c.note_epoch(1)
    for i in range(5):
        c.put(1, [i], "union", {"estimate": float(i)})
    assert len(c) == 3 and c.evictions == 2
    assert c.get(1, [0], "union") is None       # oldest evicted
    assert c.get(1, [4], "union") is not None   # newest kept
    # touching an entry protects it from the next eviction
    c.get(1, [2], "union")
    c.put(1, [9], "union", {"estimate": 9.0})
    assert c.get(1, [2], "union") is not None
    assert c.get(1, [3], "union") is None
    assert reg.counter(
        "streambench_reach_cache_evictions_total").value == 3


@pytest.mark.parametrize("side", SIDES)
def test_epoch_bump_invalidates_wholesale(side):
    c = SIDES[side][0](capacity=8)
    c.note_epoch(1)
    c.put(1, [0], "union", {"estimate": 1.0})
    c.put(1, [1], "union", {"estimate": 2.0})
    assert len(c) == 2
    c.note_epoch(2)
    assert len(c) == 0 and c.invalidations == 1
    # a worker racing the bump cannot resurrect old-epoch results
    c.put(1, [0], "union", {"estimate": 1.0})
    assert len(c) == 0
    assert c.get(2, [0], "union") is None


def test_port_cache_agrees_with_jax_call_for_call():
    """A seeded stream of probes, fills and epoch bumps through both
    caches: every answer and the summaries agree."""
    rng = np.random.default_rng(5)
    port, jax = ReachQueryCache(capacity=6), JaxCache(capacity=6)
    epoch = 0
    for c in (port, jax):
        c.note_epoch(0)
    for step in range(400):
        idx = list(rng.choice(8, size=int(rng.integers(1, 4)),
                              replace=False))
        op = "overlap" if rng.random() < 0.5 else "union"
        roll = rng.random()
        if roll < 0.05:
            epoch += 1
            for c in (port, jax):
                c.note_epoch(epoch)
        elif roll < 0.5:
            for c in (port, jax):
                c.put(epoch, idx, op, {"estimate": float(step)})
        else:
            assert port.get(epoch, idx, op) == jax.get(epoch, idx, op)
    assert port.summary() == jax.summary()


# ------------------------------------------------------- serve layer
def drain(got, n, timeout=20.0):
    deadline = time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(got) >= n, (len(got), n)


def test_cached_reply_identical_and_instrumented():
    reg = MetricsRegistry()
    cache = ReachQueryCache(capacity=64, registry=reg)
    srv = ReachQueryServer(list("abcd"), depth=32, batch=8,
                           registry=reg, cache=cache)
    st = fold_state([11, 22, 33])
    srv.update_state(st.mins, st.registers, epoch=1)
    got = []
    try:
        srv.submit(["a", "b"], "union", lambda d: got.append(d),
                   query_id=1)
        drain(got, 1)
        srv.submit(["b", "a"], "union", lambda d: got.append(d),
                   query_id=2)   # the same canonical set: a hit
        drain(got, 2)
    finally:
        srv.close()
    miss, hit = got
    assert "cached" not in miss and hit["cached"] is True
    for key in CACHEABLE_KEYS:
        assert hit[key] == miss[key], key
    assert hit["id"] == 2
    assert srv.served == 2
    assert srv.dispatches == 1          # the hit never dispatched
    assert cache.summary()["hits"] == 1
    assert reg.counter("streambench_reach_cache_hits_total").value == 1
    assert reg.counter("streambench_reach_cache_misses_total").value == 1
    assert reg.histogram(HIT_LATENCY_HIST).summary().get("count") == 1


def test_stale_entry_never_served_after_epoch_bump():
    """After an epoch bump with different planes, the answer comes from
    the new planes, never the cached old-epoch result."""
    cache = ReachQueryCache(capacity=64)
    srv = ReachQueryServer(list("abcd"), depth=32, batch=8, cache=cache)
    st1 = fold_state([1, 2, 3])
    st2 = fold_state([1, 2, 3, 4, 5, 6, 7, 8])
    srv.update_state(st1.mins, st1.registers, epoch=1)
    got = []
    try:
        srv.submit(["a"], "union", lambda d: got.append(d), query_id=1)
        drain(got, 1)
        srv.update_state(st2.mins, st2.registers, epoch=2)
        srv.submit(["a"], "union", lambda d: got.append(d), query_id=2)
        drain(got, 2)
    finally:
        srv.close()
    old, new = got
    assert old["plane_epoch"] == 1 and new["plane_epoch"] == 2
    assert not new.get("cached")
    assert new["estimate"] != old["estimate"]   # different planes
    # the post-bump answer seeds the NEW epoch's cache
    assert cache.summary()["epoch"] == 2
    assert cache.summary()["entries"] == 1


def test_queryattr_reconciles_with_cache_hits():
    """Cache-hit replies leave exactly one served lifecycle record each,
    so the lifecycle's records equal the served counter with the cache
    in the path, and the hits carry the server block."""
    from streambench_tpu_torch.obs.queryattr import QueryLifecycle

    reg = MetricsRegistry()
    ql = QueryLifecycle(reg)
    cache = ReachQueryCache(capacity=64, registry=reg)
    srv = ReachQueryServer(list("abcd"), depth=32, batch=8, registry=reg,
                           cache=cache, queryattr=ql)
    st = fold_state([5, 6])
    srv.update_state(st.mins, st.registers, epoch=1)
    got = []
    try:
        for i in range(3):      # the first round fills the cache
            srv.submit([list("abc")[i]], "union", lambda d: got.append(d),
                       query_id=i, trace=f"t{i}")
        drain(got, 3)
        for i in range(3, 6):   # the second hits it
            srv.submit([list("abc")[i % 3]], "union",
                       lambda d: got.append(d), query_id=i, trace=f"t{i}")
        drain(got, 6)
    finally:
        srv.close()
    assert srv.served == 6
    assert ql.summary()["served_records"] == 6
    assert cache.summary()["hits"] >= 1
    hits = [d for d in got if d.get("cached")]
    assert hits and all("server" in d for d in hits)
