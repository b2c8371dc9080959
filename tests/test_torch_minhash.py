"""The port's MinHash ∪ HLL reach sketches (``streambench_tpu_torch/ops/
minhash.py``) against the JAX package's ``ops/minhash.py``, on the CPU.

The same seeded numpy batches go through both folds; the port's planes,
read back as the reference's uint32 / int32 numpy arrays, must be
bit-identical to JAX's (``step``, ``scan_steps``, ``scan_steps_packed``,
a negative ad index wrapping as JAX's gather does, ``merge``), and to the
numpy set-arithmetic oracle.  The estimate is a float32 HLL estimate:
within rtol 1e-6 (a sum in another order may differ in the last place).
Also the reference's own cases: duplicates idempotent, the merge algebra
over random shard splits, estimates within 4 sigma of the truth, and the
oracle's numpy hash mirrors against the port's hashes (with the
reference's float32 rank rounding below p = 8, which the port keeps and
the float64 mirror does not have).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.ops import hll as jax_hll
from streambench_tpu.ops import minhash as jax_minhash
from streambench_tpu.ops import windowcount as jax_wc
from streambench_tpu_torch.ops import hll, minhash
from streambench_tpu_torch.ops import windowcount as wc
from streambench_tpu_torch.reach import oracle as ro

C, K, R = 7, 64, 64
JOIN = np.array([0, 0, 1, 1, 2, 3, 4, 5, 6, -1], np.int32)


def rand_batch(rng, B=256, ads=10, lo=0):
    """One adversarial micro-batch: duplicate users, invalid rows,
    non-view events, join misses, and (``lo < 0``) negative ad indices."""
    return dict(
        ad_idx=rng.integers(lo, ads, B).astype(np.int32),
        user_idx=rng.integers(-2**31, 2**31 - 1, B,
                              dtype=np.int64).astype(np.int32),
        event_type=rng.integers(0, 3, B).astype(np.int32),
        event_time=rng.integers(0, 10**6, B).astype(np.int32),
        valid=rng.random(B) > 0.15,
    )


COLS = ("ad_idx", "user_idx", "event_type", "event_time", "valid")


def fold_port(state, batches, join=JOIN):
    t = torch.from_numpy(join)
    for b in batches:
        state = minhash.step(state, t, *(torch.from_numpy(b[c])
                                         for c in COLS))
    return state


def fold_jax(state, batches, join=JOIN):
    t = jnp.asarray(join)
    for b in batches:
        state = jax_minhash.step(state, t, *(jnp.asarray(b[c])
                                             for c in COLS))
    return state


def planes(st):
    """A state's planes as the reference's numpy arrays."""
    if isinstance(st.mins, torch.Tensor):
        return minhash.mins_numpy(st.mins), st.registers.numpy()
    return np.asarray(st.mins), np.asarray(st.registers)


def assert_same(port, jax):
    pm, pr = planes(port)
    jm, jr = planes(jax)
    assert pm.dtype == np.uint32 and pr.dtype == np.int32
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(pr, jr)
    assert int(port.watermark) == int(jax.watermark)
    assert int(port.dropped) == int(jax.dropped) == 0


def oracle_sets(batches, join=JOIN):
    sets = {c: set() for c in range(C)}
    for b in batches:
        for a, u, e, v in zip(b["ad_idx"], b["user_idx"],
                              b["event_type"], b["valid"]):
            camp = join[a]           # numpy wraps a negative index too
            if v and e == 0 and camp >= 0:
                sets[camp].add(int(u))
    return sets


def expected(sets):
    names = [str(c) for c in range(C)]
    return ro.expected_state({str(c): sets[c] for c in range(C)},
                             names, K, R)


# ------------------------------------------------------------- hashes
def test_oracle_mirrors_match_the_ports_hashes():
    xs = np.array([0, 1, -1, 2**31 - 1, -2**31, 12345, -98765],
                  np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        hll.splitmix32(torch.from_numpy(xs)).numpy().astype(np.uint32),
        ro.splitmix32_np(xs))
    h = ro.splitmix32_np(np.arange(1000, dtype=np.int64).astype(np.int32))
    for p in (4, 6, 8):
        np.testing.assert_array_equal(
            hll._rank(torch.from_numpy(h.astype(np.int64)), p).numpy(),
            ro.rank_np(h, p))
    np.testing.assert_array_equal(
        minhash.salts(K).numpy().astype(np.uint32), ro.salts_np(K))
    np.testing.assert_array_equal(
        minhash.salts(K).numpy().astype(np.uint32),
        np.asarray(jax_minhash.salts(K)))


def test_rank_keeps_the_reference_float32_rounding_below_p8():
    """``w = 2^25 - 1`` at p = 7: the reference's float32 frexp reads bit
    length 26 (rank 0); the port reads it as the reference does, the
    numpy mirror (float64) reads 25."""
    p = 7
    h = np.array([((1 << 25) - 1) << p], np.uint32)
    port = hll._rank(torch.from_numpy(h.astype(np.int64)), p).numpy()
    ref = np.asarray(jax_hll._rank(jnp.asarray(h), p))
    np.testing.assert_array_equal(port, ref)
    assert int(port[0]) == 0
    assert int(ro.rank_np(h, p)[0]) == 1


# --------------------------------------------------------------- fold
@pytest.mark.parametrize("seed", [3, 8, 9])
def test_step_bit_identical_to_jax_and_the_set_oracle(seed):
    rng = np.random.default_rng(seed)
    batches = [rand_batch(rng) for _ in range(8)]
    port = fold_port(minhash.init_state(C, K, R), batches)
    assert_same(port, fold_jax(jax_minhash.init_state(C, K, R), batches))
    em, er = expected(oracle_sets(batches))
    np.testing.assert_array_equal(minhash.mins_numpy(port.mins), em)
    np.testing.assert_array_equal(port.registers.numpy(), er)


def test_negative_ad_index_wraps_like_jax():
    """JAX's gather reads ``join[-1]`` as the table's last row; the port
    goes through ``windowcount.gather_rows``.  The smallest case: the
    table ``[0, 1, -1]`` and one view at ``ad_idx = -1`` (a join miss),
    then ``-2`` (campaign 1)."""
    join = np.array([0, 1, -1], np.int32)
    rng = np.random.default_rng(1)
    for ad in (-1, -2, -3):
        b = rand_batch(rng, B=4)
        b["ad_idx"][:] = ad
        b["event_type"][:] = 0
        b["valid"][:] = True
        port = fold_port(minhash.init_state(2, K, R), [b], join)
        jax = fold_jax(jax_minhash.init_state(2, K, R), [b], join)
        assert_same(port, jax)
        touched = (minhash.mins_numpy(port.mins) != minhash.EMPTY).any(1)
        assert touched.tolist() == {-1: [False, False], -2: [False, True],
                                    -3: [True, False]}[ad]
    # a whole random stream with negative indices
    batches = [rand_batch(rng, lo=-10) for _ in range(4)]
    assert_same(fold_port(minhash.init_state(C, K, R), batches),
                fold_jax(jax_minhash.init_state(C, K, R), batches))


def test_duplicate_events_are_idempotent():
    """Folding the same batches twice changes nothing: running min and
    max absorb duplicates."""
    rng = np.random.default_rng(4)
    batches = [rand_batch(rng) for _ in range(4)]
    once = fold_port(minhash.init_state(C, K, R), batches)
    first = planes(once)
    first = (first[0].copy(), first[1].copy())
    twice = fold_port(once, batches)
    np.testing.assert_array_equal(planes(twice)[0], first[0])
    np.testing.assert_array_equal(planes(twice)[1], first[1])


@pytest.mark.parametrize("packed", [False, True], ids=["columns", "packed"])
def test_scans_bit_identical_to_jax_and_the_step_sequence(packed):
    rng = np.random.default_rng(5 + packed)
    batches = [rand_batch(rng, B=128) for _ in range(6)]
    seq = fold_port(minhash.init_state(C, K, R), batches)
    st = {c: np.stack([b[c] for b in batches]) for c in COLS}
    if packed:
        words = np.stack([wc.pack_columns(b["ad_idx"], b["event_type"],
                                          b["valid"]) for b in batches])
        np.testing.assert_array_equal(
            words, np.stack([np.asarray(jax_wc.pack_columns(
                b["ad_idx"], b["event_type"], b["valid"]))
                for b in batches]))
        port = minhash.scan_steps_packed(
            minhash.init_state(C, K, R), torch.from_numpy(JOIN),
            torch.from_numpy(words), torch.from_numpy(st["user_idx"]),
            torch.from_numpy(st["event_time"]))
        jax = jax_minhash.scan_steps_packed(
            jax_minhash.init_state(C, K, R), jnp.asarray(JOIN),
            jnp.asarray(words), jnp.asarray(st["user_idx"]),
            jnp.asarray(st["event_time"]))
    else:
        port = minhash.scan_steps(
            minhash.init_state(C, K, R), torch.from_numpy(JOIN),
            *(torch.from_numpy(st[c]) for c in COLS))
        jax = jax_minhash.scan_steps(
            jax_minhash.init_state(C, K, R), jnp.asarray(JOIN),
            *(jnp.asarray(st[c]) for c in COLS))
    assert_same(port, jax)
    assert_same(seq, jax)


def test_init_state_checks_its_geometry():
    st = minhash.init_state(3, 8, 16)
    assert st.mins.dtype == torch.int64 and st.registers.dtype == torch.int32
    assert (minhash.mins_numpy(st.mins) == np.uint32(minhash.EMPTY)).all()
    for args, word in (((3, 0, 16), "k must be positive"),
                       ((3, 8, 24), "power of two"),
                       ((3, 8, 8), "power of two"),
                       ((2**24, 256, 16), "int32 flat")):
        with pytest.raises(ValueError, match=word):
            minhash.init_state(*args)


def test_mins_round_trip_through_numpy_is_exact_and_copies():
    a = np.array([[0, 1, 2**31, 2**32 - 1]], np.uint32)
    t = minhash.mins_tensor(a)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(minhash.mins_numpy(t), a)
    t.fill_(7)
    assert a[0, 3] == 2**32 - 1             # never a view


# ------------------------------------------------------- merge algebra
def _states(rng, n, fold):
    init = (minhash.init_state if fold is fold_port
            else jax_minhash.init_state)
    return [fold(init(C, K, R), [rand_batch(rng) for _ in range(2)])
            for _ in range(n)]


def test_merge_commutative_associative_idempotent_and_equal_to_jax():
    a, b, c = _states(np.random.default_rng(7), 3, fold_port)
    ja, jb, jc = _states(np.random.default_rng(7), 3, fold_jax)
    m = minhash.merge
    jm = jax_minhash.merge
    assert_same(m(a, b), jm(ja, jb))
    assert_same(m(b, a), jm(ja, jb))
    assert_same(m(m(a, b), c), m(a, m(b, c)))
    assert_same(m(m(a, b), c), jm(jm(ja, jb), jc))
    assert_same(m(a, a), ja)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_shard_order_invariance_random_splits(seed):
    """Split one stream across S shards at random, fold each alone,
    merge in a random order: bit-identical to the one fold, and to
    JAX's."""
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    batches = [rand_batch(rng, B=128) for _ in range(10)]
    reference = fold_jax(jax_minhash.init_state(C, K, R), batches)
    S = pyrng.choice([2, 3, 4])
    shards = [[] for _ in range(S)]
    for b in batches:
        shards[pyrng.randrange(S)].append(b)
    partials = [fold_port(minhash.init_state(C, K, R), sh) for sh in shards]
    pyrng.shuffle(partials)
    merged = partials[0]
    for p in partials[1:]:
        merged = minhash.merge(merged, p)
    assert_same(merged, reference)


def test_merge_refuses_other_geometry():
    a = minhash.init_state(3, 8, 16)
    with pytest.raises(ValueError, match="signature mismatch"):
        minhash.merge(a, minhash.init_state(3, 16, 16))
    with pytest.raises(ValueError, match="register mismatch"):
        minhash.merge(a, minhash.init_state(3, 8, 32))


# ----------------------------------------------------------- estimates
def test_estimate_matches_jax_and_tracks_true_cardinality():
    """The estimate within rtol 1e-6 of JAX's on bit-identical registers,
    and (the reference's case) within 4 sigma of the true distinct
    counts at R = 64."""
    rng = np.random.default_rng(21)
    batches = [rand_batch(rng, B=1024, ads=9) for _ in range(12)]
    port = fold_port(minhash.init_state(C, K, R), batches)
    jax = fold_jax(jax_minhash.init_state(C, K, R), batches)
    assert_same(port, jax)
    est = minhash.estimate(port.registers).numpy()
    np.testing.assert_allclose(
        est, np.asarray(jax_minhash.estimate(jax.registers)), rtol=1e-6)
    sets = oracle_sets(batches)
    for c in range(C):
        true = len(sets[c])
        if true < 50:
            continue
        rel = abs(est[c] - true) / true
        assert rel < 4 * 1.04 / np.sqrt(R), (c, true, est[c], rel)
