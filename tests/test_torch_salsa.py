"""``streambench_tpu_torch.ops.salsa`` against ``streambench_tpu.ops.salsa``
and against the closed-form numpy oracle.

The same numpy batches, made from a seed, fold through the JAX functions
and their port on the CPU; every plane (cell bytes, pair and quad
bitmaps), the total and every estimate must be bit-identical, no
tolerance.  The port's own numpy oracle (with its own copy of the uint32
splitmix32) must equal the reference's.  Covered: pair then quad
promotion, ``cell_bits=16``, shard-split and merge-order invariance,
saturation at ``CAP2``, the bit helpers, ``stats``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.ops import salsa as jsalsa
from streambench_tpu_torch.ops import salsa

torch.set_num_threads(1)

D, W = 4, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def rand_batch(rng, B=128, keyspace=48, wmax=120):
    return (rng.integers(0, keyspace, B).astype(np.int32),
            rng.integers(0, wmax, B).astype(np.int32),
            rng.random(B) > 0.2)


def fold_both(jst, tst, batches):
    for k, w, m in batches:
        jst = jsalsa.update(jst, _j(k), _j(w), _j(m))
        tst = salsa.update(tst, _t(k), _t(w), _t(m))
        assert_same(jst, tst)
    return jst, tst


def assert_same(jst, tst):
    for name in ("table", "m1", "m2", "total"):
        want = np.asarray(getattr(jst, name))
        got = getattr(tst, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def assert_oracle(tst, batches, cell_bits=8, depth=D, width=W):
    tot = salsa.oracle_totals_np(batches, depth, width)
    table, m1, m2 = salsa.oracle_encode_np(tot, cell_bits)
    np.testing.assert_array_equal(tst.table.numpy(), table)
    np.testing.assert_array_equal(tst.m1.numpy(), m1)
    np.testing.assert_array_equal(tst.m2.numpy(), m2)
    return tot


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("wmax", [120, 3000, 200_000])
def test_update_and_query_match_jax_and_the_oracle(seed, wmax):
    rng = np.random.default_rng(seed)
    batches = [rand_batch(rng, wmax=wmax) for _ in range(6)]
    jst, tst = fold_both(jsalsa.init_state(D, W), salsa.init_state(D, W),
                         batches)
    tot = assert_oracle(tst, batches)
    keys = np.arange(-3, 60, dtype=np.int32)
    want = np.asarray(jsalsa.query(jst, _j(keys)))
    got = salsa.query(tst, _t(keys))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  salsa.oracle_query_np(tot, keys))


def test_estimates_upper_bound_exact_counts():
    rng = np.random.default_rng(3)
    batches = [rand_batch(rng) for _ in range(8)]
    tst = salsa.init_state(D, W)
    for k, w, m in batches:
        tst = salsa.update(tst, _t(k), _t(w), _t(m))
    exact = np.zeros(48, np.int64)
    for k, w, m in batches:
        np.add.at(exact, k, np.where(m, w, 0))
    got = salsa.query(tst, _t(np.arange(48, dtype=np.int32))).numpy()
    assert (got >= exact).all()


def test_cell_bits_16_starts_pair_merged():
    rng = np.random.default_rng(4)
    batches = [rand_batch(rng) for _ in range(4)]
    jst, tst = fold_both(jsalsa.init_state(D, W, cell_bits=16),
                         salsa.init_state(D, W, cell_bits=16), batches)
    assert_oracle(tst, batches, cell_bits=16)
    assert salsa.stats(tst)["merged_pairs"] == D * W // 2
    assert salsa.stats(tst) == jsalsa.stats(jst)


def test_init_state_checks():
    with pytest.raises(ValueError, match="power of two"):
        salsa.init_state(4, 48)
    with pytest.raises(ValueError, match="power of two"):
        salsa.init_state(4, 16)
    with pytest.raises(ValueError, match="depth"):
        salsa.init_state(9, 64)
    with pytest.raises(ValueError, match="cell_bits"):
        salsa.init_state(4, 64, cell_bits=4)
    assert_same(jsalsa.init_state(4, 64, 16), salsa.init_state(4, 64, 16))


def test_overflow_promotes_pair_then_quad():
    """The promotion ladder of one key, as the reference pins it: a solo
    byte to 255, a 16-bit pair past it, a 32-bit quad past 65535; one
    update may go from solo to quad."""
    key, one = _t(np.zeros(1, np.int32)), _t(np.ones(1, bool))
    jkey, jone = _j(np.zeros(1, np.int32)), _j(np.ones(1, bool))
    jst, tst = jsalsa.init_state(D, W), salsa.init_state(D, W)
    ladder = [(200, 0, 0, 200), (100, D, 0, 300), (70_000, 2 * D, D, 70_300)]
    for w, pairs, quads, value in ladder:
        wt = np.array([w], np.int32)
        jst = jsalsa.update(jst, jkey, _j(wt), jone)
        tst = salsa.update(tst, key, _t(wt), one)
        assert_same(jst, tst)
        s = salsa.stats(tst)
        assert (s["merged_pairs"], s["merged_quads"]) == (pairs, quads)
        assert int(salsa.query(tst, key)[0]) == value
    st2 = salsa.update(salsa.init_state(D, W), key,
                       _t(np.array([100_000], np.int32)), one)
    assert salsa.stats(st2)["merged_quads"] == D
    assert int(salsa.query(st2, key)[0]) == 100_000


def test_quads_saturate_at_cap2_like_jax():
    """Past 2^31 - 1 a quad saturates (the decoded plane is int32, as the
    reference's); the state stays the reference's bit for bit."""
    key, one = np.zeros(1, np.int32), np.ones(1, bool)
    jst, tst = jsalsa.init_state(D, W), salsa.init_state(D, W)
    for w in (2**30, 2**30, 2**30 - 1, 5):
        wt = np.array([w], np.int32)
        jst = jsalsa.update(jst, _j(key), _j(wt), _j(one))
        tst = salsa.update(tst, _t(key), _t(wt), _t(one))
        assert_same(jst, tst)
    np.testing.assert_array_equal(
        salsa.query(tst, _t(key)).numpy(),
        np.asarray(jsalsa.query(jst, _j(key))))
    assert salsa.stats(tst)["merged_quads"] == D


def test_colliding_keys_merge_and_stay_upper_bounds():
    cols = salsa.oracle_cols_np(np.arange(4096, dtype=np.int32), D, W)
    sib = np.nonzero((cols[0] == cols[0][0]) & (np.arange(4096) != 0))[0]
    keys = np.array([0, int(sib[0])], np.int32)
    tst = salsa.update(salsa.init_state(D, W), _t(keys),
                       _t(np.array([200, 200], np.int32)),
                       _t(np.ones(2, bool)))
    assert (salsa.query(tst, _t(keys)).numpy() >= 200).all()
    assert salsa.stats(tst)["merged_pairs"] >= 1


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_merge_shard_order_invariance(seed):
    """A random shard split merged in a random order equals the single
    fold bit for bit, and the port's merge equals the reference's."""
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    batches = [rand_batch(rng, wmax=300) for _ in range(10)]
    reference = salsa.init_state(D, W)
    for k, w, m in batches:
        reference = salsa.update(reference, _t(k), _t(w), _t(m))
    S = pyrng.choice([2, 3, 4])
    shards = [[] for _ in range(S)]
    for b in batches:
        shards[pyrng.randrange(S)].append(b)
    partials = []
    for sh in shards:
        jp, tp = jsalsa.init_state(D, W), salsa.init_state(D, W)
        partials.append(fold_both(jp, tp, sh))
    pyrng.shuffle(partials)
    jm, tm = partials[0]
    for jp, tp in partials[1:]:
        jm, tm = jsalsa.merge(jm, jp), salsa.merge(tm, tp)
        assert_same(jm, tm)
    for name in ("table", "m1", "m2", "total"):
        assert torch.equal(getattr(tm, name), getattr(reference, name))


def test_merge_commutative_associative_and_checks_geometry():
    rng = np.random.default_rng(7)
    sts = []
    for _ in range(3):
        st = salsa.init_state(D, W)
        for k, w, m in (rand_batch(rng, wmax=200) for _ in range(2)):
            st = salsa.update(st, _t(k), _t(w), _t(m))
        sts.append(st)
    a, b, c = sts
    for x, y in ((salsa.merge(a, b), salsa.merge(b, a)),
                 (salsa.merge(salsa.merge(a, b), c),
                  salsa.merge(a, salsa.merge(b, c)))):
        assert all(torch.equal(p, q) for p, q in zip(x, y))
    with pytest.raises(ValueError, match="geometry mismatch"):
        salsa.merge(a, salsa.init_state(D, 2 * W))


def test_bit_helpers_match_jax():
    rng = np.random.default_rng(8)
    packed = rng.integers(0, 256, (3, 8)).astype(np.uint8)
    bits = salsa._expand_bits(_t(packed), 64)
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jsalsa._expand_bits(_j(packed), 64)))
    np.testing.assert_array_equal(salsa._pack_bits(bits).numpy(), packed)
    group = rng.integers(0, 64, (3, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        salsa._bit_at(_t(packed), _t(group)).numpy(),
        np.asarray(jsalsa._bit_at(_j(packed), _j(group))))


def test_decode_and_settle_match_jax():
    rng = np.random.default_rng(9)
    batches = [rand_batch(rng, wmax=5000) for _ in range(5)]
    jst, tst = fold_both(jsalsa.init_state(D, W), salsa.init_state(D, W),
                         batches)
    jv, jm1, jm2 = jsalsa._decode(jst)
    tv, tm1, tm2 = salsa._decode(tst)
    for want, got in ((jv, tv), (jm1, tm1), (jm2, tm2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bumped = np.asarray(jv) + rng.integers(0, 70_000, np.asarray(jv).shape
                                           ).astype(np.int32)
    for want, got in zip(jsalsa._settle(_j(bumped), jm1, jm2),
                         salsa._settle(_t(bumped), tm1, tm2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_heavy_hitters_and_stats_match_jax():
    rng = np.random.default_rng(10)
    batches = [rand_batch(rng, wmax=900) for _ in range(6)]
    jst, tst = fold_both(jsalsa.init_state(D, W), salsa.init_state(D, W),
                         batches)
    cand = np.arange(48, dtype=np.int32)
    jv, ji = jsalsa.heavy_hitters(jst, _j(cand), k=8)
    tv, ti = salsa.heavy_hitters(tst, _t(cand), k=8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert salsa.stats(tst) == jsalsa.stats(jst)
    assert salsa.stats(tst)["cells"] == D * W


def test_the_numpy_oracle_is_the_references():
    rng = np.random.default_rng(12)
    keys = rng.integers(-2**31, 2**31 - 1, 500).astype(np.int32)
    np.testing.assert_array_equal(salsa.oracle_cols_np(keys, 8, 1024),
                                  jsalsa.oracle_cols_np(keys, 8, 1024))
    batches = [rand_batch(rng, wmax=80_000) for _ in range(4)]
    tot = salsa.oracle_totals_np(batches, D, W)
    np.testing.assert_array_equal(tot, jsalsa.oracle_totals_np(batches, D, W))
    for bits in (8, 16):
        for a, b in zip(salsa.oracle_encode_np(tot, bits),
                        jsalsa.oracle_encode_np(tot, bits)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            salsa.oracle_query_np(tot, keys[:50], bits),
            jsalsa.oracle_query_np(tot, keys[:50], bits))
