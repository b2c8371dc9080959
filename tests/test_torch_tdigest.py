"""``streambench_tpu_torch.ops.tdigest`` against ``streambench_tpu.ops.tdigest``.

The same numpy inputs, made from a seed, go through the JAX function and
its port on the CPU.  Tolerances: weights are sums of ones and must be
exact (in total per key, and here cell by cell); means are float32
averages and agree within rtol 1e-5; quantiles agree within 3.2 %
relative (one histogram bin, 2^-5; they interpolate between means).
Bin and bucket indices are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.ops import tdigest as jtd
from streambench_tpu_torch.ops import tdigest as td

torch.set_num_threads(1)

QS = np.array([0.01, 0.25, 0.5, 0.9, 0.99, 1.0], np.float32)
MEAN_RTOL = 1e-5
QUANTILE_RTOL = 2.0 ** -5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _same_digest(jd, dd):
    jw, jm = np.asarray(jd.weights), np.asarray(jd.means)
    np.testing.assert_array_equal(dd.weights.numpy().sum(1), jw.sum(1))
    np.testing.assert_array_equal(dd.weights.numpy(), jw)
    np.testing.assert_allclose(dd.means.numpy(), jm, rtol=MEAN_RTOL,
                               atol=1e-6)


def _same_quantiles(jd, dd):
    want = np.asarray(jtd.quantile(jd, _j(QS)))
    got = td.quantile(dd, _t(QS)).numpy()
    np.testing.assert_allclose(got, want, rtol=QUANTILE_RTOL, atol=1e-6)
    return got, want


def _points(rng, B, N):
    """Keys below 0 and past N, latency-like values with negatives and
    values under 1.0 (bin 0), a mask."""
    key = rng.integers(-2, N + 2, B).astype(np.int32)
    value = np.concatenate([
        rng.exponential(800.0, B - 8) - 20.0,
        [-5.0, 0.0, 0.25, 0.999, 1.0, 1e6, 2.0**31, 3.5]]).astype(
            np.float32)
    return key, value, rng.random(B) < 0.85


def test_value_and_k1_buckets_match_jax():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.exponential(1e4, 10_000) - 100,
                        [0.0, 1.0, -1.0, 2.0**31, 3e38]]).astype(np.float32)
    np.testing.assert_array_equal(td._value_bucket(_t(v)).numpy(),
                                  np.asarray(jtd._value_bucket(_j(v))))
    q = np.concatenate([rng.random(10_000), [0.0, 0.5, 1.0, -0.1, 1.1]]
                       ).astype(np.float32)
    for K in (16, 64):
        np.testing.assert_array_equal(td._k1_bucket(_t(q), K).numpy(),
                                      np.asarray(jtd._k1_bucket(_j(q), K)))


def test_fold_hist_drops_out_of_range_keys_like_jax():
    rng = np.random.default_rng(1)
    N = 5
    jn, jw = jtd.hist_init(N)
    tn, tw = td.hist_init(N)
    counted = np.zeros(N, np.int64)
    for _ in range(4):
        key, value, mask = _points(rng, 700, N)
        w = mask.astype(np.float32)
        jn, jw = jtd.fold_hist(jn, jw, _j(key), _j(value), _j(w), N)
        tn, tw = td.fold_hist(tn, tw, _t(key), _t(value), _t(w), N)
        ok = mask & (key >= 0) & (key < N)
        counted += np.bincount(key[ok], minlength=N)
    assert tw.shape == (N, td.HIST_BINS)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=MEAN_RTOL)
    # every in-range masked point and nothing else was counted: a key
    # out of range is never clamped into a real row
    np.testing.assert_array_equal(tw.numpy().sum(1), counted)


@pytest.mark.parametrize("N,K", [(6, 16), (40, 64)])
def test_update_quantile_and_merge_match_jax(N, K):
    rng = np.random.default_rng(N)
    jd, dd = jtd.init_state(N, K), td.init_state(N, K)
    seen = np.zeros(N, np.int64)
    for _ in range(5):
        key, value, mask = _points(rng, 600, N)
        jd = jtd.update(jd, _j(key), _j(value), _j(mask))
        dd = td.update(dd, _t(key), _t(value), _t(mask))
        _same_digest(jd, dd)
        ok = mask & (key >= 0) & (key < N)
        seen += np.bincount(key[ok], minlength=N)
    # total weight per key is the points folded, exactly
    np.testing.assert_array_equal(dd.weights.numpy().sum(1), seen)
    got, _ = _same_quantiles(jd, dd)
    assert (np.diff(got, axis=1) >= 0).all()
    # merge with a second digest
    je, de = jtd.init_state(N, K), td.init_state(N, K)
    key, value, mask = _points(rng, 900, N)
    je = jtd.update(je, _j(key), _j(value), _j(mask))
    de = td.update(de, _t(key), _t(value), _t(mask))
    jm, dm = jtd.merge(jd, je), td.merge(dd, de)
    _same_digest(jm, dm)
    np.testing.assert_array_equal(
        dm.weights.numpy().sum(1),
        dd.weights.numpy().sum(1) + de.weights.numpy().sum(1))
    _same_quantiles(jm, dm)


def test_absorb_hist_matches_jax():
    rng = np.random.default_rng(9)
    N, K = 8, 64
    jd, dd = jtd.init_state(N, K), td.init_state(N, K)
    key, value, mask = _points(rng, 500, N)
    jd = jtd.update(jd, _j(key), _j(value), _j(mask))
    dd = td.update(dd, _t(key), _t(value), _t(mask))
    jn, jw = jtd.hist_init(N)
    tn, tw = td.hist_init(N)
    for _ in range(6):
        key, value, mask = _points(rng, 1_000, N)
        w = mask.astype(np.float32)
        jn, jw = jtd.fold_hist(jn, jw, _j(key), _j(value), _j(w), N)
        tn, tw = td.fold_hist(tn, tw, _t(key), _t(value), _t(w), N)
    ja, da = jtd.absorb_hist(jd, jn, jw), td.absorb_hist(dd, tn, tw)
    _same_digest(ja, da)
    _same_quantiles(ja, da)


def test_an_empty_key_reads_zero_and_tails_stop_at_the_last_centroid():
    N, K = 3, 16
    key = np.array([0, 0, 0, 2], np.int32)
    value = np.array([10.0, 20.0, 30.0, 7.0], np.float32)
    mask = np.ones(4, bool)
    jd = jtd.update(jtd.init_state(N, K), _j(key), _j(value), _j(mask))
    dd = td.update(td.init_state(N, K), _t(key), _t(value), _t(mask))
    got, want = _same_quantiles(jd, dd)
    np.testing.assert_array_equal(got, want)
    assert (got[1] == 0).all()                     # key 1: empty digest
    assert got[0, -1] == pytest.approx(30.0)       # q = 1: the last mean
    assert (got[2] == pytest.approx(7.0))
