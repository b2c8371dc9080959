"""``streambench_tpu_torch.ops.hll`` against ``streambench_tpu.ops.hll``.

The same numpy inputs, made from a seed, go through the JAX function and
its port on the CPU.  Tolerances: the hash, the ranks, the registers,
the window ids, the watermark and ``dropped`` are integers and must be
bit-identical; estimates are float32 sums and agree within rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.ops import hll as jhll
from streambench_tpu_torch.ops import hll
from streambench_tpu_torch.ops import windowcount as wc

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _same_state(jstate, tstate):
    for name in ("registers", "window_ids", "watermark", "dropped"):
        want = np.asarray(getattr(jstate, name))
        got = getattr(tstate, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _batch(rng, B, n_ads, t0):
    """A batch with negative and past-the-end ad indices, every event
    type, invalid rows, negative int32 user ids and late times."""
    return (rng.integers(-3, n_ads + 2, B).astype(np.int32),
            rng.integers(-2**31, 2**31, B).astype(np.int32),
            rng.integers(-1, 3, B).astype(np.int32),
            (t0 + rng.integers(-80_000, 25_000, B)).astype(np.int32),
            rng.random(B) < 0.8)


def _join(C, ads_per):
    # the encoder's layout: ads in order, a trailing -1 for unknown ads
    return np.concatenate([np.arange(C * ads_per) % C, [-1]]).astype(
        np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splitmix32_matches_jax_on_negative_ids(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, 50_000).astype(np.int32)
    x[:4] = [-1, 0, -2**31, 2**31 - 1]
    want = np.asarray(jhll.splitmix32(_j(x))).astype(np.int64)
    got = hll.splitmix32(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() and (got < 2**32).all()


@pytest.mark.parametrize("p", [4, 7, 8, 10, 14])
def test_rank_matches_jax_at_the_float32_boundary(p):
    rng = np.random.default_rng(p)
    h = rng.integers(0, 2**32, 20_000, dtype=np.uint64)
    # hand-made hashes: w = 2^k - 1 and 2^k for every k, w = 0, all ones
    k = np.arange(32 - p, dtype=np.uint64)
    w = np.concatenate([np.zeros(1, np.uint64), (np.uint64(1) << k) - 1,
                        np.uint64(1) << k])
    h = np.concatenate([h, (w << np.uint64(p)) & 0xFFFFFFFF,
                        [0xFFFFFFFF]]).astype(np.uint32)
    want = np.asarray(jhll._rank(_j(h), p))
    got = hll._rank(_t(h.astype(np.int64)), p).numpy()
    np.testing.assert_array_equal(got, want)


def test_rank_keeps_the_reference_float32_rounding_below_p8():
    """At p = 7 (R = 128, the engine's default) w = 2^25 - 1 does not fit
    float32's mantissa: the reference's frexp reads bit length 26, so its
    rank is 32 - 7 - 26 + 1 = 0, where an exact bit length (25) gives 1.
    The port keeps the reference's value."""
    p = 7
    h = np.array([((2**25 - 1) << p) & 0xFFFFFFFF], np.uint32)
    want = int(np.asarray(jhll._rank(_j(h), p))[0])
    got = int(hll._rank(_t(h.astype(np.int64)), p)[0])
    exact = 32 - p - int(2**25 - 1).bit_length() + 1
    assert got == want == 0 and exact == 1


@pytest.mark.parametrize("R", [16, 128])
def test_step_matches_jax_bit_for_bit(R):
    rng = np.random.default_rng(R)
    C, W, B = 7, 16, 512
    jt = _join(C, 3)
    js = jhll.init_state(C, W, R)
    ts = hll.init_state(C, W, R)
    for k in range(8):
        cols = _batch(rng, B, jt.size, 15_000 * k)
        js = jhll.step(js, _j(jt), *map(_j, cols))
        ts = hll.step(ts, _t(jt), *map(_t, cols))
        _same_state(js, ts)
    assert int(ts.dropped) > 0 and int(ts.registers.max()) > 0


def test_masked_rows_touch_no_register():
    """Rows that do not count (invalid, not a view, unknown ad, too late)
    land nowhere: the pad register past the plane takes them."""
    C, W, R = 3, 16, 16
    jt = _join(C, 1)
    B = 6
    cols = (np.array([0, 1, 2, 3, -1, 0], np.int32),      # 3, -1: unknown
            np.arange(B, dtype=np.int32) * 977 - 2000,
            np.array([0, 1, 0, 0, 0, 0], np.int32),
            np.array([5_000, 5_000, 5_000, 5_000, 5_000, -90_000], np.int32),
            np.array([False, True, True, True, True, True]))
    st = hll.step(hll.init_state(C, W, R), _t(jt), *map(_t, cols))
    js = jhll.step(jhll.init_state(C, W, R), _j(jt), *map(_j, cols))
    _same_state(js, st)
    # only row 2 (campaign 2, a valid on-time view) set a register
    assert int((st.registers > 0).sum()) == 1
    assert int((st.registers[2] > 0).sum()) == 1


def test_scan_steps_and_packed_match_jax():
    rng = np.random.default_rng(5)
    C, W, R, N, B = 5, 16, 64, 4, 256
    jt = _join(C, 4)
    batches = [_batch(rng, B, jt.size, 10_000 * k) for k in range(N)]
    # the packed word needs in-range ads and event types
    for b in batches:
        np.clip(b[0], 0, jt.size - 1, out=b[0])
    stacked = [np.stack([b[i] for b in batches]) for i in range(5)]
    js = jhll.scan_steps(jhll.init_state(C, W, R), _j(jt),
                         *map(_j, stacked))
    ts = hll.scan_steps(hll.init_state(C, W, R), _t(jt), *map(_t, stacked))
    _same_state(js, ts)
    packed = np.stack([wc.pack_columns(b[0], b[2], b[4]) for b in batches])
    jp = jhll.scan_steps_packed(jhll.init_state(C, W, R), _j(jt),
                                _j(packed), _j(stacked[1]), _j(stacked[3]))
    tp = hll.scan_steps_packed(hll.init_state(C, W, R), _t(jt),
                               _t(packed), _t(stacked[1]), _t(stacked[3]))
    _same_state(jp, tp)
    _same_state(js, tp)


def _folded(seed, C=6, W=16, R=128, steps=6):
    rng = np.random.default_rng(seed)
    jt = _join(C, 2)
    js, ts = jhll.init_state(C, W, R), hll.init_state(C, W, R)
    for k in range(steps):
        cols = _batch(rng, 2048, jt.size, 12_000 * k)
        js = jhll.step(js, _j(jt), *map(_j, cols))
        ts = hll.step(ts, _t(jt), *map(_t, cols))
    return js, ts


def test_flush_and_estimate_match_jax():
    js, ts = _folded(11)
    je, jw, js2 = jhll.flush(js)
    te, tw, ts2 = hll.flush(ts)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    _same_state(js2, ts2)
    # closed slots freed and zeroed, open ones keep their registers
    freed = ts2.window_ids.numpy() < 0
    assert freed.any() and (~freed).any()
    assert not ts2.registers[:, freed].any()
    assert torch.equal(ts2.registers[:, ~freed], ts.registers[:, ~freed])
    # estimate on every register count the engine may choose
    rng = np.random.default_rng(3)
    for R in (16, 32, 64, 128, 256):
        regs = rng.integers(0, 12, (9, R)).astype(np.uint8)
        regs[0] = 0                       # empty: linear counting, 0
        regs[1, : R // 2] = 0             # linear-counting range
        np.testing.assert_allclose(hll.estimate(_t(regs)).numpy(),
                                   np.asarray(jhll.estimate(_j(regs))),
                                   rtol=1e-6)


def test_merge_matches_jax_and_refuses_other_geometry():
    ja, ta = _folded(21)
    jb, tb = _folded(22)
    _same_state(jhll.merge(ja, jb), hll.merge(ta, tb))
    other = hll.init_state(6, 16, 64)
    with pytest.raises(ValueError, match="geometry mismatch"):
        hll.merge(ta, other)
    with pytest.raises(ValueError, match="window-ring mismatch"):
        hll.merge(ta, ta._replace(window_ids=torch.zeros(8,
                                                         dtype=torch.int32)))


def test_init_state_and_a_legacy_int32_plane():
    with pytest.raises(ValueError, match="power of two"):
        hll.init_state(2, 16, 100)
    st = hll.init_state(4, 16, 32)
    assert st.registers.dtype == torch.uint8
    assert st.registers.shape == (4, 16, 32)
    # an int32 plane (old snapshots) folds to the same register values
    rng = np.random.default_rng(8)
    jt = _join(4, 2)
    cols = _batch(rng, 1024, jt.size, 20_000)
    a = hll.step(st, _t(jt), *map(_t, cols))
    b = hll.step(st._replace(registers=st.registers.to(torch.int32)),
                 _t(jt), *map(_t, cols))
    assert b.registers.dtype == torch.int32
    assert torch.equal(a.registers.to(torch.int32), b.registers)
