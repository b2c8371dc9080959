"""The port's window fold (``streambench_tpu_torch.ops.windowcount``)
against the JAX package's, bit for bit.

The same numpy inputs, made from fixed seeds, go through each JAX
function and its port; every value is an int32, so equality is exact
(tolerance 0).  The JAX side runs on the CPU, its Pallas count kernel in
interpret mode; the port's count runs its plain version on the CPU.
Some cases start both from the same mid-stream ring, carried across with
``state_from_numpy``.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.datagen import gen as jgen
from streambench_tpu.encode import EventEncoder
from streambench_tpu.ops import windowcount as jwc
from streambench_tpu_torch.ops import windowcount as twc

J_METHODS = ("scatter", "pallas")
T_METHODS = ("scatter", "kernel", "onehot", "matmul")

# tiny tensors: one intra-op thread keeps these tests from crowding the
# other test workers' CPUs
torch.set_num_threads(1)


def to_np(state):
    return [np.asarray(x) for x in state]


def assert_state_equal(jstate, tstate):
    for name, a, b in zip(jwc.WindowState._fields, jstate, tstate):
        assert b.dtype == torch.int32, name
        assert np.array_equal(np.asarray(a), b.numpy()), name


def random_batch(rng, B, n_ads, t_lo, t_hi, p_valid=0.9):
    """One synthetic batch: ad ids across the whole join table (its
    trailing -1 "unknown ad" row included), all event types, a spread
    of event times, some invalid rows."""
    return (rng.integers(0, n_ads, B).astype(np.int32),
            rng.integers(-1, 3, B).astype(np.int32),
            rng.integers(t_lo, t_hi, B).astype(np.int32),
            rng.random(B) < p_valid)


def join_table(rng, n_ads, C):
    return np.concatenate([rng.integers(0, C, n_ads - 1),
                           [-1]]).astype(np.int32)


def jstep(state, jt, cols, method, **kw):
    return jwc.step(state, jnp.asarray(jt), *map(jnp.asarray, cols),
                    method=method, **kw)


def tstep(state, jt, cols, method, **kw):
    return twc.step(state, torch.from_numpy(jt),
                    *map(torch.from_numpy, cols), method=method, **kw)


def mid_stream(rng, C, W, jt, steps=6):
    """A JAX state several batches into a stream (ring partly claimed,
    watermark advanced, some drops)."""
    state = jwc.init_state(C, W)
    t = 0
    for _ in range(steps):
        state = jstep(state, jt, random_batch(rng, 256, jt.size, t - 70_000,
                                              t + 30_000), "scatter")
        t += 25_000
    return state, t


# ----------------------------------------------------------------------
@pytest.mark.parametrize("jm,tm", [(j, t) for j in J_METHODS
                                   for t in T_METHODS])
@pytest.mark.parametrize("B,C,W", [(300, 7, 5), (512, 100, 16)])
def test_apply_count_matches_jax(jm, tm, B, C, W):
    rng = np.random.default_rng(B + C)
    counts = rng.integers(0, 9, (C, W)).astype(np.int32)
    camp = rng.integers(-1, C, B).astype(np.int32)
    slot = rng.integers(0, W, B).astype(np.int32)
    mask = (rng.random(B) < 0.7) & (camp >= 0)
    want = jwc.apply_count(jnp.asarray(counts), jnp.asarray(camp),
                           jnp.asarray(slot), jnp.asarray(mask), jm)
    got = twc.apply_count(torch.from_numpy(counts.copy()),
                          torch.from_numpy(camp), torch.from_numpy(slot),
                          torch.from_numpy(mask), tm)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("jm,tm", [("scatter", "scatter"),
                                   ("pallas", "kernel"),
                                   ("onehot", "onehot"),
                                   ("matmul", "matmul")])
@pytest.mark.parametrize("B,C,W", [(300, 7, 5), (4096, 100, 16)])
def test_apply_count_arms_match_their_jax_arms(jm, tm, B, C, W):
    """Each of the port's four arms against the JAX arm it ports, on a
    plane that already holds counts, with masked rows of every kind."""
    rng = np.random.default_rng(B * C + W)
    counts = rng.integers(0, 1000, (C, W)).astype(np.int32)
    camp = rng.integers(-1, C, B).astype(np.int32)
    slot = rng.integers(0, W, B).astype(np.int32)
    mask = (rng.random(B) < 0.8) & (camp >= 0)
    want = jwc.apply_count(jnp.asarray(counts), jnp.asarray(camp),
                           jnp.asarray(slot), jnp.asarray(mask), jm)
    got = torch.from_numpy(counts.copy())
    out = twc.apply_count(got, torch.from_numpy(camp),
                          torch.from_numpy(slot), torch.from_numpy(mask), tm)
    assert out is got                       # in place
    assert np.array_equal(np.asarray(want), got.numpy())
    assert twc.METHODS == T_METHODS


def test_apply_count_rejects_unknown_method():
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown method"):
        twc.apply_count(torch.zeros(1, 2, dtype=torch.int32), z, z,
                        z.bool(), "pallas")


# ----------------------------------------------------------------------
ASSIGN_CASES = {
    # window ids below the encoder's base (wid -1, -2) and in range
    "negative_wid": dict(times=[-5_000, -15_000, 75_000, 5_000],
                         wm=0),
    # watermark far ahead: 100 s late is beyond the 60 s lateness
    "beyond_lateness": dict(times=[200_000, 100_000, 139_999, 140_000],
                            wm=200_000),
    # two windows W slots apart claim the same slot in one batch: the
    # newer one wins, the older one's rows are evicted (dropped)
    "duplicate_claims_and_eviction": dict(
        times=[5_000, 85_000, 5_001, 85_001, 165_000, 5_002], wm=0),
}


@pytest.mark.parametrize("case", sorted(ASSIGN_CASES))
@pytest.mark.parametrize("start", ["fresh", "mid_stream"])
def test_assign_windows_matches_jax(case, start):
    spec = ASSIGN_CASES[case]
    W = 8
    times = np.array(spec["times"], np.int32)
    n = times.size
    if start == "fresh":
        wids0 = np.full(W, -1, np.int32)
        wids0[:3] = [0, 9, -1]
    else:
        wids0 = np.array([16, 1, 10, 3, -1, 5, 14, 7], np.int32)
    wm = np.int32(spec["wm"])
    wid = np.floor_divide(times, 10_000).astype(np.int32)
    wanted = np.ones(n, bool)
    wanted[-1] = False                      # one unwanted row
    valid = np.ones(n, bool)
    kw = dict(divisor_ms=10_000, lateness_ms=60_000)
    want = jwc.assign_windows(jnp.asarray(wids0), jnp.asarray(wm),
                              jnp.asarray(wid), jnp.asarray(wanted),
                              jnp.asarray(valid), jnp.asarray(times), **kw)
    got = twc.assign_windows(torch.from_numpy(wids0),
                             torch.tensor(int(wm), dtype=torch.int32),
                             torch.from_numpy(wid),
                             torch.from_numpy(wanted),
                             torch.from_numpy(valid),
                             torch.from_numpy(times), **kw)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert b.dtype in (torch.int32, torch.bool)


def test_all_invalid_rows_leave_watermark_and_ring_alone():
    """An all-invalid pad batch: the watermark max sees only NEG."""
    wids0 = np.array([3, -1, 5, 6], np.int32)
    times = np.zeros(6, np.int32)
    args = (np.zeros(6, np.int32), np.zeros(6, bool), np.zeros(6, bool),
            times)
    want = jwc.assign_windows(jnp.asarray(wids0), jnp.asarray(np.int32(7)),
                              *(jnp.asarray(a) for a in args),
                              divisor_ms=10_000, lateness_ms=60_000)
    got = twc.assign_windows(torch.from_numpy(wids0),
                             torch.tensor(7, dtype=torch.int32),
                             *(torch.from_numpy(a) for a in args),
                             divisor_ms=10_000, lateness_ms=60_000)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int(got[3]) == 7 and not got[1].any()


# ----------------------------------------------------------------------
@pytest.mark.parametrize("tm", T_METHODS)
@pytest.mark.parametrize("start", ["fresh", "mid_stream"])
@pytest.mark.parametrize("B", [300, 256])
def test_step_sequence_matches_jax(tm, start, B):
    """Batches with unknown ads, negative and beyond-lateness event
    times, ring eviction and invalid rows; JAX alternates its scatter and
    Pallas methods, the port uses one method; states equal after every
    step and every drain."""
    C, W, n_ads = 11, 8, 41
    rng = np.random.default_rng(7 if start == "fresh" else 8)
    jt = join_table(rng, n_ads, C)
    if start == "fresh":
        js, t = jwc.init_state(C, W), 0
    else:
        js, t = mid_stream(rng, C, W, jt)
    ts = twc.state_from_numpy(to_np(js))
    for i in range(8):
        cols = random_batch(rng, B, n_ads, t - 80_000, t + 30_000)
        js = jstep(js, jt, cols, J_METHODS[i % 2])
        ts = tstep(ts, jt, cols, tm)
        assert_state_equal(js, ts)
        if i % 3 == 2:
            jd, jw, js = jwc.flush_deltas(js)
            td, tw, ts = twc.flush_deltas(ts)
            assert np.array_equal(np.asarray(jd), td.numpy())
            assert np.array_equal(np.asarray(jw), tw.numpy())
            assert_state_equal(js, ts)
        t += 20_000
    assert int(ts.dropped) > 0              # lateness/eviction exercised


def test_step_packed_matches_jax_packed_and_unpacked():
    C, W, n_ads = 6, 16, 25
    rng = np.random.default_rng(11)
    jt = join_table(rng, n_ads, C)
    js, t = mid_stream(rng, C, W, jt, steps=3)
    ts = twc.state_from_numpy(to_np(js))
    tu = twc.state_from_numpy(to_np(js))
    for _ in range(5):
        ad, et, tt, v = random_batch(rng, 512, n_ads, t - 65_000, t + 9_000)
        packed = twc.pack_columns(ad, et, v)
        assert np.array_equal(packed, jwc.pack_columns(ad, et, v))
        js = jwc.step_packed(js, jnp.asarray(jt), jnp.asarray(packed),
                             jnp.asarray(tt), method="pallas")
        ts = twc.step_packed(ts, torch.from_numpy(jt),
                             torch.from_numpy(packed), torch.from_numpy(tt),
                             method="kernel")
        tu = tstep(tu, jt, (ad, et, tt, v), "scatter")
        assert_state_equal(js, ts)
        assert_state_equal(js, tu)
        t += 15_000


@pytest.mark.parametrize("packed", [True, False])
def test_scan_steps_match_jax_including_pad_batches(packed):
    """An [N, B] stack whose tail batches are all-invalid padding (as the
    engine pads a partial group) folds like JAX's lax.scan."""
    C, W, n_ads, N, B = 9, 32, 30, 4, 128
    rng = np.random.default_rng(13 + packed)
    jt = join_table(rng, n_ads, C)
    js, t = mid_stream(rng, C, W, jt, steps=2)
    ts = twc.state_from_numpy(to_np(js))
    batches = [random_batch(rng, B, n_ads, t - 61_000, t + 40_000)
               for _ in range(N - 1)]
    batches.append((np.zeros(B, np.int32), np.full(B, -1, np.int32),
                    np.zeros(B, np.int32), np.zeros(B, bool)))
    cols = [np.stack([b[i] for b in batches]) for i in range(4)]
    if packed:
        pk = np.stack([twc.pack_columns(b[0], b[1], b[3]) for b in batches])
        pk[-1] = 0          # a packed-zero pad row: ad 0, type -1, invalid
        js = jwc.scan_steps_packed(js, jnp.asarray(jt), jnp.asarray(pk),
                                   jnp.asarray(cols[2]), method="pallas")
        ts = twc.scan_steps_packed(ts, torch.from_numpy(jt),
                                   torch.from_numpy(pk),
                                   torch.from_numpy(cols[2]),
                                   method="kernel")
    else:
        js = jwc.scan_steps(js, jnp.asarray(jt), *map(jnp.asarray, cols),
                            method="scatter")
        ts = twc.scan_steps(ts, torch.from_numpy(jt),
                            *map(torch.from_numpy, cols), method="kernel")
    assert_state_equal(js, ts)


def test_golden_dataset_through_both():
    """Generator events (skew on: out-of-order times, rare 60 s-late
    events) encoded once, folded by both implementations."""
    campaigns = [f"c{i}" for i in range(10)]
    mapping = {f"ad{i}_{j}": campaigns[i] for i in range(10)
               for j in range(10)}
    src = jgen.EventSource(ads=list(mapping) + ["stranger-ad"],
                           user_ids=["u"], page_ids=["p"], with_skew=True,
                           rng=random.Random(3))
    lines = [src.event_at(1_700_000_000_000 + 7 * i).encode()
             for i in range(3000)]
    enc = EventEncoder(mapping, campaigns)
    jt = enc.join_table
    js = jwc.init_state(enc.num_campaigns, 16)
    ts = twc.init_state(enc.num_campaigns, 16)
    for i in range(0, len(lines), 512):
        b = enc.encode(lines[i:i + 512], 512)
        cols = (b.ad_idx, b.event_type, b.event_time, b.valid)
        js = jstep(js, jt, cols, "pallas")
        ts = tstep(ts, jt, cols, "kernel")
    assert_state_equal(js, ts)
    assert int(ts.counts.sum()) > 0


# ----------------------------------------------------------------------
def test_gathers_stay_in_range_without_the_pad_row_conventions():
    """JAX clamps an out-of-range gather; a CUDA gather would fault.  The
    port clamps explicitly, so it needs neither the encoder's trailing -1
    row nor a zero pad word to stay in range: here the join table has NO
    trailing -1 row and ad ids run past its end."""
    jt = np.array([2, 0, 1], np.int32)               # no unknown-ad row
    ad = np.array([0, 1, 2, 3, 7, 2], np.int32)       # 3 and 7 out of range
    et = np.zeros(6, np.int32)
    tt = np.array([1_000, 2_000, 3_000, 4_000, 5_000, 6_000], np.int32)
    v = np.ones(6, bool)
    js = jstep(jwc.init_state(3, 8), jt, (ad, et, tt, v), "scatter")
    ts = tstep(twc.init_state(3, 8), jt, (ad, et, tt, v), "kernel")
    assert_state_equal(js, ts)
    assert int(ts.counts.sum()) == 6


@pytest.mark.parametrize("tm", T_METHODS)
def test_negative_ad_index_wraps_like_jax(tm):
    """JAX's gather counts a negative index from the end, then clamps;
    the port's ``gather_rows`` does the same, so ``-1`` reads the
    trailing unknown-ad row and counts nothing, ``-2`` reads campaign 1,
    ``-n`` and ``-n - 1`` read row 0, and indices past the end read the
    last row."""
    jt = np.array([0, 1, -1], np.int32)
    n = jt.size
    for ad in (-1, -2, -n, -n - 1, -100, n, n + 4):
        cols = (np.array([ad], np.int32), np.zeros(1, np.int32),
                np.array([12_000], np.int32), np.ones(1, bool))
        js = jstep(jwc.init_state(2, 8), jt, cols, "scatter")
        ts = tstep(twc.init_state(2, 8), jt, cols, tm)
        assert_state_equal(js, ts)
    idx = torch.tensor([-1, -2, -3, -4, -100, 0, 2, 3, 9], dtype=torch.int32)
    got = twc.gather_rows(torch.from_numpy(jt), idx)
    want = jnp.asarray(jt)[jnp.asarray(idx.numpy())]
    assert np.array_equal(np.asarray(want), got.numpy())
    assert got.tolist() == [-1, 1, 0, 0, 0, 0, -1, -1, -1]


def test_flush_hands_back_old_counts_and_a_fresh_zeroed_tensor():
    """The in-place hazard: the drained deltas must not see later steps
    (the port's steps add into state.counts in place)."""
    rng = np.random.default_rng(17)
    jt = join_table(rng, 20, 5)
    ts = twc.init_state(5, 16)
    ts = tstep(ts, jt, random_batch(rng, 256, 20, 0, 30_000), "kernel")
    deltas, wids, ts2 = twc.flush_deltas(ts)
    snapshot = deltas.clone()
    assert ts2.counts.data_ptr() != deltas.data_ptr()
    assert not ts2.counts.any()
    tstep(ts2, jt, random_batch(rng, 256, 20, 0, 30_000), "kernel")
    assert torch.equal(deltas, snapshot)


def test_pack_unpack_roundtrip_matches_jax():
    ad = np.array([0, 1, 999, twc.PACK_AD_MAX - 1], np.int32)
    et = np.array([-1, 0, 1, 2], np.int32)
    va = np.array([True, False, True, False])
    packed = twc.pack_columns(ad, et, va)
    want = jwc.unpack_columns(jnp.asarray(packed))
    got = twc.unpack_columns(torch.from_numpy(packed))
    for a, b, orig in zip(want, got, (ad, et, va)):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert np.array_equal(b.numpy(), orig)
    z = twc.unpack_columns(torch.zeros(3, dtype=torch.int32))
    assert z[1].tolist() == [-1] * 3 and not z[2].any()
    with pytest.raises(ValueError, match="ad_idx"):
        twc.pack_columns(np.array([-1], np.int32), et[:1], va[:1])
    with pytest.raises(ValueError, match="event_type"):
        twc.pack_columns(ad[:1], np.array([3], np.int32), va[:1])


def test_state_numpy_roundtrip():
    js = jwc.init_state(4, 6)
    ts = twc.state_from_numpy(to_np(js))
    assert_state_equal(js, ts)
    back = twc.state_to_numpy(ts)
    assert isinstance(back, twc.WindowState)
    for a, b in zip(to_np(js), back):
        assert np.array_equal(a, b) and b.dtype == np.int32
