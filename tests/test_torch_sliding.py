"""``streambench_tpu_torch.ops.sliding`` against ``streambench_tpu.ops.sliding``.

The same numpy inputs, made from a seed, go through the JAX function and
its port on the CPU, where the port's ``kernel`` method runs the count
kernel's plain version.  Tolerance: none.  The state (counts or bucket
plane, window ids, watermark, ``dropped``) and the drained window rows
are integers and must be bit-identical, for the unsliced fold in both
membership landings and for the sliced fold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.ops import sliding as jsl
from streambench_tpu.ops import windowcount as jwc
from streambench_tpu_torch.ops import count as count_ops
from streambench_tpu_torch.ops import sliding
from streambench_tpu_torch.ops import windowcount as wc

torch.set_num_threads(1)

SIZE, SLIDE, LATE = 10_000, 1_000, 60_000
S = SIZE // SLIDE


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _same(jstate, tstate):
    for name, want in zip(jstate._fields, jstate):
        got = getattr(tstate, name).numpy()
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)


def _join(C, ads_per):
    return np.concatenate([np.arange(C * ads_per) % C, [-1]]).astype(
        np.int32)


def _batch(rng, B, n_ads, t0, spread=(-75_000, 4_000)):
    """Late rows across every lateness class (times from 75 s behind the
    batch's newest to 4 s ahead), negative and past-the-end ads, every
    event type, invalid rows."""
    return (rng.integers(-2, n_ads + 2, B).astype(np.int32),
            rng.integers(-1, 3, B).astype(np.int32),
            (t0 + rng.integers(*spread, B)).astype(np.int32),
            rng.random(B) < 0.9)


@pytest.mark.parametrize("method,jax_method", [
    ("scatter", "scatter"), ("matmul", "matmul"), ("kernel", "pallas")],
    ids=["scatter", "factored_matmul", "kernel_routes_to_factored"])
def test_step_matches_jax(method, jax_method):
    rng = np.random.default_rng(len(method))
    C, W = 6, 64
    jt = _join(C, 2)
    js, ts = jwc.init_state(C, W), wc.init_state(C, W)
    for k in range(8):
        cols = _batch(rng, 400, jt.size, 3_500 * k)
        js = jsl.step(js, _j(jt), *map(_j, cols), size_ms=SIZE,
                      slide_ms=SLIDE, lateness_ms=LATE, method=jax_method)
        ts = sliding.step(ts, _t(jt), *map(_t, cols), size_ms=SIZE,
                          slide_ms=SLIDE, lateness_ms=LATE, method=method)
        _same(js, ts)
    assert int(ts.dropped) > 0 and int(ts.counts.sum()) > 0


def _sliced_run(seed, method="kernel", steps=9, flush_every=3):
    """The sliced fold and its drain through both packages; returns the
    port's state and every drained ``(win, wid)`` pair, checked equal to
    the JAX package's on the way."""
    rng = np.random.default_rng(seed)
    C, W = 5, 64
    jt = _join(C, 3)
    js = jsl.init_sliced(C, W, S)
    ts = sliding.init_sliced(C, W, S)
    drains = []
    for k in range(steps):
        cols = _batch(rng, 500, jt.size, 4_000 * k)
        js = jsl.step_sliced(js, _j(jt), *map(_j, cols), size_ms=SIZE,
                             slide_ms=SLIDE, lateness_ms=LATE)
        ts = sliding.step_sliced(ts, _t(jt), *map(_t, cols), size_ms=SIZE,
                                 slide_ms=SLIDE, lateness_ms=LATE,
                                 method=method)
        _same(js, ts)
        if k % flush_every == flush_every - 1:
            jw, jwid, js = jsl.flush_sliced(js, size_ms=SIZE,
                                            slide_ms=SLIDE, lateness_ms=LATE)
            tw, twid, ts = sliding.flush_sliced(ts, size_ms=SIZE,
                                                slide_ms=SLIDE,
                                                lateness_ms=LATE)
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
            np.testing.assert_array_equal(twid.numpy(), np.asarray(jwid))
            _same(js, ts)
            drains.append((tw.numpy(), twid.numpy()))
    return ts, drains


@pytest.mark.parametrize("method", ["scatter", "kernel"])
def test_step_sliced_and_flush_sliced_match_jax(method):
    ts, drains = _sliced_run(7, method)
    assert int(ts.dropped) > 0
    assert sum(int(w.sum()) for w, _ in drains) > 0


def test_every_lateness_class_is_reached():
    """The late rows of ``_batch`` land in all S lateness classes of the
    plane (one step, no drain in between)."""
    rng = np.random.default_rng(3)
    C, W = 4, 128            # the 70 buckets behind the watermark fit
    jt = _join(C, 1)
    st = sliding.init_sliced(C, W, S)
    # first batch sets the watermark; the second spreads behind it
    first = _batch(rng, 200, jt.size, 70_000, spread=(0, 1))
    st = sliding.step_sliced(st, _t(jt), *map(_t, first), method="kernel")
    counts_before = st.counts.clone()
    late = _batch(rng, 4_000, jt.size, 70_000, spread=(-70_000, 0))
    st = sliding.step_sliced(st, _t(jt), *map(_t, late), method="kernel")
    per_class = (st.counts - counts_before).sum((0, 2))
    assert (per_class > 0).all(), per_class


def test_sliced_rows_equal_the_unsliced_rows():
    """Both folds drain the same (campaign, window) -> count rows and the
    same ``dropped`` on one stream (the span-guard regime)."""
    rng = np.random.default_rng(12)
    C, W = 5, 128
    jt = _join(C, 2)
    a = wc.init_state(C, W)
    b = sliding.init_sliced(C, W, S)
    late_eff = sliding.effective_lateness(SIZE, SLIDE, LATE)
    rows_a, rows_b = {}, {}

    def add(rows, win, wid):
        ci, si = np.nonzero(win)
        for c, s in zip(ci, si):
            if wid[s] >= 0:
                key = (int(c), int(wid[s]))
                rows[key] = rows.get(key, 0) + int(win[c, s])

    for k in range(10):
        cols = _batch(rng, 300, jt.size, 3_000 * k, spread=(-30_000, 2_000))
        a = sliding.step(a, _t(jt), *map(_t, cols), method="scatter")
        b = sliding.step_sliced(b, _t(jt), *map(_t, cols), method="kernel")
        if k % 2:
            win, wid, a = wc.flush_deltas(a, divisor_ms=SLIDE,
                                          lateness_ms=late_eff)
            add(rows_a, win.numpy(), wid.numpy())
            win, wid, b = sliding.flush_sliced(b)
            add(rows_b, win.numpy(), wid.numpy())
    assert rows_a == rows_b and len(rows_a) > 50
    assert int(a.dropped) == int(b.dropped) > 0


def test_masked_negative_row_counts_nowhere():
    """On the sliced plane a row that does not count carries campaign -1,
    so row ``-1 * S + d`` < 0: the count kernel's plain version (the
    kernel's CPU arm) counts it nowhere under a false mask, and nowhere
    either when the mask is set (rows outside the plane never count)."""
    C, W = 3, 32
    plane = torch.zeros((C * S, W), dtype=torch.int32)
    row = torch.tensor([-S + 4, -1, 2 * S + 1, -S], dtype=torch.int32)
    slot = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    mask = torch.tensor([False, False, True, True])
    count_ops.count_cells(plane, row, slot, mask)
    assert int(plane.sum()) == 1 and int(plane[2 * S + 1, 7]) == 1
    # and through the sliced step: an unknown ad's view is wanted by no
    # one and lands in no cell
    jt = _join(C, 1)
    cols = (np.array([C, 0], np.int32), np.zeros(2, np.int32),
            np.array([5_000, 5_000], np.int32), np.ones(2, bool))
    st = sliding.step_sliced(sliding.init_sliced(C, W, S), _t(jt),
                             *map(_t, cols), method="kernel")
    js = jsl.step_sliced(jsl.init_sliced(C, W, S), _j(jt), *map(_j, cols))
    _same(js, st)
    assert int(st.counts.sum()) == 1 and int(st.counts[0].sum()) == 1


def test_geometry_is_checked_and_lateness_widened():
    assert sliding.effective_lateness(10_000, 1_000, 60_000) == 69_000
    jt = _t(_join(2, 1))
    cols = [_t(c) for c in (np.zeros(4, np.int32), np.zeros(4, np.int32),
                            np.zeros(4, np.int32), np.ones(4, bool))]
    with pytest.raises(ValueError, match="multiple"):
        sliding.step(wc.init_state(2, 64), jt, *cols, size_ms=10_000,
                     slide_ms=3_000)
    with pytest.raises(ValueError, match="ring too small"):
        sliding.step(wc.init_state(2, 8), jt, *cols)
    with pytest.raises(ValueError, match="lateness classes"):
        sliding.step_sliced(sliding.init_sliced(2, 64, 5), jt, *cols)
    with pytest.raises(ValueError, match="ring too small"):
        sliding.flush_sliced(sliding.init_sliced(2, 8, S))
