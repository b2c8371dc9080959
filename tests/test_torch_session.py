"""The port's ``ops/session.py`` against ``streambench_tpu.ops.session``.

The same numpy inputs, made from a seed, go through the JAX function and
its port on the CPU.  Everything here is integer state: the carried
sessions, the watermark, ``dropped`` and both closed-session emissions
must be bit-identical (no tolerance).  The cases include those of the
reference's ``tests/test_windows.py:273-363``: late events, a far-late
event, capacity overflow, the watermark flush and ``force``.
"""

import numpy as np
import pytest
import torch

from streambench_tpu.ops import session as jsession
from streambench_tpu_torch.ops import session

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _same(jax_tuple, port_tuple, what):
    for name, want, got in zip(port_tuple._fields, jax_tuple, port_tuple):
        want = np.asarray(want)
        got = got.numpy()
        assert got.dtype == want.dtype, (what, name)
        np.testing.assert_array_equal(got, want, err_msg=f"{what}.{name}")


def _both_step(jst, tst, user, et, tm, valid, **kw):
    jst, jb, jc = jsession.step(jst, user, et, tm, valid, **kw)
    tst, tb, tc = session.step(tst, _t(user), _t(et), _t(tm), _t(valid), **kw)
    _same(jst, tst, "state")
    _same(jb, tb, "closed_in_batch")
    _same(jc, tc, "closed_carry")
    return jst, tst, (tb, tc)


def _rows(*closed):
    out = []
    for c in closed:
        for i in np.flatnonzero(c.valid.numpy()):
            out.append((int(c.user[i]), int(c.start[i]), int(c.end[i]),
                        int(c.clicks[i])))
    return out


def _ones(n):
    return np.ones(n, np.int32), np.ones(n, bool)


@pytest.mark.parametrize("seed", range(6))
def test_random_batches_match_jax(seed):
    """Negative and past-capacity users, every event type, invalid rows,
    late and very late times, several gaps."""
    rng = np.random.default_rng(seed)
    U, B = 16, 128
    gap = [30_000, 5_000, 1_000][seed % 3]
    jst, tst = jsession.init_state(U), session.init_state(U)
    t0 = 70_000
    for _ in range(10):
        user = rng.integers(-2, U + 3, B).astype(np.int32)
        et = rng.integers(-1, 4, B).astype(np.int32)
        tm = (t0 + rng.integers(-80_000, 60_000, B)).astype(np.int32)
        valid = rng.random(B) < 0.9
        t0 += 40_000
        jst, tst, _ = _both_step(jst, tst, user, et, tm, valid, gap_ms=gap,
                                 lateness_ms=60_000)
    for force in (False, True):
        jst, jc = jsession.flush(jst, gap_ms=gap, force=force)
        tst, tc = session.flush(tst, gap_ms=gap, force=force)
        _same(jst, tst, "state")
        _same(jc, tc, f"flush(force={force})")


def test_sessions_match_the_reference_golden():
    """``tests/test_windows.py:273``: the sessions emitted over 8 batches
    plus the forced flush are the golden sessionization's."""
    rng = np.random.default_rng(31)
    U, B, gap = 16, 128, 30_000
    jst, tst = jsession.init_state(U), session.init_state(U)
    emitted, events = [], []
    t0 = 70_000
    for _ in range(8):
        user = rng.integers(0, U, B).astype(np.int32)
        et = rng.integers(0, 3, B).astype(np.int32)
        tm = np.sort(t0 + rng.integers(0, 60_000, B)).astype(np.int32)
        t0 += 60_000
        jst, tst, closed = _both_step(jst, tst, user, et, tm,
                                      np.ones(B, bool), gap_ms=gap)
        emitted += _rows(*closed)
        events += list(zip(user.tolist(), et.tolist(), tm.tolist()))
    tst, fin = session.flush(tst, gap_ms=gap, force=True)
    emitted += _rows(fin)
    want = {}
    for u, et, t in sorted(events, key=lambda e: (e[0], e[2])):
        want.setdefault(u, []).append((t, et))
    golden = []
    for u, rows in want.items():
        start = last = None
        clicks = 0
        for t, et in rows:
            if start is not None and t - last > gap:
                golden.append((u, start, last, clicks))
                start = None
            if start is None:
                start, clicks = t, 0
            last = t
            clicks += et == 1
        golden.append((u, start, last, clicks))
    assert int(tst.dropped) == 0
    assert sorted(emitted) == sorted(golden)


def test_flush_by_watermark_closes_only_passed_sessions():
    jst, tst = jsession.init_state(4), session.init_state(4)
    et, v = _ones(2)
    jst, tst, _ = _both_step(jst, tst, np.array([1, 2], np.int32), et,
                             np.array([70_000, 71_000], np.int32), v)
    et, v = _ones(1)
    jst, tst, _ = _both_step(jst, tst, np.array([3], np.int32), et,
                             np.array([200_000], np.int32), v)
    jst, jc = jsession.flush(jst, gap_ms=30_000, lateness_ms=60_000)
    tst, tc = session.flush(tst, gap_ms=30_000, lateness_ms=60_000)
    _same(jc, tc, "flush")
    got = _rows(tc)
    assert (1, 70_000, 70_000, 1) in got and (2, 71_000, 71_000, 1) in got
    assert all(u != 3 for u, *_ in got)
    assert int(tst.last_time[3]) == 200_000


def test_capacity_overflow_is_dropped_and_counted():
    jst, tst = jsession.init_state(2), session.init_state(2)
    et, v = _ones(3)
    jst, tst, _ = _both_step(jst, tst, np.array([0, 1, 5], np.int32), et,
                             np.array([70_000, 70_001, 70_002], np.int32), v)
    assert int(tst.dropped) == 1


def test_late_event_does_not_regress_the_carry():
    jst, tst = jsession.init_state(4), session.init_state(4)
    et, v = _ones(1)
    for t in (100_000, 90_000, 125_000):
        jst, tst, closed = _both_step(jst, tst, np.array([1], np.int32), et,
                                      np.array([t], np.int32), v)
        assert _rows(*closed) == []
        assert int(tst.last_time[1]) == max(t, 100_000)
    tst, fin = session.flush(tst, force=True)
    assert _rows(fin) == [(1, 90_000, 125_000, 3)]


def test_late_and_far_events_in_one_batch_use_the_carried_activity():
    jst, tst = jsession.init_state(4), session.init_state(4)
    et, v = _ones(1)
    jst, tst, _ = _both_step(jst, tst, np.array([1], np.int32), et,
                             np.array([100_000], np.int32), v)
    et, v = _ones(2)
    jst, tst, closed = _both_step(jst, tst, np.array([1, 1], np.int32), et,
                                  np.array([90_000, 125_000], np.int32), v)
    assert _rows(*closed) == []
    tst, fin = session.flush(tst, force=True)
    assert _rows(fin) == [(1, 90_000, 125_000, 3)]


def test_far_late_event_is_its_own_session():
    jst, tst = jsession.init_state(4), session.init_state(4)
    et, v = _ones(1)
    jst, tst, _ = _both_step(jst, tst, np.array([1], np.int32), et,
                             np.array([100_000], np.int32), v)
    jst, tst, closed = _both_step(jst, tst, np.array([1], np.int32), et,
                                  np.array([50_000], np.int32), v)
    got = _rows(*closed)
    tst, fin = session.flush(tst, force=True)
    assert sorted(got + _rows(fin)) == [(1, 50_000, 50_000, 1),
                                        (1, 100_000, 100_000, 1)]


def test_events_past_lateness_are_dropped():
    jst, tst = jsession.init_state(4), session.init_state(4)
    et, v = _ones(1)
    jst, tst, _ = _both_step(jst, tst, np.array([0], np.int32), et,
                             np.array([200_000], np.int32), v)
    jst, tst, _ = _both_step(jst, tst, np.array([1], np.int32), et,
                             np.array([139_999], np.int32), v)
    assert int(tst.dropped) == 1 and int(tst.last_time[1]) == -1


def test_state_input_is_not_modified():
    rng = np.random.default_rng(3)
    tst = session.init_state(8)
    before = [t.clone() for t in tst]
    session.step(tst, _t(rng.integers(0, 8, 64).astype(np.int32)),
                 _t(np.ones(64, np.int32)),
                 _t((70_000 + rng.integers(0, 9_000, 64)).astype(np.int32)),
                 _t(np.ones(64, bool)))
    assert all(torch.equal(a, b) for a, b in zip(before, tst))


@pytest.mark.parametrize("seed", range(4))
def test_set_scatters_see_unique_indices(seed):
    """The ``.set`` scatters rely on unique kept indices: one boundary row
    a segment and one open segment a user (torch's ``scatter_`` leaves
    duplicates unspecified).  Recomputed from the outputs of ``step``."""
    rng = np.random.default_rng(100 + seed)
    U, B = 12, 256
    tst = session.init_state(U)
    t0 = 70_000
    for _ in range(6):
        user = rng.integers(-1, U + 1, B).astype(np.int32)
        tm = (t0 + rng.integers(-5_000, 20_000, B)).astype(np.int32)
        t0 += 15_000
        tst, inb, carry = session.step(
            tst, _t(user), _t(rng.integers(0, 3, B).astype(np.int32)),
            _t(tm), _t(rng.random(B) < 0.95), gap_ms=3_000)
        seg_user = inb.user.numpy()
        exists = seg_user >= 0
        # segment ids are dense from 0: the boundary rows are distinct
        assert not exists[np.argmin(exists):].any() or exists.all()
        open_users = seg_user[exists & ~inb.valid.numpy()]
        assert open_users.size == np.unique(open_users).size
        carried = carry.user.numpy()[carry.valid.numpy()]
        assert carried.size == np.unique(carried).size


def test_flush_force_closes_all_open_and_keeps_the_watermark():
    jst, tst = jsession.init_state(6), session.init_state(6)
    et, v = _ones(3)
    jst, tst, _ = _both_step(jst, tst, np.array([0, 2, 4], np.int32), et,
                             np.array([70_000, 80_000, 90_000], np.int32), v)
    jst, jc = jsession.flush(jst, force=True)
    tst, tc = session.flush(tst, force=True)
    _same(jst, tst, "state")
    _same(jc, tc, "flush")
    assert sorted(_rows(tc)) == [(0, 70_000, 70_000, 1),
                                 (2, 80_000, 80_000, 1),
                                 (4, 90_000, 90_000, 1)]
    assert (tst.last_time.numpy() == -1).all()
    assert int(tst.watermark) == 90_000
