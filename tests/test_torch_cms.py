"""``streambench_tpu_torch.ops.cms`` against ``streambench_tpu.ops.cms``.

The same numpy inputs, made from a seed, go through every JAX function of
the module and its port on the CPU (where K3's wrappers run their plain
versions).  All of it is integer: tables, totals, estimates, candidate
tables and rings must be bit-identical, no tolerance.  The port updates
the sketch in place; each comparison starts both sides from the same
state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.ops import cms as jcms
from streambench_tpu.ops import salsa as jsalsa
from streambench_tpu_torch.ops import cms, salsa

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _eq(want, got, what=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _keys(rng, B):
    """Zipf-skewed keys with negatives and values past 2^28."""
    k = np.minimum(rng.zipf(1.1, B), 2**30).astype(np.int32)
    k[rng.random(B) < 0.1] = -1
    k[rng.random(B) < 0.05] = rng.integers(-2**31, 2**31 - 1, 1)[0]
    return k


def _batch(rng, B):
    return (_keys(rng, B), rng.integers(0, 9, B).astype(np.int32),
            rng.random(B) < 0.7)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("depth,width", [(1, 64), (4, 2048), (8, 256)])
def test_row_cols_match(depth, width):
    k = _keys(np.random.default_rng(depth), 3000)
    _eq(jcms._row_cols(_j(k), depth, width),
        cms._row_cols(_t(k), depth, width))


def test_init_state_checks_geometry():
    s = cms.init_state(4, 256)
    _eq(jcms.init_state(4, 256).table, s.table)
    assert s.total.dtype == torch.int32 and int(s.total) == 0
    with pytest.raises(ValueError, match="power of two"):
        cms.init_state(4, 100)
    with pytest.raises(ValueError, match="depth"):
        cms.init_state(9, 256)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("fn", ["update", "update_rowloop"])
def test_update_and_query_match(seed, fn):
    rng = np.random.default_rng(seed)
    js, ts = jcms.init_state(4, 512), cms.init_state(4, 512)
    for _ in range(4):
        k, w, m = _batch(rng, 1000)
        js = getattr(jcms, fn)(js, _j(k), _j(w), _j(m))
        out = getattr(cms, fn)(ts, _t(k), _t(w), _t(m))
        assert out is ts                      # in place
        _eq(js.table, ts.table, "table")
        _eq(js.total, ts.total, "total")
        q = _keys(rng, 700)
        _eq(jcms.query(js, _j(q)), cms.query(ts, _t(q)), "query")


def test_flat_and_rowloop_are_bit_identical():
    rng = np.random.default_rng(9)
    a, b = cms.init_state(8, 128), cms.init_state(8, 128)
    for _ in range(3):
        k, w, m = (_t(x) for x in _batch(rng, 4000))
        cms.update(a, k, w, m)
        cms.update_rowloop(b, k, w, m)
    assert torch.equal(a.table, b.table) and torch.equal(a.total, b.total)


def test_total_wraps_like_int32():
    js, ts = jcms.init_state(2, 64), cms.init_state(2, 64)
    k = np.arange(4, dtype=np.int32)
    w = np.full(4, 2**30, np.int32)
    m = np.ones(4, bool)
    js = jcms.update(js, _j(k), _j(w), _j(m))
    cms.update(ts, _t(k), _t(w), _t(m))
    _eq(js.total, ts.total)
    _eq(js.table, ts.table)


def test_merge_is_sum_and_checks_geometry():
    rng = np.random.default_rng(4)
    js, ts = [], []
    for _ in range(2):
        k, w, m = _batch(rng, 500)
        js.append(jcms.update(jcms.init_state(4, 256), _j(k), _j(w), _j(m)))
        ts.append(cms.update(cms.init_state(4, 256), _t(k), _t(w), _t(m)))
    jm, tm = jcms.merge(*js), cms.merge(*ts)
    _eq(jm.table, tm.table)
    _eq(jm.total, tm.total)
    with pytest.raises(ValueError, match="geometry mismatch"):
        cms.merge(ts[0], cms.init_state(4, 128))


# ----------------------------------------------------------------------
def test_two_stage_update2_and_query_small_match():
    rng = np.random.default_rng(5)
    js, ts = jcms.init_two_stage(4, 512), cms.init_two_stage(4, 512)
    assert tuple(ts.small.shape) == (4, 64)
    _eq(js.small, ts.small)
    for _ in range(5):
        k, w, m = _batch(rng, 800)
        js = jcms.update2(js, _j(k), _j(w), _j(m))
        assert cms.update2(ts, _t(k), _t(w), _t(m)) is ts
        _eq(js.fat.table, ts.fat.table, "fat")
        _eq(js.fat.total, ts.fat.total, "total")
        _eq(js.small, ts.small, "small")
        q = _keys(rng, 300)
        _eq(jcms.query_small(js, _j(q)), cms.query_small(ts, _t(q)))
    # the last batch's keys read at least their fat estimate
    q = _t(k[m])
    assert (cms.query_small(ts, q) >= cms.query(ts.fat, q)).all()


def test_two_stage_geometry_and_merge2():
    assert tuple(cms.init_two_stage(4, 2048).small.shape) == (4, 256)
    assert tuple(cms.init_two_stage(4, 128, 32).small.shape) == (4, 32)
    with pytest.raises(ValueError, match="power of two"):
        cms.init_two_stage(4, 2048, 100)
    a = cms.init_two_stage(4, 256)
    with pytest.raises(ValueError, match="does not merge"):
        cms.merge2(a, a)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("family", ["fixed", "twostage", "salsa"])
def test_family_dispatch_matches(family):
    rng = np.random.default_rng(6)
    if family == "fixed":
        js, ts = jcms.init_state(4, 256), cms.init_state(4, 256)
    elif family == "twostage":
        js, ts = jcms.init_two_stage(4, 256), cms.init_two_stage(4, 256)
    else:
        js, ts = jsalsa.init_state(4, 256), salsa.init_state(4, 256)
    for _ in range(3):
        k, w, m = _batch(rng, 600)
        js = jcms.sk_update(js, _j(k), _j(w), _j(m))
        ts = cms.sk_update(ts, _t(k), _t(w), _t(m))
    q = _keys(rng, 400)
    _eq(jcms.point_query(js, _j(q)), cms.point_query(ts, _t(q)))
    _eq(jcms.sk_total(js), cms.sk_total(ts))
    jv, ji = jcms.heavy_hitters(js, _j(q), k=16)
    tv, ti = cms.heavy_hitters(ts, _t(q), k=16)
    _eq(jv, tv)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def _family_states(family, D=4, W=256):
    if family == "fixed":
        return jcms.init_state(D, W), cms.init_state(D, W)
    if family == "twostage":
        return jcms.init_two_stage(D, W), cms.init_two_stage(D, W)
    return jsalsa.init_state(D, W), salsa.init_state(D, W)


def _sketch_leaves(state):
    out = []
    for v in state:
        out += _sketch_leaves(v) if isinstance(v, tuple) else [v]
    return out


@pytest.mark.parametrize("D", [1, 4, 8])
@pytest.mark.parametrize("family", ["fixed", "twostage", "salsa"])
def test_update_query_matches_update_then_point_query(family, D):
    """The session fold's fused entry: the reference's ``sk_update`` then
    ``point_query`` of the same keys, batch after batch (all rows in,
    all out and an empty batch among them); every plane, the total and
    the estimates bit-identical."""
    rng = np.random.default_rng(40 + D)
    js, ts = _family_states(family, D)
    for b in range(5):
        k, w, m = _batch(rng, 700)
        if b == 1:
            m[:] = True
        elif b == 2:
            m[:] = False
        elif b == 3:
            k, w, m = k[:0], w[:0], m[:0]
        js = jcms.sk_update(js, _j(k), _j(w), _j(m))
        want = jcms.point_query(js, _j(k))
        ts, got = cms.update_query(ts, _t(k), _t(w), _t(m))
        _eq(want, got, f"estimates, batch {b}")
        for a, t in zip(_sketch_leaves(js), _sketch_leaves(ts)):
            _eq(a, t, f"sketch, batch {b}")
    _eq(jcms.sk_total(js), cms.sk_total(ts))


def test_update_query_updates_fixed_and_two_stage_in_place():
    for family in ("fixed", "twostage"):
        _, ts = _family_states(family)
        k, w, m = _batch(np.random.default_rng(9), 300)
        out, _ = cms.update_query(ts, _t(k), _t(w), _t(m))
        assert out is ts and int(cms.sk_total(ts)) == int(w[m].sum())


def test_dispatch_refuses_other_states():
    with pytest.raises(TypeError, match="not a sketch state"):
        cms.sk_update(object(), None, None, None)
    with pytest.raises(TypeError, match="not a sketch state"):
        cms.point_query(object(), None)
    with pytest.raises(TypeError, match="not a sketch state"):
        cms.update_query(object(), None, None, None)


def test_top_k_ties_go_to_the_lowest_index_like_jax():
    """``torch.topk`` gave [2, 4, 1] here; ``jax.lax.top_k`` [1, 2, 4]."""
    import jax

    x = np.array([3, 5, 5, 1, 5], np.int32)
    jv, ji = jax.lax.top_k(_j(x), 3)
    tv, ti = cms.top_k(_t(x), 3)
    assert ti.tolist() == np.asarray(ji).tolist() == [1, 2, 4]
    _eq(jv, tv)
    ring = np.array([-1] * 6 + [7, 7, 2, -1], np.int32)
    jv, ji = jax.lax.top_k(_j(ring), 8)
    tv, ti = cms.top_k(_t(ring), 8)
    assert ti.tolist() == np.asarray(ji).tolist()


# ----------------------------------------------------------------------
def test_init_topk_and_candidates():
    tk = cms.init_topk(32)
    _eq(jcms.init_topk(32).keys, tk.keys)
    _eq(jcms.init_topk(32).ests, tk.ests)
    ck, ce = cms.init_candidates(64)
    jk, je = jcms.init_candidates(64)
    _eq(jk, ck)
    _eq(je, ce)
    with pytest.raises(ValueError, match="power of two"):
        cms.init_candidates(100)


@pytest.mark.parametrize("salt", [0, 7, 2**31 - 1, -5])
def test_fold_candidates_matches_with_its_salt(salt):
    """The slot hash xors the key with 0xA5A5A5A5 and the salt as uint32
    (a negative salt and key -1 wrap); a salt given as a tensor works as
    the int does."""
    rng = np.random.default_rng(abs(salt) % 97)
    M2 = 64
    jk, je = jcms.init_candidates(M2)
    tk, te = cms.init_candidates(M2)
    tk2, te2 = cms.init_candidates(M2)
    for _ in range(5):
        k = _keys(rng, 300)
        k[:5] = -1
        e = rng.integers(0, 50, 300).astype(np.int32)
        m = rng.random(300) < 0.8
        jk, je = jcms.fold_candidates(jk, je, _j(k), _j(e), _j(m),
                                      jnp.int32(salt))
        tk, te = cms.fold_candidates(tk, te, _t(k), _t(e), _t(m), salt)
        tk2, te2 = cms.fold_candidates(
            tk2, te2, _t(k), _t(e), _t(m),
            torch.tensor(salt, dtype=torch.int32))
        _eq(jk, tk, "keys")
        _eq(je, te, "ests")
        assert torch.equal(tk, tk2) and torch.equal(te, te2)


def test_fold_candidates_salt_moves_collisions():
    """Different salts place the same keys in different slots."""
    k = _t(np.arange(1, 200, dtype=np.int32))
    e = _t(np.full(199, 3, np.int32))
    m = torch.ones(199, dtype=torch.bool)
    a, _ = cms.fold_candidates(*cms.init_candidates(64), k, e, m, 1)
    b, _ = cms.fold_candidates(*cms.init_candidates(64), k, e, m, 2)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_update_topk_matches(seed):
    rng = np.random.default_rng(20 + seed)
    js, ts = jcms.init_state(4, 256), cms.init_state(4, 256)
    jt, tt = jcms.init_topk(16), cms.init_topk(16)
    for _ in range(6):
        k, w, m = _batch(rng, 200)
        js = jcms.update(js, _j(k), _j(w), _j(m))
        cms.update(ts, _t(k), _t(w), _t(m))
        jt = jcms.update_topk(js, jt, _j(k), _j(m))
        tt = cms.update_topk(ts, tt, _t(k), _t(m))
        _eq(jt.keys, tt.keys, "keys")
        _eq(jt.ests, tt.ests, "ests")


def test_update_topk_dedupes_and_keeps_max_estimate():
    """``tests/test_heavy_hitters_scale.py:65``: duplicate keys collapse
    to one entry with the largest estimate; interleaved estimates too."""
    ts = cms.init_state(4, 256)
    js = jcms.init_state(4, 256)
    k = np.array([5, 5, 5, 9, 9, 3], np.int32)
    w = np.array([1, 2, 3, 4, 1, 2], np.int32)
    m = np.ones(6, bool)
    js = jcms.update(js, _j(k), _j(w), _j(m))
    cms.update(ts, _t(k), _t(w), _t(m))
    jt = jcms.update_topk(js, jcms.init_topk(8), _j(k), _j(m))
    tt = cms.update_topk(ts, cms.init_topk(8), _t(k), _t(m))
    _eq(jt.keys, tt.keys)
    _eq(jt.ests, tt.ests)
    keys = tt.keys.numpy()
    assert sorted(keys[keys >= 0].tolist()) == [3, 5, 9]
    # a later lower estimate of a key in the ring does not replace it
    low = np.array([5], np.int32)
    jt = jcms.update_topk(jcms.init_state(4, 256), jt, _j(low),
                          _j(np.ones(1, bool)))
    tt = cms.update_topk(cms.init_state(4, 256), tt, _t(low),
                         _t(np.ones(1, bool)))
    _eq(jt.keys, tt.keys)
    _eq(jt.ests, tt.ests)
    assert int(tt.ests[tt.keys == 5][0]) == 6


def test_update_topk_ties_keep_the_lower_key():
    """Equal estimates: the ring keeps keys in ascending order (the sort
    groups by key first), as JAX's ``top_k`` over the grouped array."""
    tbl = cms.init_state(2, 64)
    jtbl = jcms.init_state(2, 64)
    k = np.array([40, 10, 30, 20, 50], np.int32)
    m = np.ones(5, bool)
    jt = jcms.update_topk(jtbl, jcms.init_topk(3), _j(k), _j(m))
    tt = cms.update_topk(tbl, cms.init_topk(3), _t(k), _t(m))
    _eq(jt.keys, tt.keys)
    assert tt.keys.tolist() == [10, 20, 30]
