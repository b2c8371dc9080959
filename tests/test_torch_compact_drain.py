"""The port's large-key-space drains against the JAX package's, bit for bit.

Two levels, both on the CPU with integer equality (tolerance 0):

- the ops (``flush_deltas_compact``, ``flush_deltas_rows_compact``,
  ``flush_free_slots``, ``flush_rows_zero``) on random states made from
  numpy seeds, with small caps so ``nnz`` falls below, at and above them,
  touched-row vectors padded with duplicates of row 0, all-zero counts
  and ring slots both closed and open;
- the engine: one seeded journal over 1,000 campaigns x 1 ad with a
  64-slot ring, through the JAX engine and the port's, with the drain
  thresholds patched low on both classes so every branch of
  ``_drain_device`` runs, both overflows included.  The port's device
  gate is patched on so its card branches (``rows_compact``, ``compact``)
  run here too; the JAX engine takes ``rows_host`` on the CPU.
"""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import AdAnalyticsEngine as JaxEngine
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.fakeredis import make_store as jax_make_store
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu.ops import windowcount as jwc
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.io.fakeredis import make_store
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    as_redis,
    read_seen_counts,
    seed_campaigns,
)
from streambench_tpu_torch.ops import windowcount as twc
from streambench_tpu_torch.utils.ids import make_ids

torch.set_num_threads(1)

DIV, LATE = 10_000, 60_000
TOPIC = "ad-events"


def random_state(seed, C, W, density, watermark):
    """numpy (counts, window_ids, watermark, dropped): ``density`` of the
    cells nonzero, ring slots holding windows both closed and still open
    at ``watermark`` (and one empty slot)."""
    rng = np.random.default_rng(seed)
    counts = np.where(rng.random((C, W)) < density,
                      rng.integers(1, 9, (C, W)), 0).astype(np.int32)
    top = watermark // DIV
    wids = (top - W + 1 + np.arange(W)).astype(np.int32)
    wids[rng.integers(0, W)] = -1
    return counts, wids, np.int32(watermark), np.int32(rng.integers(0, 5))


def both(arrays):
    """The same state as a JAX ``WindowState`` and a port one."""
    jstate = jwc.WindowState(*(jnp.asarray(np.array(a)) for a in arrays))
    return jstate, twc.state_from_numpy(arrays)


def assert_state_equal(jstate, tstate):
    for name, a, b in zip(jwc.WindowState._fields, jstate, tstate):
        assert b.dtype == torch.int32, name
        assert np.array_equal(np.asarray(a), b.numpy()), name


def assert_pairs_equal(j, t, cap):
    """Same (idx, vals) on the valid prefix, same nnz."""
    jidx, jvals, jnnz = (np.asarray(x) for x in j)
    tidx, tvals, tnnz = (x.numpy() for x in t)
    assert tidx.shape == (cap,) and tvals.shape == (cap,)
    assert tidx.dtype == np.int32 and tnnz.dtype == np.int32
    assert int(tnnz) == int(jnnz)
    k = min(int(jnnz), cap)
    assert np.array_equal(tidx[:k], jidx[:k])
    assert np.array_equal(tvals[:k], jvals[:k])


# C x W = 375 cells; at density 0.05/0.2/0.6 nnz is ~19/~75/~225, so the
# caps 16, 75 and 256 put it above, near and below the cap
@pytest.mark.parametrize("density", [0.0, 0.05, 0.2, 0.6])
@pytest.mark.parametrize("cap", [16, 75, 256])
def test_flush_deltas_compact_matches_jax(density, cap):
    arrays = random_state(int(density * 100) + cap, 25, 15, density,
                          watermark=412_345)
    jstate, tstate = both(arrays)
    j = jwc.flush_deltas_compact(jstate, cap=cap, divisor_ms=DIV,
                                 lateness_ms=LATE)
    t = twc.flush_deltas_compact(tstate, cap=cap, divisor_ms=DIV,
                                 lateness_ms=LATE)
    assert_pairs_equal(j[:3], t[:3], cap)
    # the pre-drain block (the overflow fallback), the slots, the state
    assert np.array_equal(t[3].numpy(), arrays[0])
    assert np.array_equal(np.asarray(j[3]), t[3].numpy())
    assert np.array_equal(np.asarray(j[4]), t[4].numpy())
    assert_state_equal(j[5], t[5])
    assert not t[5].counts.any()


def test_nnz_exactly_at_the_cap():
    arrays = random_state(3, 25, 15, 0.2, watermark=412_345)
    cap = int((arrays[0] > 0).sum())
    jstate, tstate = both(arrays)
    j = jwc.flush_deltas_compact(jstate, cap=cap, divisor_ms=DIV,
                                 lateness_ms=LATE)
    t = twc.flush_deltas_compact(tstate, cap=cap, divisor_ms=DIV,
                                 lateness_ms=LATE)
    assert int(t[2]) == cap
    assert_pairs_equal(j[:3], t[:3], cap)


def padded_rows(rng, C, nrow, R):
    """``nrow`` distinct sorted rows, zero-padded to ``R`` (the JAX
    engine's fixed gather size): the padding repeats row 0."""
    rows = np.zeros(R, np.int32)
    rows[:nrow] = np.sort(rng.choice(C, nrow, replace=False))
    return rows


@pytest.mark.parametrize("nrow", [0, 1, 7, 40])
@pytest.mark.parametrize("cap", [8, 64])
def test_flush_deltas_rows_compact_matches_jax(nrow, cap):
    C, W, R = 40, 12, 40
    arrays = random_state(nrow * 7 + cap, C, W, 0.3, watermark=333_333)
    rng = np.random.default_rng(nrow)
    rows = padded_rows(rng, C, nrow, R)
    if nrow and 0 not in rows[:nrow]:
        # row 0 counted but not touched: its padding duplicates must
        # neither count it nor (in the port, given exact rows) zero it
        assert arrays[0][0].any()
    jstate, tstate = both(arrays)
    j = jwc.flush_deltas_rows_compact(
        jstate, jnp.asarray(rows), jnp.int32(nrow), cap=cap,
        divisor_ms=DIV, lateness_ms=LATE)
    t = twc.flush_deltas_rows_compact(
        tstate, torch.from_numpy(rows.astype(np.int64)), nrow, cap=cap,
        divisor_ms=DIV, lateness_ms=LATE)
    assert_pairs_equal(j[:3], t[:3], cap)
    # sub: the touched rows as they were before the drain
    assert np.array_equal(np.asarray(j[3])[:nrow], t[3].numpy()[:nrow])
    assert np.array_equal(t[3].numpy()[:nrow], arrays[0][rows[:nrow]])
    assert np.array_equal(np.asarray(j[4]), t[4].numpy())
    assert_state_equal(j[5], t[5])
    # the padded rows zeroed row 0 in both; with exact rows the port
    # zeroes just those
    exact = twc.state_from_numpy(arrays)
    e = twc.flush_deltas_rows_compact(
        exact, torch.from_numpy(rows[:nrow].astype(np.int64)), nrow,
        cap=cap, divisor_ms=DIV, lateness_ms=LATE)
    assert_pairs_equal(j[:3], e[:3], cap)
    want = arrays[0].copy()
    want[rows[:nrow]] = 0
    assert np.array_equal(e[5].counts.numpy(), want)


def test_full_rows_and_all_zero_rows():
    C, W = 30, 8
    arrays = random_state(11, C, W, 0.5, watermark=250_000)
    rows = np.arange(C, dtype=np.int32)
    for counts in (arrays[0], np.zeros_like(arrays[0])):
        a = (counts,) + arrays[1:]
        jstate, tstate = both(a)
        j = jwc.flush_deltas_rows_compact(
            jstate, jnp.asarray(rows), jnp.int32(C), cap=64,
            divisor_ms=DIV, lateness_ms=LATE)
        t = twc.flush_deltas_rows_compact(
            tstate, torch.from_numpy(rows.astype(np.int64)), C, cap=64,
            divisor_ms=DIV, lateness_ms=LATE)
        assert_pairs_equal(j[:3], t[:3], 64)
        assert_state_equal(j[5], t[5])
        assert not t[5].counts.any()


@pytest.mark.parametrize("watermark", [0, 95_000, 412_345])
def test_free_slots_and_rows_zero_match_jax(watermark):
    arrays = random_state(watermark % 97, 20, 16, 0.3, watermark)
    jstate, tstate = both(arrays)
    assert_state_equal(
        jwc.flush_free_slots(jstate, divisor_ms=DIV, lateness_ms=LATE),
        twc.flush_free_slots(tstate, divisor_ms=DIV, lateness_ms=LATE))
    rows = np.array([0, 3, 19], np.int32)
    jstate, tstate = both(arrays)
    jw, js = jwc.flush_rows_zero(jstate, jnp.asarray(rows),
                                 divisor_ms=DIV, lateness_ms=LATE)
    tw, ts = twc.flush_rows_zero(tstate, torch.from_numpy(
        rows.astype(np.int64)), divisor_ms=DIV, lateness_ms=LATE)
    assert np.array_equal(np.asarray(jw), tw.numpy())
    assert_state_equal(js, ts)


# ----------------------------------------------------------------------
# engine drains


def write_journal(workdir, n, seed, n_campaigns=1000):
    """``n`` generator events at 10 ms spacing over ``n_campaigns``
    campaigns x 1 ad: ids, map, broker topic and the oracle's copy."""
    rng = random.Random(seed)
    campaigns = make_ids(n_campaigns, rng)
    ads = make_ids(n_campaigns, rng)
    gen.write_ids(campaigns, ads, workdir)
    gen.write_ad_mapping_file(campaigns, ads, workdir)
    src = gen.EventSource(ads=ads, user_ids=make_ids(50, rng),
                          page_ids=make_ids(50, rng), rng=rng)
    start = 1_700_000_000_000
    blob = "".join(src.event_at(start + 10 * i) + "\n"
                   for i in range(n)).encode()
    with open(os.path.join(workdir, gen.KAFKA_JSON_FILE), "wb") as f:
        f.write(blob)
    broker = FileBroker(os.path.join(workdir, "broker"))
    with broker.writer(TOPIC, append=False) as w:
        w.append_bytes(blob)
    mapping = gen.load_ad_mapping_file(
        os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE))
    return campaigns, mapping


OVERRIDES = dict(kafka_topic=TOPIC, jax_window_slots=64,
                 jax_scan_batches=1, jax_batch_size=1024)


def patch_thresholds(monkeypatch, rows_cap, compact_cap):
    """1,000 x 64 cells count as a large key space on both engines."""
    for cls in (JaxEngine, AdAnalyticsEngine):
        monkeypatch.setattr(cls, "COMPACT_DRAIN_MIN_CELLS", 1 << 12)
        monkeypatch.setattr(cls, "DIRTY_ROWS_CAP", rows_cap)
        monkeypatch.setattr(cls, "COMPACT_DRAIN_CAP", compact_cap)


def run_jax(workdir, campaigns, mapping):
    cfg = jax_default_config(**OVERRIDES)
    r = jax_as_redis(jax_make_store())
    jax_seed(r, campaigns)
    engine = JaxEngine(cfg, mapping, campaigns=campaigns, redis=r)
    assert engine._track_dirty_rows()
    with JaxBroker(os.path.join(workdir, "broker")).reader(TOPIC) as rd:
        JaxRunner(engine, rd).run_catchup()
    engine.close()
    return r


def run_port(workdir, campaigns, mapping, flush_interval_ms=None):
    cfg = default_config(**OVERRIDES)
    r = as_redis(make_store())
    seed_campaigns(r, campaigns)
    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns, redis=r,
                               device="cpu")
    assert engine._track_dirty_rows()
    with FileBroker(os.path.join(workdir, "broker")).reader(TOPIC) as rd:
        StreamRunner(engine, rd,
                     flush_interval_ms=flush_interval_ms).run_catchup()
    engine.close()
    return r, engine


@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("drains"))
    campaigns, mapping = write_journal(workdir, 30_000, seed=17)
    return workdir, campaigns, mapping


@pytest.mark.parametrize("card_gate", [False, True],
                         ids=["cpu_branches", "card_branches"])
# The port flushes after every journal block (~1,100 events): each drain
# then finds 632-663 touched rows, so a row cap of 645 sends about half
# of them to the full-space drain; ~700 nonzero cells overflow a cell cap
# of 64.  The JAX engine keeps its 1 s cadence: the totals must agree
# whatever the drains.
@pytest.mark.parametrize("rows_cap,compact_cap,overflows", [
    (1 << 17, 1 << 18, ()),
    (645, 1 << 18, ("rows",)),
    (1 << 17, 64, ("cells",)),
    (645, 64, ("rows", "cells")),
], ids=["under_caps", "rows_overflow", "cells_overflow", "both_overflow"])
def test_engine_drains_match_jax_engine(journal, monkeypatch, card_gate,
                                        rows_cap, compact_cap, overflows):
    workdir, campaigns, mapping = journal
    patch_thresholds(monkeypatch, rows_cap, compact_cap)
    want = jax_seen(run_jax(workdir, campaigns, mapping))
    if card_gate:
        monkeypatch.setattr(AdAnalyticsEngine, "_device_compacts",
                            lambda self: True)
    r, engine = run_port(workdir, campaigns, mapping, flush_interval_ms=0)
    assert read_seen_counts(r) == want
    assert sum(len(v) for v in want.values()) > 5_000
    stats = engine.drain_stats
    rows_tag = "rows_compact" if card_gate else "rows_host"
    full_tag = "compact" if card_gate else "dense"
    other = {"rows_host", "rows_compact", "compact", "dense"} - {
        rows_tag, full_tag}
    assert stats[rows_tag] > 0 and stats["free_slots"] > 0
    assert all(stats[t] == 0 for t in other), stats
    assert (stats[full_tag] > 0) == ("rows" in overflows), stats
    assert (stats["overflow"] > 0) == (
        card_gate and "cells" in overflows), stats
    logs = []
    correct, differ, missing = gen.check_correct(r, workdir,
                                                 log=logs.append)
    assert differ == 0 and missing == 0 and correct > 5_000, logs[:5]


def test_dirty_rows_are_what_the_batches_touched(journal, monkeypatch):
    """The host tracker notes exactly the joined campaigns of the folded
    rows; the drain after it leaves the counts all zero."""
    workdir, campaigns, mapping = journal
    patch_thresholds(monkeypatch, 1 << 17, 1 << 18)
    cfg = default_config(**OVERRIDES)
    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                               device="cpu")
    with FileBroker(os.path.join(workdir, "broker")).reader(TOPIC) as rd:
        lines = rd.poll(max_records=900)
    engine.process_chunk(lines)
    batch = engine.encoder.encode(lines, 1024)
    camp = engine._join_np[batch.ad_idx[:batch.n]]
    want = np.unique(camp[camp >= 0])
    assert np.array_equal(np.unique(np.concatenate(engine._dirty_rows)),
                          want)
    live = np.nonzero(engine.state.counts.numpy().any(axis=1))[0]
    assert set(live.tolist()) <= set(want.tolist())
    engine._drain_device()
    assert engine._dirty_rows == [] and not engine.state.counts.any()
    assert engine.drain_stats["rows_host"] == 1
