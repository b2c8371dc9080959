"""Sharded sketch engines: every sketch family over the ``(data, campaign)`` mesh.

The port of ``streambench_tpu/parallel/sketches.py``, the "sharded
sketch-merge allreduce" of BASELINE config #5.  Where JAX runs one
``shard_map`` program over the mesh, each rank here runs the same eager
fold on its own shard, as ``parallel/sharded.py`` does for the exact
count; every gather and sum goes through ``parallel/collectives.py``, so
a ``Recorder`` counts what the fold issues.

- **HLL** (``ShardedHLLEngine``): registers ``[Cl, W, R]`` sharded on the
  campaign axis.  The ``[B]`` batch columns are all-gathered over the
  data group and each campaign shard scatter-maxes every event of its
  own campaigns into its registers, so each campaign's registers have
  one owner and the merge is implicit.  The only reduction is one
  scalar sum of the counted rows over the campaign group (``dropped``).
  The HLL path runs no hand-written kernel (nor does the reference's).
- **Sliding + t-digest** (``ShardedSlidingTDigestEngine``): counts and
  per-campaign digests sharded on the campaign axis, merged by
  ownership.  The sliced fold counts each shard's ``[Cl*S, W]`` view of
  its lateness-class plane with K1 (``ops.count.count_cells``), where the
  reference scatter-adds; the unsliced fold keeps S torch scatters.  One
  scalar sum for all S memberships a batch.
- **Session + count-min** (``ShardedSessionCMSEngine``): per-user session
  rows sharded over the whole (flattened) mesh; the batch is replicated.
  Each shard sessionizes its users; each closed set becomes a per-shard
  count-min delta (K3's ``cms_update`` into a zero plane), summed over
  the mesh onto the replicated sketch; the closed rows are all-gathered
  so the replicated heavy-hitter ring updates identically everywhere,
  its query (K3's ``cms_query``) reading the MERGED table.  SALSA's plane
  does not sum, but its transition is a multiset homomorphism, so every
  rank folds the same gathered rows into its replicated plane (K3's
  ``cms_cols``).

Each fold has a per-batch arm (its collectives inside the loop, the
reference's measured baseline) and a hoisted arm, what the engines
dispatch: the stacked columns gather once a dispatch and the sums merge
once after the loop (integer sums are exact and linear, so deferring
them is bit-identical).  The hoisted session scan's loop issues no
collective: its ``[K, 2, D, Wd]`` delta stack, ``[K, 2, 3]`` counters
and closed rows merge in one collective each, and a collective-free
replay applies the 2K ring updates against the same evolving table
prefixes the per-batch arm saw.

The engines are drop-in subclasses of the single-device engines: the
same host loop, Redis writeback, checkpoint format (a snapshot holds the
whole unpadded state, so it restores into the unsharded engine and the
other way round) and CLI flags.  With more than one rank they take the
exact engine's single controller (``parallel.controller``).
"""

from __future__ import annotations

import numpy as np
import torch

from streambench_tpu_torch.config import BenchmarkConfig
from streambench_tpu_torch.engine.sketches import (
    LAT_BIN_MS,
    LAT_BINS,
    HLLDistinctEngine,
    SessionCMSEngine,
    SlidingTDigestEngine,
    _hist_rows,
)
from streambench_tpu_torch.io.redis_schema import RedisLike
from streambench_tpu_torch.ops import cms, hll, salsa, session, sliding
from streambench_tpu_torch.ops import tdigest
from streambench_tpu_torch.ops import windowcount as wc
from streambench_tpu_torch.ops.windowcount import NEG
from streambench_tpu_torch.parallel import collectives
from streambench_tpu_torch.parallel.controller import SingleController
from streambench_tpu_torch.parallel.mesh import CAMPAIGN_AXIS, DATA_AXIS, Mesh
from streambench_tpu_torch.parallel.sharded import (
    Axes,
    _shard_hist,
    check_mesh_device,
    data_axis_pad,
    data_slice,
    mesh_axes,
    pad_campaigns,
)

MESH_AXES = (DATA_AXIS, CAMPAIGN_AXIS)

_I32 = torch.int32


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=_I32, device=device)


# ----------------------------------------------------------------------
# shared helpers

def _gather_cols(cols, names, axes: Axes, recorder, in_loop: bool = False):
    """All-gather data-sharded columns over the data group along their
    LAST axis: the per-batch ``[b]`` form and the hoisted ``[K, b]`` stack
    share one spelling (ONE collective per column per dispatch)."""
    return tuple(collectives.all_gather_last(c, axes.gather, recorder,
                                             name=n, in_loop=in_loop)
                 for c, n in zip(cols, names))


def _batch_cols(cols, axes: Axes, recorder, *, packed: bool, extra=(),
                in_loop: bool = False):
    """Gather one dispatch's local columns and return them replicated and
    unpacked: ``(ad, *extra, etype, time, valid)``; ``extra`` names the
    columns between the ad and the type (HLL's user ids)."""
    if packed:
        word, *mid, tm = _gather_cols(
            cols, ("packed", *extra, "event_time"), axes, recorder, in_loop)
        ad, et, va = wc.unpack_columns(word)
        return (ad, *mid, et, tm, va)
    ad, *mid, et, tm, va = _gather_cols(
        cols, ("ad_idx", *extra, "event_type", "event_time", "valid"), axes,
        recorder, in_loop)
    return (ad, *mid, et, tm, va > 0)


def _shard_index(axes: Axes) -> int:
    """Linearized shard id over the flattened (data, campaign) mesh: the
    rank, as the grid is row-major."""
    return axes.index


def _globalize(closed: session.ClosedSessions, u0: int
               ) -> session.ClosedSessions:
    return closed._replace(
        user=torch.where(closed.valid, closed.user + u0, -1))


_CLOSED = ("user", "start", "end", "clicks", "valid")


def _gather_closed(closed: session.ClosedSessions, axes: Axes, recorder,
                   in_loop: bool = False) -> session.ClosedSessions:
    """All five closed-session columns, all-gathered over the whole mesh
    (5 collectives)."""
    g = [collectives.all_gather_last(getattr(closed, f), axes.world,
                                     recorder, name="closed_" + f,
                                     in_loop=in_loop) for f in _CLOSED]
    return session.ClosedSessions(*g[:4], g[4] > 0)


def _gather_closed3(closed: session.ClosedSessions, axes: Axes, recorder,
                    in_loop: bool = False):
    """Just the columns the SALSA absorb needs, (user, clicks, valid), over
    the whole mesh: 3 collectives against ``_gather_closed``'s 5."""
    gu, gc, gv = (collectives.all_gather_last(
        getattr(closed, f), axes.world, recorder, name="closed_" + f,
        in_loop=in_loop) for f in ("user", "clicks", "valid"))
    return gu, gc, gv > 0


def _cms_delta(shape, closed: session.ClosedSessions, table=None,
               total=None):
    """This shard's count-min delta of its closed sessions: K3's update
    into a zero ``[D, Wd]`` plane (or into the given zeroed slices)."""
    if table is None:
        table = torch.zeros(shape, dtype=_I32, device=closed.user.device)
        total = _zero(closed.user.device)
    cms.update(cms.CMSState(table, total), closed.user, closed.clicks,
               closed.valid)
    return table, total


def _cms_delta_psum(shape, closed: session.ClosedSessions, axes: Axes,
                    recorder, in_loop: bool = False):
    """The per-shard delta summed over the whole mesh — the sketch-merge
    allreduce (counter adds are linear, so summing per-shard deltas
    equals folding every closed session into one table)."""
    dt, dn = _cms_delta(shape, closed)
    return (collectives.all_reduce_sum(dt, axes.world, recorder,
                                       name="cms_delta", in_loop=in_loop),
            collectives.all_reduce_sum(dn, axes.world, recorder,
                                       name="cms_total", in_loop=in_loop))


def _psum(x, axes: Axes, recorder, name: str, in_loop: bool = False):
    return collectives.all_reduce_sum(x, axes.world, recorder, name=name,
                                      in_loop=in_loop)


def _det_bin(now_rel: int, event_time, valid) -> torch.Tensor:
    """The latency bin of the closures one batch decided: the stamp less
    the batch's newest event time, in int32 (an all-invalid batch wraps
    and has no closures)."""
    newest = torch.where(valid, event_time, NEG).max()
    lat = torch.clamp(now_rel - newest, min=0)
    return torch.clamp(torch.div(lat, LAT_BIN_MS, rounding_mode="floor"),
                       0, LAT_BINS - 1)


def _add_bin(hist, det_bin, n) -> torch.Tensor:
    hist.index_add_(0, det_bin.reshape(1).to(torch.int64), n.reshape(1))
    return hist


# ----------------------------------------------------------------------
# sharded HLL: campaign-sharded registers [Cl, W, R]

def _hll_fold_local(registers, window_ids, watermark, join_table,
                    ad, user, et, tm, v, axes: Axes, *, divisor_ms: int,
                    lateness_ms: int, view_type: int, stats: bool = False):
    """The collective-free HLL fold over already-replicated columns, the
    registers updated in place.  Returns ``(registers, ids, wm, wanted_n,
    counted_local)``, plus the ``[S]`` (wanted, routed) histograms with
    ``stats``; the caller sums ``counted_local`` over the campaign group,
    per batch or once per dispatch."""
    Cl, W, R = registers.shape
    p = R.bit_length() - 1

    campaign = wc.gather_rows(join_table, ad)
    wid = torch.div(tm, divisor_ms, rounding_mode="floor")
    wanted = v & (et == view_type) & (campaign >= 0)
    # the gathered columns are replicated: every rank computes the same
    # claims and watermark with no further collective
    slot, count_mask, new_ids, new_wm = wc.assign_windows(
        window_ids, watermark, wid, wanted, v, tm, divisor_ms=divisor_ms,
        lateness_ms=lateness_ms)
    # keyed state without moving state: this shard owns [c0, c0 + Cl)
    local_c = campaign - axes.c0
    in_shard = count_mask & (local_c >= 0) & (local_c < Cl)

    h = hll.splitmix32(user)
    j = h & (R - 1)
    rank = hll._rank(h, p)
    # rows that do not count raise register j of row 0 by 0: a no-op
    flat = torch.where(in_shard, (local_c.to(torch.int64) * W + slot) * R
                       + j, j)
    value = torch.where(in_shard, rank, 0).to(registers.dtype)
    registers.view(-1).scatter_reduce_(0, flat, value, "amax",
                                       include_self=True)
    out = (registers, new_ids, new_wm, wanted.sum(dtype=_I32),
           in_shard.sum(dtype=_I32))
    if not stats:
        return out
    return out + (_shard_hist(campaign, wanted, Cl, axes.shards),
                  _shard_hist(campaign, count_mask, Cl, axes.shards))


def hll_fold_step(state: hll.HLLState, join_table, cols, axes: Axes, *,
                  packed: bool, divisor_ms: int = 10_000,
                  lateness_ms: int = 60_000, view_type: int = 0,
                  stats: bool = False, recorder=None,
                  in_loop: bool = False) -> tuple:
    """Fold one batch of this rank's LOCAL columns (``(packed, user,
    time)`` or ``(ad, user, etype, time, valid)``, each ``[b]``) into
    ``state``.  Returns ``(registers, ids, wm, dropped)``, plus the
    ``[S]`` histograms with ``stats``."""
    ad, user, et, tm, v = _batch_cols(cols, axes, recorder, packed=packed,
                                      extra=("user_idx",), in_loop=in_loop)
    regs, ids, wm, wn, cl, *hist = _hll_fold_local(
        state.registers, state.window_ids, state.watermark, join_table,
        ad, user, et, tm, v, axes, divisor_ms=divisor_ms,
        lateness_ms=lateness_ms, view_type=view_type, stats=stats)
    counted = collectives.all_reduce_sum(cl, axes.campaign, recorder,
                                         name="counted", in_loop=in_loop)
    return (regs, ids, wm, state.dropped + wn - counted, *hist)


def hll_fold_scan(state: hll.HLLState, join_table, stacks, axes: Axes, *,
                  packed: bool, hoist: bool = True,
                  divisor_ms: int = 10_000, lateness_ms: int = 60_000,
                  view_type: int = 0, stats: bool = False,
                  recorder=None) -> tuple:
    """Fold ``[K, b]`` local stacks, one batch a row.  ``hoist=True`` (what
    the engine dispatches) gathers each stack once and sums the counted
    rows once after the loop: (cols + 1) collectives a dispatch instead
    of K * (cols + 1).  ``stats`` rides the hoisted arm only."""
    kw = dict(divisor_ms=divisor_ms, lateness_ms=lateness_ms,
              view_type=view_type)
    K = stacks[0].shape[0]
    if not hoist:
        if stats:
            raise ValueError("shard stats ride the hoisted scan only")
        out = tuple(state)
        for k in range(K):
            out = hll_fold_step(hll.HLLState(*out), join_table,
                                [s[k] for s in stacks], axes, packed=packed,
                                recorder=recorder, in_loop=True, **kw)
        return out
    ad, user, et, tm, v = _batch_cols(stacks, axes, recorder, packed=packed,
                                      extra=("user_idx",))
    regs, ids, wm = state.registers, state.window_ids, state.watermark
    wanted_n = counted_local = _zero(regs.device)
    hists = None
    for k in range(K):
        regs, ids, wm, wn, cl, *hist = _hll_fold_local(
            regs, ids, wm, join_table, ad[k], user[k], et[k], tm[k], v[k],
            axes, stats=stats, **kw)
        wanted_n = wanted_n + wn
        counted_local = counted_local + cl
        if stats:
            hists = hist if hists is None else [a + b for a, b in
                                                zip(hists, hist)]
    counted = collectives.all_reduce_sum(counted_local, axes.campaign,
                                         recorder, name="counted")
    out = (regs, ids, wm, state.dropped + wanted_n - counted)
    return out + tuple(hists) if stats else out


def sharded_hll_step(mesh: Mesh, state: hll.HLLState, join_table,
                     ad_idx, user_idx, event_type, event_time, valid,
                     **kw) -> hll.HLLState:
    """Fold one GLOBAL micro-batch into this rank's campaign-sharded HLL
    state: every rank passes the whole batch (``B`` a multiple of the
    data axis: ``pad_data_cols``) and folds its data slice."""
    cols = [data_slice(mesh, torch.as_tensor(c, device=mesh.device))
            for c in (ad_idx, user_idx, event_type, event_time, valid)]
    axes = mesh_axes(mesh, state.registers.shape[0]
                     * mesh.shape[CAMPAIGN_AXIS])
    return hll.HLLState(*hll_fold_step(state, join_table, cols, axes,
                                       packed=False, **kw))


def sharded_hll_init(num_campaigns: int, window_slots: int, mesh: Mesh,
                     num_registers: int = 128) -> hll.HLLState:
    """This rank's initial state: its ``[Cl, W, R]`` register shard of the
    padded key space, and the replicated ring, watermark and drops."""
    cl = pad_campaigns(num_campaigns, mesh) // mesh.shape[CAMPAIGN_AXIS]
    return hll.init_state(cl, window_slots, num_registers=num_registers,
                          device=mesh.device)


# ----------------------------------------------------------------------
# sharded sliding windows + t-digest: campaign-sharded counts and digests

def _sliding_digest_local(means, weights, now_rel: int, local_c, tm, dmask,
                          Cl: int, hist):
    """The digest half of every sharded sliding fold: the step form
    compresses the batch into the digest, the scan form folds the O(B)
    histogram only (one absorb a dispatch)."""
    lat = torch.clamp(now_rel - tm, min=0)
    if hist is None:
        dg = tdigest.update(tdigest.TDigestState(means, weights), local_c,
                            lat, dmask)
        return dg.means, dg.weights, None
    w = torch.where(dmask, 1.0, 0.0)
    return means, weights, tdigest.fold_hist(hist[0], hist[1], local_c,
                                             lat, w, Cl)


def _sliding_fold_local(counts, window_ids, watermark, join_table, ad, et,
                        tm, v, axes: Axes, *, size_ms: int, slide_ms: int,
                        lateness_ms: int, view_type: int, sliced: bool,
                        method: str):
    """The collective-free sliding fold over ALREADY-REPLICATED columns.

    Unsliced: S ring claims, each a torch scatter into the shard's
    ``[Cl, W]`` counts.  Sliced: one claim on per-slide buckets and one
    count of rows ``local_c * S + d`` (masked to this shard's campaigns)
    into the ``[Cl*S, W]`` view of the lateness-class plane, K1 with
    ``method="kernel"``; an accepted event owns d + 1 memberships,
    counted on its owner shard only.  Each campaign's counts and digest
    have one writer, so the merge is ownership.  Returns ``(counts, ids,
    wm, wanted_n, counted_local, local_c, digest mask)``."""
    late_eff = sliding.effective_lateness(size_ms, slide_ms, lateness_ms)
    campaign = wc.gather_rows(join_table, ad)
    wanted = v & (et == view_type) & (campaign >= 0)
    Cl = counts.shape[0]
    local_c = campaign - axes.c0
    shard_mask = (local_c >= 0) & (local_c < Cl)
    wanted_n = wanted.sum(dtype=_I32)
    if sliced:
        _, S, W = counts.shape
        bid = torch.div(tm, slide_ms, rounding_mode="floor")
        slot, count_mask, ids, new_wm = wc.assign_windows(
            window_ids, watermark, bid, wanted, v, tm, divisor_ms=slide_ms,
            lateness_ms=late_eff)
        # the lateness class against the batch-start watermark
        min_open = torch.clamp(torch.div(watermark - late_eff, slide_ms,
                                         rounding_mode="floor"), min=0)
        d = torch.clamp(bid - min_open, 0, S - 1)
        in_shard = count_mask & shard_mask
        wc.apply_count(counts.view(Cl * S, W), local_c * S + d, slot,
                       in_shard, method)
        counted = torch.where(in_shard, d + 1, 0).sum(dtype=_I32)
    else:
        S = size_ms // slide_ms
        base_wid = torch.div(tm, slide_ms, rounding_mode="floor")
        ids, new_wm = window_ids, watermark
        counted = _zero(counts.device)
        for k in range(S):
            slot, count_mask, ids, new_wm = wc.assign_windows(
                ids, watermark, base_wid - k, wanted, v, tm,
                divisor_ms=slide_ms, lateness_ms=late_eff)
            in_shard = count_mask & shard_mask
            wc.apply_count(counts, local_c, slot, in_shard, "scatter")
            counted = counted + in_shard.sum(dtype=_I32)
    return (counts, ids, new_wm, wanted_n, counted, local_c,
            wanted & shard_mask)


def sliding_fold_step(state, means, weights, join_table, now_rel: int, cols,
                      axes: Axes, *, packed: bool, sliced: bool,
                      size_ms: int = 10_000, slide_ms: int = 1_000,
                      lateness_ms: int = 60_000, view_type: int = 0,
                      method: str = "scatter", recorder=None,
                      in_loop: bool = False, hist=None) -> tuple:
    """Fold one batch of this rank's LOCAL columns: gather, the local
    fold, ONE scalar sum for all S memberships.  Returns ``(counts, ids,
    wm, dropped, means, weights)``, plus the histogram with ``hist``."""
    S = size_ms // slide_ms
    ad, et, tm, v = _batch_cols(cols, axes, recorder, packed=packed,
                                in_loop=in_loop)
    counts, ids, wm, wn, cl, local_c, dmask = _sliding_fold_local(
        state.counts, state.window_ids, state.watermark, join_table, ad, et,
        tm, v, axes, size_ms=size_ms, slide_ms=slide_ms,
        lateness_ms=lateness_ms, view_type=view_type, sliced=sliced,
        method=method)
    means, weights, h = _sliding_digest_local(
        means, weights, now_rel, local_c, tm, dmask, counts.shape[0], hist)
    counted = collectives.all_reduce_sum(cl, axes.campaign, recorder,
                                         name="counted", in_loop=in_loop)
    out = (counts, ids, wm, state.dropped + S * wn - counted, means,
           weights)
    return out if hist is None else out + (h,)


def sliding_fold_scan(state, means, weights, join_table, now_rel: int,
                      stacks, axes: Axes, *, packed: bool, sliced: bool,
                      hoist: bool = True, size_ms: int = 10_000,
                      slide_ms: int = 1_000, lateness_ms: int = 60_000,
                      view_type: int = 0, method: str = "scatter",
                      recorder=None) -> tuple:
    """Fold ``[K, b]`` local stacks, the latency samples into a histogram
    absorbed once after the loop.  ``hoist=True`` gathers the stacks once
    and sums the memberships once: (cols + 1) collectives a dispatch
    instead of K * (cols + 1)."""
    S = size_ms // slide_ms
    kw = dict(size_ms=size_ms, slide_ms=slide_ms, lateness_ms=lateness_ms,
              view_type=view_type, sliced=sliced, method=method)
    K = stacks[0].shape[0]
    Cl = state.counts.shape[0]
    hist = tdigest.hist_init(Cl, device=means.device)
    st_cls = type(state)
    if not hoist:
        out = tuple(state)
        for k in range(K):
            *out, _, _, hist = sliding_fold_step(
                st_cls(*out), means, weights, join_table, now_rel,
                [s[k] for s in stacks], axes, packed=packed,
                recorder=recorder, in_loop=True, hist=hist, **kw)
        counts, ids, wm, dropped = out
    else:
        ad, et, tm, v = _batch_cols(stacks, axes, recorder, packed=packed)
        counts, ids, wm = state.counts, state.window_ids, state.watermark
        wanted_n = counted_local = _zero(counts.device)
        for k in range(K):
            counts, ids, wm, wn, cl, local_c, dmask = _sliding_fold_local(
                counts, ids, wm, join_table, ad[k], et[k], tm[k], v[k],
                axes, **kw)
            _, _, hist = _sliding_digest_local(means, weights, now_rel,
                                               local_c, tm[k], dmask, Cl,
                                               hist)
            wanted_n = wanted_n + wn
            counted_local = counted_local + cl
        counted = collectives.all_reduce_sum(counted_local, axes.campaign,
                                             recorder, name="counted")
        dropped = state.dropped + S * wanted_n - counted
    # one compress a dispatch: the loop stays O(B) scatters
    dg = tdigest.absorb_hist(tdigest.TDigestState(means, weights), *hist)
    return counts, ids, wm, dropped, dg.means, dg.weights


# ----------------------------------------------------------------------
# sharded session windows + count-min: user-sharded over the whole mesh

def _session_local(lt, ss, ck, wm, dr, now_rel: int, user_idx, et, tm,
                   valid, axes: Axes, *, gap_ms: int, lateness_ms: int,
                   user_capacity: int):
    """One batch through this shard's users: the session step on the
    replicated batch masked to users ``[u0, u0 + Ul)``, and the GLOBAL
    facts recomputed from the replicated batch (the local step saw only
    this shard's events): the watermark, the drops (late against the
    batch-start watermark, or past the global capacity) and the closure
    latency bin.  Returns ``((lt, ss, ck), wm, dropped, det_bin, (closed
    in batch, closed carry))`` with global user ids."""
    Ul = lt.shape[0]
    u0 = _shard_index(axes) * Ul
    lu = user_idx - u0
    v = valid & (lu >= 0) & (lu < Ul)
    local = session.SessionState(lt, ss, ck, wm, _zero(lt.device))
    st, closed_in, closed_carry = session.step(
        local, torch.where(v, lu, -1), et, tm, v, gap_ms=gap_ms,
        lateness_ms=lateness_ms)
    batch_max = torch.where(valid, tm, NEG).max()
    new_wm = torch.maximum(wm, batch_max)
    ok = (valid & (tm >= wm - lateness_ms) & (user_idx >= 0)
          & (user_idx < user_capacity))
    new_dr = dr + (valid.sum(dtype=_I32) - ok.sum(dtype=_I32))
    return ((st.last_time, st.sess_start, st.clicks), new_wm, new_dr,
            _det_bin(now_rel, tm, valid),
            (_globalize(closed_in, u0), _globalize(closed_carry, u0)))


def _closed_counts(closed: session.ClosedSessions):
    return (closed.valid.sum(dtype=_I32),
            torch.where(closed.valid, closed.clicks, 0).sum(dtype=_I32))


def session_fold_step(carry: tuple, now_rel: int, cols, axes: Axes, *,
                      salsa_plane: bool, gap_ms: int, lateness_ms: int,
                      user_capacity: int, recorder=None,
                      in_loop: bool = False) -> tuple:
    """One replicated batch ``(user, etype, time, valid)`` folded into this
    shard's users and the replicated sketch and ring, absorbing in the
    single-device engine's order: in-batch closures, then carried ones.
    ``carry`` is the reference's: ``(last_time, sess_start, clicks,
    watermark, dropped, *sketch, ring_keys, ring_ests, closed_n, clicks_n,
    lat_hist)``, the sketch ``(table, total)`` (fixed) or ``(table, m1,
    m2, total)`` (SALSA); the table is updated in place.

    Fixed: per closed set, the delta sum (table and total), five gathers
    of the closed rows for the ring, and the closed-count and click sums:
    9 collectives, 18 a batch.  SALSA: three gathers a closed set, every
    rank folding the gathered rows into its replicated plane; the
    counters fall out of the same rows: 6 a batch."""
    u, e, t, v = cols
    lt, ss, ck, wm, dr, *sk, tkk, tke, cn, cl, hist = carry
    (lt, ss, ck), wm, dr, det_bin, groups = _session_local(
        lt, ss, ck, wm, dr, now_rel, u, e, t, v, axes, gap_ms=gap_ms,
        lateness_ms=lateness_ms, user_capacity=user_capacity)
    topk = cms.TopKState(tkk, tke)
    kw = dict(in_loop=in_loop)
    for closed in groups:
        if salsa_plane:
            gu, gc, gv = _gather_closed3(closed, axes, recorder, **kw)
            state = salsa.update(salsa.SalsaState(*sk), gu, gc, gv)
            sk = list(state)
            topk = cms.update_topk(state, topk, gu, gv)
            n = gv.sum(dtype=_I32)
            clicks = torch.where(gv, gc, 0).sum(dtype=_I32)
        else:
            dt, dn = _cms_delta_psum(sk[0].shape, closed, axes, recorder,
                                     **kw)
            sk = [sk[0].add_(dt), sk[1] + dn]
            g = _gather_closed(closed, axes, recorder, **kw)
            topk = cms.update_topk(cms.CMSState(*sk), topk, g.user, g.valid)
            n0, c0 = _closed_counts(closed)
            n = _psum(n0, axes, recorder, "closed_n", **kw)
            clicks = _psum(c0, axes, recorder, "clicks_n", **kw)
        cn = cn + n
        cl = cl + clicks
        hist = _add_bin(hist, det_bin, n)
    return (lt, ss, ck, wm, dr, *sk, topk.keys, topk.ests, cn, cl, hist)


def session_fold_scan(carry: tuple, now_rel: int, stacks, axes: Axes, *,
                      salsa_plane: bool, hoist: bool = True, gap_ms: int,
                      lateness_ms: int, user_capacity: int,
                      recorder=None) -> tuple:
    """Fold ``[K, B]`` replicated stacks.  ``hoist=False`` keeps each
    batch's collectives (``session_fold_step`` K times).  ``hoist=True``
    (what the engine dispatches) issues none inside the loop: each batch's
    per-shard deltas (into a zeroed ``[K, 2, D, Wd]`` stack, K3's update),
    closed rows and counters are stacked, merged after the loop in one
    collective each (fixed: the delta sum, the counter sum and two
    gathers, user and valid; SALSA: three gathers), and a collective-free
    replay applies the 2K ring updates against the same evolving sketch
    prefixes the per-batch arm saw."""
    kw = dict(gap_ms=gap_ms, lateness_ms=lateness_ms,
              user_capacity=user_capacity)
    K = stacks[0].shape[0]
    if not hoist:
        for k in range(K):
            carry = session_fold_step(carry, now_rel, [s[k] for s in stacks],
                                      axes, salsa_plane=salsa_plane,
                                      recorder=recorder, in_loop=True, **kw)
        return carry
    lt, ss, ck, wm, dr, *sk, tkk, tke, cn, cl, hist = carry
    dev = lt.device
    B = stacks[0].shape[1]
    c_user = torch.empty((K, 2, B), dtype=_I32, device=dev)
    c_clicks = torch.empty_like(c_user)
    c_valid = torch.empty((K, 2, B), dtype=torch.bool, device=dev)
    det_bins = torch.empty(K, dtype=torch.int64, device=dev)
    if not salsa_plane:
        D, Wd = sk[0].shape
        d_tab = torch.zeros((K, 2, D, Wd), dtype=_I32, device=dev)
        d_tot = torch.zeros((K, 2), dtype=_I32, device=dev)
        counts = torch.zeros((K, 2, 2), dtype=_I32, device=dev)
    for k in range(K):
        (lt, ss, ck), wm, dr, det_bins[k], groups = _session_local(
            lt, ss, ck, wm, dr, now_rel, *(s[k] for s in stacks), axes,
            **kw)
        for g, closed in enumerate(groups):
            c_user[k, g] = closed.user
            c_valid[k, g] = closed.valid
            if salsa_plane:
                c_clicks[k, g] = closed.clicks
            else:
                _cms_delta(None, closed, d_tab[k, g], d_tot[k, g])
                counts[k, g] = torch.stack(_closed_counts(closed))
    # the deferred merges, one collective each
    gather = lambda x, name: collectives.all_gather_last(  # noqa: E731
        x, axes.world, recorder, name=name)
    c_user = gather(c_user, "closed_user").reshape(2 * K, -1)
    c_valid = (gather(c_valid, "closed_valid") > 0).reshape(2 * K, -1)
    if salsa_plane:
        c_clicks = gather(c_clicks, "closed_clicks").reshape(2 * K, -1)
    else:
        d_tab = _psum(d_tab, axes, recorder, "cms_delta").reshape(
            (2 * K, D, Wd))
        scalars = _psum(torch.cat([d_tot[..., None], counts], -1), axes,
                        recorder, "counters").reshape(2 * K, 3)
    bins = det_bins.repeat_interleave(2)
    topk = cms.TopKState(tkk, tke)
    # the collective-free replay: every closure against the same
    # evolving sketch the per-batch arm used
    for i in range(2 * K):
        gu, gv = c_user[i], c_valid[i]
        if salsa_plane:
            gc = c_clicks[i]
            state = salsa.update(salsa.SalsaState(*sk), gu, gc, gv)
            sk = list(state)
            n = gv.sum(dtype=_I32)
            clicks = torch.where(gv, gc, 0).sum(dtype=_I32)
        else:
            sk = [sk[0].add_(d_tab[i]), sk[1] + scalars[i, 0]]
            state = cms.CMSState(*sk)
            n, clicks = scalars[i, 1], scalars[i, 2]
        topk = cms.update_topk(state, topk, gu, gv)
        cn = cn + n
        cl = cl + clicks
        hist = _add_bin(hist, bins[i], n)
    return (lt, ss, ck, wm, dr, *sk, topk.keys, topk.ests, cn, cl, hist)


def session_fold_flush(carry: tuple, now_rel: int, axes: Axes, *,
                       salsa_plane: bool, gap_ms: int, lateness_ms: int,
                       force: bool, recorder=None) -> tuple:
    """Close this shard's sessions the watermark has passed (all of them
    with ``force``) into the replicated sketch and ring.  Time-expired
    closures add their per-row due latency to the histogram (forced ones
    at close are cut early and carry none).  Fixed: the delta sum, five
    gathers, two counter sums and the histogram sum; SALSA: three
    gathers, and the end times' gather for the latencies."""
    lt, ss, ck, wm, dr, *sk, tkk, tke, cn, cl, hist = carry
    u0 = _shard_index(axes) * lt.shape[0]
    st, expired = session.flush(session.SessionState(lt, ss, ck, wm, dr),
                                gap_ms=gap_ms, lateness_ms=lateness_ms,
                                force=force)
    closed = _globalize(expired, u0)
    topk = cms.TopKState(tkk, tke)
    if salsa_plane:
        gu, gc, gv = _gather_closed3(closed, axes, recorder)
        state = salsa.update(salsa.SalsaState(*sk), gu, gc, gv)
        sk = list(state)
        topk = cms.update_topk(state, topk, gu, gv)
        cn = cn + gv.sum(dtype=_I32)
        cl = cl + torch.where(gv, gc, 0).sum(dtype=_I32)
        if not force:
            gend = collectives.all_gather_last(expired.end, axes.world,
                                               recorder, name="closed_end")
            hist = _hist_rows(hist, torch.clamp(
                now_rel - (gend + (gap_ms + lateness_ms)), min=0), gv)
    else:
        dt, dn = _cms_delta_psum(sk[0].shape, closed, axes, recorder)
        sk = [sk[0].add_(dt), sk[1] + dn]
        g = _gather_closed(closed, axes, recorder)
        topk = cms.update_topk(cms.CMSState(*sk), topk, g.user, g.valid)
        n0, c0 = _closed_counts(closed)
        cn = cn + _psum(n0, axes, recorder, "closed_n")
        cl = cl + _psum(c0, axes, recorder, "clicks_n")
        if not force:
            due = expired.end + (gap_ms + lateness_ms)
            delta = _hist_rows(torch.zeros(LAT_BINS, dtype=_I32,
                                           device=lt.device),
                               torch.clamp(now_rel - due, min=0),
                               expired.valid)
            hist = hist + _psum(delta, axes, recorder, "lat_hist")
    return (st.last_time, st.sess_start, st.clicks, st.watermark,
            st.dropped, *sk, topk.keys, topk.ests, cn, cl, hist)


# ----------------------------------------------------------------------
# the engines

def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` zero-padded along dim 0 to ``n`` rows."""
    if a.shape[0] >= n:
        return a
    return np.pad(a, ((0, n - a.shape[0]),) + ((0, 0),) * (a.ndim - 1))


def _campaign_shards(arrays: list, c_pad: int, nc: int):
    """``per_rank`` pieces of campaign-sharded host arrays: rank ``r``
    takes rows ``[c0, c0 + Cl)`` of each, padded to ``c_pad``."""
    arrays = [_pad_rows(np.asarray(a), c_pad) for a in arrays]
    cl = c_pad // nc

    def shard(r: int) -> list:
        c0 = (r % nc) * cl          # the grid is row-major
        return [np.ascontiguousarray(a[c0:c0 + cl]) for a in arrays]
    return shard


def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(int(v), dtype=_I32, device=device)


class _CampaignSharded(SingleController):
    """What the campaign-sharded sketch engines share: the mesh geometry,
    the host clock every fold call carries, and gathering shards."""

    def _init_campaign_mesh(self, mesh: Mesh) -> None:
        self._init_controller(mesh)
        self._data_pad = data_axis_pad(self.batch_size, mesh)
        num = self.encoder.num_campaigns
        self._c_pad = pad_campaigns(num, mesh)
        self._axes = mesh_axes(mesh, num)

    def _fold_args(self) -> tuple:
        return (self._now_rel(),)

    def _gather_campaigns(self, block: torch.Tensor) -> torch.Tensor:
        """The whole ``[C, ...]`` block of a campaign-sharded tensor, its
        padding cut off (every rank of the campaign group gathers)."""
        full = self._gather_rows(block, self.mesh.campaign_group)
        return full[:self.encoder.num_campaigns]


class ShardedHLLEngine(_CampaignSharded, HLLDistinctEngine):
    """HLL distinct-user engine with registers sharded on the campaign
    axis of a ``(data, campaign)`` mesh.

    Config #5's multi-tenant scale makes replicated registers impossible
    (``[1e6, W, R]`` is GBs); one campaign shard a device is how it
    fits, as the exact engine shards its ``[C, W]`` counts.  The flush
    (estimate + zero closed slots) is elementwise over campaigns, so each
    rank flushes its shard and the estimates gather to rank 0.  The step
    packs the wire word where it can (3 gathers a batch instead of 5)."""

    STEP_PACKS = True

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 mesh: Mesh, campaigns: list[str] | None = None,
                 redis: RedisLike | None = None, registers: int = 128,
                 device: torch.device | str | None = None):
        check_mesh_device(mesh, device)
        super().__init__(cfg, ad_to_campaign, campaigns=campaigns,
                         redis=redis, registers=registers,
                         device=mesh.device)
        self._init_campaign_mesh(mesh)
        self.state = sharded_hll_init(self.encoder.num_campaigns, self.W,
                                      mesh, num_registers=registers)
        self._fold_kw = dict(divisor_ms=self.divisor,
                             lateness_ms=self.lateness, view_type=0)

    def _step_local(self, local: list, packed: bool, now_rel=0) -> None:
        out = hll_fold_step(self.state, self.join_table, local, self._axes,
                            packed=packed, stats=self._stats_on(),
                            recorder=self._recorder, **self._fold_kw)
        self.state = hll.HLLState(*self._note_shard(out))

    def _scan_local(self, local: list, packed: bool, now_rel=0) -> None:
        out = hll_fold_scan(self.state, self.join_table, local, self._axes,
                            packed=packed, hoist=True, stats=self._stats_on(),
                            recorder=self._recorder, **self._fold_kw)
        self.state = hll.HLLState(*self._note_shard(out))

    def _fold_args(self) -> tuple:
        return ()

    def _drain_device(self) -> None:
        self._command("drain")
        self._span_start = self._oldest_open_span_start()

    def _do_drain(self) -> None:
        """Each rank flushes its shard; rank 0 parks the whole estimate
        block (the data row 0 gathers it)."""
        est, wids, self.state = hll.flush(
            self.state, divisor_ms=self.divisor, lateness_ms=self.lateness)
        if self.mesh.data_index == 0:
            est = self._gather_campaigns(est)
            if not self._follows:
                self._park(("hll", est, wids))

    def snapshot(self, offset):
        shard = self.state
        self.state = self._command("gather_state")
        try:
            return super().snapshot(offset)
        finally:
            self.state = shard

    def _do_gather_state(self):
        regs = None
        if self.mesh.data_index == 0:
            regs = self._gather_campaigns(self.state.registers)
        return None if self._follows else self.state._replace(registers=regs)

    def restore(self, snap) -> None:
        """The single-device restore (which accepts an unsharded
        snapshot), then each rank takes its shard of the registers."""
        super().restore(snap)
        st = self.state
        shard = _campaign_shards([st.registers.cpu().numpy()], self._c_pad,
                                 self.mesh.shape[CAMPAIGN_AXIS])
        rest = (st.window_ids.cpu().numpy(), int(st.watermark),
                int(st.dropped))
        self._command("put_state", per_rank=lambda r: (*shard(r), *rest))

    def _do_put_state(self, regs, window_ids, watermark, dropped) -> None:
        dev = self.device
        self.state = hll.HLLState(
            torch.from_numpy(regs).to(dev),
            torch.from_numpy(np.asarray(window_ids, np.int32)).to(dev),
            _scalar(watermark, dev), _scalar(dropped, dev))


class ShardedSlidingTDigestEngine(_CampaignSharded, SlidingTDigestEngine):
    """Sliding-window counts + per-campaign latency t-digest with both the
    counts and the digests sharded on the campaign axis.

    Counts merge as the exact engine's (ownership + an in-place count, K1
    on the sliced plane); digests by ownership: each campaign's centroids
    live on one shard, so the cross-partition "unifier" is the batch
    all-gather, and reading quantiles gathers the ``[C, K]`` centroid
    block to rank 0.  Drains are whole-shard (the sliced plane's windowed
    sum, or the unsliced counts' deltas) gathered to rank 0."""

    # a digest re-compressed by an all-invalid dispatch may move its
    # centroids: the report puts it back
    REPORT_RESTORES = ("state", "digest")

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 mesh: Mesh, campaigns: list[str] | None = None,
                 redis: RedisLike | None = None,
                 size_ms: int | None = None, slide_ms: int = 1_000,
                 window_slots: int | None = None, compression: int = 64,
                 sliced: str | None = None, method: str | None = None,
                 device: torch.device | str | None = None):
        check_mesh_device(mesh, device)
        super().__init__(cfg, ad_to_campaign, campaigns=campaigns,
                         redis=redis, size_ms=size_ms, slide_ms=slide_ms,
                         window_slots=window_slots, compression=compression,
                         sliced=sliced, method=method, device=mesh.device)
        self._init_campaign_mesh(mesh)
        cl = self._c_pad // mesh.shape[CAMPAIGN_AXIS]
        S = self.size_ms // self.slide_ms
        self.state = (sliding.init_sliced(cl, self.W, S, device=mesh.device)
                      if self.sliced
                      else wc.init_state(cl, self.W, device=mesh.device))
        self.digest = tdigest.init_state(cl, compression=compression,
                                         device=mesh.device)

    def _place(self) -> None:
        """Every rank takes its shard of the (whole, unpadded) state and
        digest rank 0 holds (a restore)."""
        shard = _campaign_shards(
            [self.state.counts.cpu().numpy(),
             self.digest.means.cpu().numpy(),
             self.digest.weights.cpu().numpy()], self._c_pad,
            self.mesh.shape[CAMPAIGN_AXIS])
        st = self.state
        rest = (st.window_ids.cpu().numpy(), int(st.watermark),
                int(st.dropped))
        self._command("put_state", per_rank=lambda r: (*shard(r), *rest))

    def _do_put_state(self, counts, means, weights, window_ids, watermark,
                      dropped) -> None:
        dev = self.device
        T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731,E501
        self.state = type(self.state)(
            T(counts), T(np.asarray(window_ids, np.int32)),
            _scalar(watermark, dev), _scalar(dropped, dev))
        self.digest = tdigest.TDigestState(T(means), T(weights))

    def _fold_kw(self) -> dict:
        return dict(size_ms=self.size_ms, slide_ms=self.slide_ms,
                    lateness_ms=self.base_lateness, method=self.method,
                    sliced=self.sliced)

    def _step_local(self, local: list, packed: bool, now_rel: int) -> None:
        out = sliding_fold_step(self.state, *self.digest, self.join_table,
                                now_rel, local, self._axes, packed=packed,
                                recorder=self._recorder, **self._fold_kw())
        self._uncarry(out)

    def _scan_local(self, local: list, packed: bool, now_rel: int) -> None:
        out = sliding_fold_scan(self.state, *self.digest, self.join_table,
                                now_rel, local, self._axes, packed=packed,
                                hoist=True, recorder=self._recorder,
                                **self._fold_kw())
        self._uncarry(out)

    def _uncarry(self, out) -> None:
        counts, ids, wm, dr, means, weights = out
        self.state = type(self.state)(counts, ids, wm, dr)
        self.digest = tdigest.TDigestState(means, weights)

    def _track_dirty_rows(self) -> bool:
        return False

    def _drain_device(self) -> None:
        self._command("drain")
        self._span_start = None

    def _do_drain(self) -> None:
        """Each rank drains its shard (the sliced plane's windowed sum, or
        the counts' deltas); rank 0 parks the whole block."""
        if self.sliced:
            deltas, wids, self.state = sliding.flush_sliced(
                self.state, size_ms=self.size_ms, slide_ms=self.slide_ms,
                lateness_ms=self.base_lateness)
        else:
            deltas, wids, self.state = wc.flush_deltas(
                self.state, divisor_ms=self.divisor,
                lateness_ms=self.lateness)
        if self.mesh.data_index == 0:
            deltas = self._gather_campaigns(deltas)
            if not self._follows:
                self._park(("dense", deltas, wids))

    def _whole(self):
        """The whole (unpadded) state and digest on rank 0."""
        return self._command("gather_state")

    def _do_gather_state(self):
        if self.mesh.data_index != 0:
            return None
        st, dg = self.state, self.digest
        counts, means, weights = (self._gather_campaigns(x) for x in
                                  (st.counts, dg.means, dg.weights))
        if self._follows:
            return None
        return st._replace(counts=counts), tdigest.TDigestState(means,
                                                                weights)

    def snapshot(self, offset):
        shard = self.state, self.digest
        self.state, self.digest = self._whole()
        try:
            return super().snapshot(offset)
        finally:
            self.state, self.digest = shard

    def quantiles(self) -> np.ndarray:
        """Per-campaign latency quantiles of the whole key space (the
        centroid block gathered to rank 0; no padding row)."""
        _, digest = self._whole()
        qs = torch.tensor(self.QUANTILES, dtype=torch.float32)
        return tdigest.quantile(digest, qs).cpu().numpy()

    def restore(self, snap) -> None:
        super().restore(snap)
        self._place()


class ShardedSessionCMSEngine(SingleController, SessionCMSEngine):
    """Session + count-min engine with per-user state sharded over the
    whole mesh (user axis = flattened ``data x campaign``).

    Sessionization is per-key-sequential, so its state shards by USER:
    each rank sessionizes the replicated batch masked to its users;
    closed sessions merge into the replicated sketch by per-shard delta +
    sum (fixed) or by every rank folding the gathered rows (SALSA), and
    into the replicated ring by gathering the closed rows.  Bit-identical
    to the single-device engine (tested).  It refuses a ``user_capacity``
    the mesh does not divide (padding would accept users the unsharded
    engine drops) and the two-stage sketch (its small stage's maxima do
    not merge soundly)."""

    DATA_SHARDED = False
    REPORT_RESTORES = ("state", "cms", "topk", "_closed_dev",
                       "_clicks_dev", "lat_hist")

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 mesh: Mesh, campaigns: list[str] | None = None,
                 redis: RedisLike | None = None,
                 gap_ms: int = 30_000, user_capacity: int = 1 << 16,
                 cms_depth: int = 4, cms_width: int = 2048,
                 top_k: int = 16, candidate_capacity: int | None = None,
                 cms_mode: str | None = None,
                 cms_cell_bits: int | None = None,
                 device: torch.device | str | None = None):
        if user_capacity % mesh.size:
            raise ValueError(
                f"user_capacity {user_capacity} not divisible by mesh "
                f"size {mesh.size}")
        stages = int(getattr(cfg, "jax_cms_stages", 1))
        if stages == 2:
            raise ValueError(
                "the sharded session engine does not support "
                "jax.cms.stages=2 (small-stage maxima do not merge "
                "soundly); use stages=1 with mode=fixed or salsa")
        check_mesh_device(mesh, device)
        super().__init__(cfg, ad_to_campaign, campaigns=campaigns,
                         redis=redis, gap_ms=gap_ms,
                         user_capacity=user_capacity, cms_depth=cms_depth,
                         cms_width=cms_width, top_k=top_k,
                         candidate_capacity=candidate_capacity,
                         cms_mode=cms_mode, cms_cell_bits=cms_cell_bits,
                         device=mesh.device)
        self._init_controller(mesh)
        self._axes = mesh_axes(mesh, 1)
        self._fold_kw = dict(salsa_plane=self.cms_mode == "salsa",
                             gap_ms=self.gap_ms, lateness_ms=self.lateness,
                             user_capacity=self.user_capacity)
        st = session.init_state(user_capacity // mesh.size,
                                device=mesh.device)
        self.state = st._replace(watermark=self.state.watermark,
                                 dropped=self.state.dropped)

    def _place(self) -> None:
        """Every rank takes its user slice of the (whole) session arrays
        rank 0 holds (a restore), and the replicated sketch, ring,
        counters and histogram."""
        Ul = self.user_capacity // self.mesh.size
        whole = [t.cpu().numpy() for t in self.state[:3]]
        rest = [np.asarray(x.cpu().numpy()) for x in self._carry()[3:]]
        self._command("put_state", per_rank=lambda r: (
            [a[r * Ul:(r + 1) * Ul] for a in whole], rest))

    def _do_put_state(self, users: list, rest: list) -> None:
        dev = self.device
        self._uncarry([torch.from_numpy(np.array(a)).to(dev)
                       for a in users + rest])

    def _carry(self) -> tuple:
        return (*self.state, *self.cms, *self.topk, self._closed_dev,
                self._clicks_dev, self.lat_hist)

    def _uncarry(self, out) -> None:
        lt, ss, ck, wm, dr, *sk, tkk, tke, cn, cl, hist = out
        self.state = session.SessionState(lt, ss, ck, wm, dr)
        self.cms = (salsa.SalsaState(*sk) if self.cms_mode == "salsa"
                    else cms.CMSState(*sk))
        self.topk = cms.TopKState(tkk, tke)
        self._closed_dev, self._clicks_dev, self.lat_hist = cn, cl, hist

    def _fold_args(self) -> tuple:
        return (self._now_rel(),)

    def _step_local(self, local: list, packed: bool, now_rel: int) -> None:
        self._uncarry(session_fold_step(
            self._carry(), now_rel, local, self._axes,
            recorder=self._recorder, **self._fold_kw))

    def _scan_local(self, local: list, packed: bool, now_rel: int) -> None:
        self._uncarry(session_fold_scan(
            self._carry(), now_rel, local, self._axes, hoist=True,
            recorder=self._recorder, **self._fold_kw))

    def _drain_device(self) -> None:
        self._command("flush", False, self._now_rel())
        self._span_start = None

    def _do_flush(self, force: bool, now_rel: int) -> None:
        kw = dict(self._fold_kw)
        kw.pop("user_capacity")
        self._uncarry(session_fold_flush(self._carry(), now_rel, self._axes,
                                         force=force,
                                         recorder=self._recorder, **kw))

    def _close_rank0(self) -> None:
        self._command("flush", True, self._now_rel())
        self._write_heavy_hitters()

    def _do_gather_state(self):
        users = [self._gather_rows(t, self.mesh.world_group)
                 for t in self.state[:3]]
        return None if self._follows else self.state._replace(
            last_time=users[0], sess_start=users[1], clicks=users[2])

    def snapshot(self, offset):
        shard = self.state
        self.state = self._command("gather_state")
        try:
            return super().snapshot(offset)
        finally:
            self.state = shard

    def restore(self, snap) -> None:
        super().restore(snap)
        self._place()
