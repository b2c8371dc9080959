"""Sharded window counting: the fold over a ``(data, campaign)`` mesh of ranks.

The port of ``streambench_tpu/parallel/sharded.py``.  Where JAX runs one
``shard_map`` program over the mesh, each rank here runs the same eager
fold on its own shard (SPMD, one process a device):

- the batch columns are all-gathered over the data group (the
  reference's ``_gather_replicated``), so every rank holds the same full
  batch and computes the same window claims and watermark;
- each rank counts the rows of its campaign range ``[c0, c0 + Cl)`` into
  its ``[Cl, W]`` counts shard with K1 (``ops.count.count_cells``, in
  place), where the reference scatter-adds;
- the per-shard counted rows are summed over the campaign group, and
  ``dropped`` follows from them, as the reference's ``psum``.

Semantics are bit-identical to the single-device ``ops.windowcount.step``
(tested), because integer adds and maxes do not depend on their order.

Layouts, per rank:

- ``counts [Cl, W]``    this rank's campaign shard (``Cl = C_pad / campaign``)
- ``window_ids [W]``, ``watermark``, ``dropped``   replicated
- batch columns ``[B / data]``   this rank's slice of the global batch

``C`` pads up to a multiple of the campaign axis (``sharded_init_state``)
and ``B`` to a multiple of the data axis (``data_axis_pad``: invalid tail
rows).  The hoisted scan gathers each ``[K, B]`` stack once and sums the
counted rows once per dispatch, with nothing inside its loop.

``ShardedWindowEngine`` runs this fold under the port's engine.  At world
size 1 (one card) it is the base engine with the fold swapped: drains,
checkpoints and exactly-once are the base engine's.  With more ranks,
rank 0 plays the JAX single controller (``parallel.controller``, which
the sketch engines of ``parallel.sketches`` share): it alone reads the
stream, owns the writer, the fence and the checkpoints, and sends every
device call to the other ranks (``follow``) on the gloo group before
making it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from streambench_tpu_torch.config import BenchmarkConfig
from streambench_tpu_torch.engine.pipeline import (
    AdAnalyticsEngine,
    default_method,
)
from streambench_tpu_torch.io.redis_schema import RedisLike
from streambench_tpu_torch.ops import windowcount as wc
from streambench_tpu_torch.ops.windowcount import WindowState
from streambench_tpu_torch.parallel import collectives
from streambench_tpu_torch.parallel.controller import SingleController
from streambench_tpu_torch.parallel.mesh import CAMPAIGN_AXIS, DATA_AXIS, Mesh
from streambench_tpu_torch.utils.device import resolve_device


class Axes(NamedTuple):
    """Where one rank's fold gathers and sums."""

    gather: object      # group the batch is all-gathered over
    campaign: object    # group the counted rows are summed over
    c0: int             # first campaign row of this rank's shard
    shards: int         # campaign-axis size (the stats arm's [S])
    # the whole mesh (the user-sharded session fold's group) and this
    # rank's place in it: the linearized (data, campaign) shard index
    world: object = None
    index: int = 0


def pad_campaigns(num_campaigns: int, mesh: Mesh) -> int:
    """Campaign count padded up to a multiple of the campaign axis."""
    nc = mesh.shape[CAMPAIGN_AXIS]
    return ((num_campaigns + nc - 1) // nc) * nc


def data_axis_pad(batch_size: int, mesh: Mesh) -> int:
    """Invalid rows appended per batch so the data axis divides it.

    Padding rows are invalid everywhere they can matter (counts, the
    watermark max, drop accounting), so results stay bit-identical to
    the unpadded engine (tested)."""
    return (-batch_size) % mesh.shape[DATA_AXIS]


def pad_data_cols(pad: int, *cols: torch.Tensor) -> tuple:
    """Zero-pad the trailing (batch) axis of each column by ``pad`` rows.

    A zero row is invalid in every wire form: the unpacked ``valid``
    column pads to False, and a packed word of 0 decodes to (ad 0,
    type -1, valid False), masked everywhere."""
    if not pad:
        return cols
    return tuple(F.pad(c, (0, pad)) for c in cols)


def data_slice(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the trailing (batch) axis of a global column
    or stack (the reference's ``P(DATA_AXIS)`` input layout)."""
    b = x.shape[-1] // mesh.shape[DATA_AXIS]
    i = mesh.data_index
    return x[..., i * b:(i + 1) * b].contiguous()


def mesh_axes(mesh: Mesh, num_campaigns: int) -> Axes:
    """The fold's groups and shard origin on ``mesh`` for a key space of
    ``num_campaigns``."""
    nc = mesh.shape[CAMPAIGN_AXIS]
    cl = pad_campaigns(num_campaigns, mesh) // nc
    return Axes(mesh.data_group, mesh.campaign_group,
                mesh.campaign_index * cl, nc, mesh.world_group, mesh.rank)


def check_mesh_device(mesh: Mesh, device) -> None:
    """Raise unless ``device`` (default ``"cuda"``) is the mesh's: a CUDA
    mesh runs NCCL, a CPU mesh gloo."""
    dev = resolve_device(device)
    if dev.type != mesh.device.type or dev.index not in (
            None, mesh.device.index):
        raise ValueError(f"the engine runs on {dev}, its mesh on "
                         f"{mesh.device} ({mesh.backend})")


def sharded_init_state(num_campaigns: int, window_slots: int,
                       mesh: Mesh) -> WindowState:
    """This rank's initial state: its ``[Cl, W]`` counts shard of the
    padded key space, and the replicated ring, watermark and drops."""
    cl = pad_campaigns(num_campaigns, mesh) // mesh.shape[CAMPAIGN_AXIS]
    return wc.init_state(cl, window_slots, mesh.device)


def _shard_hist(campaign: torch.Tensor, mask: torch.Tensor, cl: int,
                n_shards: int) -> torch.Tensor:
    """Replicated ``[S]`` int32 histogram of ``mask`` rows by owning
    campaign shard (``campaign // Cl``); computed from replicated inputs,
    so it needs no collective."""
    shard = torch.div(campaign, cl, rounding_mode="floor").clamp(
        0, n_shards - 1)
    flat = torch.where(mask, shard, n_shards).to(torch.int64)
    hist = torch.zeros(n_shards + 1, dtype=torch.int32, device=flat.device)
    hist.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return hist[:n_shards]


def _fold_local(counts, window_ids, watermark, join_table,
                ad_idx, event_type, event_time, valid, axes: Axes, *,
                divisor_ms: int, lateness_ms: int, view_type: int,
                method: str, stats: bool = False) -> tuple:
    """The collective-free shard-local fold over an already-gathered
    batch.  Returns ``(counts, ids, wm, wanted_n, counted_local)``, plus
    the ``[S]`` per-shard (wanted, routed) row histograms with
    ``stats``; the caller sums ``counted_local`` over the campaign group,
    per batch or once per dispatch (the sums are exact and linear, so
    deferring them is bit-identical)."""
    cl = counts.shape[0]
    campaign = wc.gather_rows(join_table, ad_idx)
    wid = torch.div(event_time, divisor_ms, rounding_mode="floor")
    wanted = valid & (event_type == view_type) & (campaign >= 0)
    slot, count_mask, new_ids, new_wm = wc.assign_windows(
        window_ids, watermark, wid, wanted, valid, event_time,
        divisor_ms=divisor_ms, lateness_ms=lateness_ms)
    # keyed state without moving state: each rank counts the rows of its
    # own campaign range into its shard, in place, through K1
    local_c = campaign - axes.c0
    in_shard = count_mask & (local_c >= 0) & (local_c < cl)
    counts = wc.apply_count(counts, local_c, slot, in_shard, method)
    out = (counts, new_ids, new_wm, wanted.sum(dtype=torch.int32),
           in_shard.sum(dtype=torch.int32))
    if not stats:
        return out
    return out + (_shard_hist(campaign, wanted, cl, axes.shards),
                  _shard_hist(campaign, count_mask, cl, axes.shards))


def _gather(x: torch.Tensor, axes: Axes, recorder, name: str,
            in_loop: bool) -> torch.Tensor:
    """The ONE gather of the fold: both wire forms, per batch or per
    dispatch, gather the same way."""
    return collectives.all_gather_last(x, axes.gather, recorder, name=name,
                                       in_loop=in_loop)


def _unpack_gathered(cols, axes, recorder, packed: bool, in_loop: bool):
    """Gather one dispatch's local columns (``[b]`` or ``[K, b]``) and
    return them replicated and unpacked: ``(ad, etype, time, valid)``."""
    if packed:
        word, tm = (_gather(c, axes, recorder, n, in_loop)
                    for c, n in zip(cols, ("packed", "event_time")))
        ad, et, va = wc.unpack_columns(word)
        return ad, et, tm, va
    ad, et, tm, va = (_gather(c, axes, recorder, n, in_loop) for c, n in
                      zip(cols, ("ad_idx", "event_type", "event_time",
                                 "valid")))
    return ad, et, tm, va > 0


def _fold_one(state: WindowState, join_table, cols, axes: Axes, recorder,
              *, packed: bool, in_loop: bool = False, stats: bool = False,
              **kw) -> tuple:
    """Gather one batch, fold it, sum the counted rows over the campaign
    group: ``(counts, ids, wm, dropped, *stats)``."""
    ad, et, tm, va = _unpack_gathered(cols, axes, recorder, packed, in_loop)
    counts, ids, wm, wanted_n, counted_local, *hist = _fold_local(
        state.counts, state.window_ids, state.watermark, join_table,
        ad, et, tm, va, axes, stats=stats, **kw)
    counted = collectives.all_reduce_sum(counted_local, axes.campaign,
                                         recorder, name="counted",
                                         in_loop=in_loop)
    return (counts, ids, wm, state.dropped + wanted_n - counted, *hist)


def fold_step(state: WindowState, join_table, cols, axes: Axes, *,
              packed: bool, divisor_ms: int = 10_000,
              lateness_ms: int = 60_000, view_type: int = 0,
              method: str = "scatter", stats: bool = False,
              recorder: collectives.Recorder | None = None) -> tuple:
    """Fold one batch of this rank's LOCAL columns (``(packed, time)`` or
    ``(ad, etype, time, valid)``, each ``[b]``) into ``state`` (counts in
    place).  Returns ``(counts, ids, wm, dropped)``, plus the ``[S]``
    (wanted, routed) histograms with ``stats``."""
    return _fold_one(state, join_table, cols, axes, recorder, packed=packed,
                     stats=stats, divisor_ms=divisor_ms,
                     lateness_ms=lateness_ms, view_type=view_type,
                     method=method)


def fold_scan(state: WindowState, join_table, stacks, axes: Axes, *,
              packed: bool, hoist: bool = True, divisor_ms: int = 10_000,
              lateness_ms: int = 60_000, view_type: int = 0,
              method: str = "scatter", stats: bool = False,
              recorder: collectives.Recorder | None = None) -> tuple:
    """Fold ``[K, b]`` local stacks, one batch a row.

    ``hoist=True`` (what the engine dispatches) gathers each stack ONCE
    and sums the counted rows once after the loop: (cols + 1) collectives
    a dispatch instead of K * (cols + 1).  ``hoist=False`` keeps the
    per-batch collectives (the reference's measured baseline arm).
    ``stats`` (hoisted only) returns the dispatch's summed ``[S]``
    histograms after the state."""
    kw = dict(divisor_ms=divisor_ms, lateness_ms=lateness_ms,
              view_type=view_type, method=method)
    K = stacks[0].shape[0]
    if not hoist:
        if stats:
            raise ValueError("shard stats ride the hoisted scan only")
        out = tuple(state)
        for k in range(K):
            out = _fold_one(WindowState(*out), join_table,
                            [s[k] for s in stacks], axes, recorder,
                            packed=packed, in_loop=True, **kw)
        return out
    ad, et, tm, va = _unpack_gathered(stacks, axes, recorder, packed, False)
    counts, ids, wm = state.counts, state.window_ids, state.watermark
    wanted_n = counted_local = torch.zeros((), dtype=torch.int32,
                                           device=counts.device)
    hists = None
    for k in range(K):
        counts, ids, wm, wn, cl, *hist = _fold_local(
            counts, ids, wm, join_table, ad[k], et[k], tm[k], va[k], axes,
            stats=stats, **kw)
        wanted_n = wanted_n + wn
        counted_local = counted_local + cl
        if stats:
            hists = hist if hists is None else [a + b for a, b in
                                                zip(hists, hist)]
    counted = collectives.all_reduce_sum(counted_local, axes.campaign,
                                         recorder, name="counted")
    out = (counts, ids, wm, state.dropped + wanted_n - counted)
    return out + tuple(hists) if stats else out


def _mesh_call(fn, mesh: Mesh, state: WindowState, join_table, cols, *,
               packed: bool, stats: bool = False, **kw):
    """``fn`` over ``mesh`` on the GLOBAL columns (every rank passes the
    whole batch; each folds its data slice), as the reference's
    ``shard_map`` takes them.  ``WindowState``, or ``(WindowState,
    wanted_s, routed_s)`` with ``stats``."""
    axes = mesh_axes(mesh, state.counts.shape[0] * mesh.shape[CAMPAIGN_AXIS])
    local = [data_slice(mesh, torch.as_tensor(c, device=mesh.device))
             for c in cols]
    if kw.get("method") is None:
        kw["method"] = default_method(mesh.device)
    out = fn(state, join_table, local, axes, packed=packed, stats=stats,
             **kw)
    st = WindowState(*out[:4])
    return (st, *out[4:]) if stats else st


def sharded_step(mesh: Mesh, state: WindowState, join_table,
                 ad_idx, event_type, event_time, valid, *,
                 divisor_ms: int = 10_000, lateness_ms: int = 60_000,
                 view_type: int = 0, method: str | None = None,
                 stats: bool = False, recorder=None):
    """Fold one global micro-batch into this rank's sharded state.  Every
    rank passes the same global columns (``B`` a multiple of the data
    axis: ``pad_data_cols``)."""
    return _mesh_call(fold_step, mesh, state, join_table,
                      (ad_idx, event_type, event_time, valid), packed=False,
                      stats=stats, divisor_ms=divisor_ms,
                      lateness_ms=lateness_ms, view_type=view_type,
                      method=method, recorder=recorder)


def sharded_step_packed(mesh: Mesh, state: WindowState, join_table,
                        packed, event_time, **kw):
    """``sharded_step`` over the packed wire word
    (``ops.windowcount.pack_columns``): two gathers a batch instead of
    four."""
    return _mesh_call(fold_step, mesh, state, join_table,
                      (packed, event_time), packed=True, **kw)


def sharded_scan(mesh: Mesh, state: WindowState, join_table,
                 ad_idx, event_type, event_time, valid, *,
                 hoist: bool = True, **kw):
    """Fold ``[K, B]`` global stacks in one dispatch (``fold_scan``)."""
    return _mesh_call(fold_scan, mesh, state, join_table,
                      (ad_idx, event_type, event_time, valid), packed=False,
                      hoist=hoist, **kw)


def sharded_scan_packed(mesh: Mesh, state: WindowState, join_table,
                        packed, event_time, *, hoist: bool = True, **kw):
    """``sharded_scan`` over ``[K, B]`` (packed, event_time) stacks."""
    return _mesh_call(fold_scan, mesh, state, join_table,
                      (packed, event_time), packed=True, hoist=hoist,
                      **kw)


def _host_allgather(values: np.ndarray, group) -> np.ndarray:
    """All-gather a small int64 host vector over the gloo ``group``:
    ``[ranks, n]`` in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(values, np.int64))
    out = torch.empty((dist.get_world_size(group),) + tuple(t.shape),
                      dtype=torch.int64)
    dist.all_gather(list(out.unbind(0)), t, group=group)
    return out.numpy()


class ShardedWindowEngine(SingleController, AdAnalyticsEngine):
    """``AdAnalyticsEngine`` with its state and batches sharded over a
    mesh of ranks.

    Drop-in: the same host loop and Redis writeback; the device step,
    the scan and the state placement change.  The campaign axis makes
    BASELINE config #5 (1e6-campaign multi-tenant) fit without
    replicating state.  ``device`` defaults to ``"cuda"`` and must be the
    mesh's (a CUDA mesh runs NCCL, a CPU mesh gloo).

    With more than one rank, rank 0 drives the engine as usual and every
    other rank calls ``follow()``, which runs the device calls rank 0
    sends until rank 0 closes its engine (``parallel.controller``).
    Every rank builds the engine from the same configuration and
    mapping.  Ranks do not each read the stream in lockstep: the runner
    flushes and checkpoints on the wall clock, so their drains
    (collectives) would diverge."""

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 mesh: Mesh, campaigns: list[str] | None = None,
                 redis: RedisLike | None = None, method: str | None = None,
                 device: torch.device | str | None = None):
        check_mesh_device(mesh, device)
        super().__init__(cfg, ad_to_campaign, campaigns=campaigns,
                         redis=redis, method=method, device=mesh.device)
        self._init_controller(mesh)
        # A batch size the data axis doesn't divide is padded with invalid
        # rows at dispatch, never rejected.
        self._data_pad = data_axis_pad(self.batch_size, mesh)
        num = self.encoder.num_campaigns
        self._c_pad = pad_campaigns(num, mesh)
        self._axes = mesh_axes(mesh, num)
        self.state = sharded_init_state(num, self.W, mesh)
        self._fold_kw = dict(divisor_ms=self.divisor,
                             lateness_ms=self.lateness, view_type=0,
                             method=self.method)

    # ------------------------------------------------------------------
    # the fold
    def _step_local(self, local: list, packed: bool) -> None:
        """One batch of this rank's local columns through ``fold_step``."""
        out = fold_step(self.state, self.join_table, local, self._axes,
                        packed=packed, stats=self._stats_on(),
                        recorder=self._recorder, **self._fold_kw)
        self.state = WindowState(*self._note_shard(out))

    def _scan_local(self, local: list, packed: bool) -> None:
        """``[K, b]`` local stacks through the hoisted ``fold_scan``."""
        out = fold_scan(self.state, self.join_table, local, self._axes,
                        packed=packed, hoist=True, stats=self._stats_on(),
                        recorder=self._recorder, **self._fold_kw)
        self.state = WindowState(*self._note_shard(out))

    # ------------------------------------------------------------------
    # drains, snapshots, restore
    def _track_dirty_rows(self) -> bool:
        # the global key space decides, on every rank alike (the base
        # constructor asks before the shard geometry is set)
        c_pad = getattr(self, "_c_pad", None)
        if c_pad is None:
            return super()._track_dirty_rows()
        return c_pad * self.W >= self.COMPACT_DRAIN_MIN_CELLS

    def _drain_device(self) -> None:
        """At world size 1 the base engine's drain (on the card the
        touched rows compacted there).  With more ranks, rank 0 picks the
        drain from its dirty-row tracker and every rank drains its shard:
        the touched rows of its range, or the whole shard when the set
        overflows ``DIRTY_ROWS_CAP`` or the key space is small; the data
        row of rank 0 gathers the shards to it over its campaign group."""
        if self.mesh.size == 1:
            super()._drain_device()
            return
        self._span_start = None
        rows = None
        if self._track_dirty_rows():
            rows = (np.unique(np.concatenate(self._dirty_rows))
                    if self._dirty_rows else np.empty(0, np.int64))
            self._dirty_rows = []
            if rows.size == 0:
                self._command("free_slots")
                self.drain_stats["free_slots"] += 1
                return
            if rows.size > self.DIRTY_ROWS_CAP:
                rows = None
        self._command("drain", rows)

    def _do_free_slots(self) -> None:
        self.state = wc.flush_free_slots(self.state, divisor_ms=self.divisor,
                                         lateness_ms=self.lateness)

    def _gather_shards(self, block: torch.Tensor) -> torch.Tensor | None:
        """``[S * R, W]``: every shard's ``[R, W]`` block in shard order,
        on the ranks of data row 0 (the others drain without gathering)."""
        if self.mesh.data_index != 0:
            return None
        return self._gather_rows(block, self.mesh.campaign_group)

    def _do_drain(self, rows: np.ndarray | None) -> None:
        kw = dict(divisor_ms=self.divisor, lateness_ms=self.lateness)
        cl = self.state.counts.shape[0]
        if rows is None:
            full = self._gather_shards(self.state.counts)
            _, wids, self.state = wc.flush_deltas(self.state, **kw)
            if self._leads:
                num = self.encoder.num_campaigns
                self._park(("dense", full[:num], wids))
            return
        # every rank knows every shard's rows: pad each shard's block to
        # the largest, so the gather has one shape
        per_shard = np.bincount(rows // cl,
                                minlength=self.mesh.shape[CAMPAIGN_AXIS])
        c0 = self._axes.c0
        mine = rows[(rows >= c0) & (rows < c0 + cl)] - c0
        idx = torch.from_numpy(mine.astype(np.int64)).to(self.device)
        block = self.state.counts.new_zeros((max(int(per_shard.max()), 1),
                                             self.W))
        block[:mine.size] = self.state.counts[idx]
        wids, self.state = wc.flush_rows_zero(self.state, idx, **kw)
        gathered = self._gather_shards(block)
        if self._leads:
            r = block.shape[0]
            sub = torch.cat([gathered[s * r:s * r + int(k)]
                             for s, k in enumerate(per_shard)])
            # shards are contiguous ranges of the sorted rows
            self._park(("rows_host", rows, sub.cpu().numpy(), wids))

    def _host_state(self) -> WindowState:
        if self.mesh.size == 1:
            return super()._host_state()
        return self._command("gather_state")

    def _do_gather_state(self) -> WindowState | None:
        """The whole ``[C, W]`` counts and the ring as numpy, on rank 0."""
        full = self._gather_shards(self.state.counts)
        if not self._leads:
            return None
        st = wc.state_to_numpy(self.state)
        return st._replace(
            counts=full[:self.encoder.num_campaigns].cpu().numpy())

    def _put_state(self, counts, window_ids, watermark, dropped):
        """Checkpoint restore: re-pads the campaign axis of an unsharded
        snapshot; each rank receives and places its shard's rows."""
        counts = np.asarray(counts, np.int32)
        if counts.shape[0] < self._c_pad:
            counts = np.pad(counts, ((0, self._c_pad - counts.shape[0]),
                                     (0, 0)))
        nc = self.mesh.shape[CAMPAIGN_AXIS]
        cl = self._c_pad // nc
        window_ids = np.asarray(window_ids)

        def per_rank(r: int) -> tuple:
            c0 = (r % nc) * cl      # the grid is row-major
            return (counts[c0:c0 + cl], window_ids, int(watermark),
                    int(dropped))
        return self._command("put_state", per_rank=per_rank)

    def _do_put_state(self, shard, window_ids, watermark, dropped):
        self.state = wc.state_from_numpy(
            (shard, window_ids, watermark, dropped), self.device)
        return self.state
