"""Campaign-sharded reach: the planes on the mesh, queries next to the shards.

The port of ``streambench_tpu/parallel/reach.py``.  The reach engine's
``[C, k]`` signature plane and ``[C, R]`` HLL plane merge elementwise
(min / max), so sharding them on the campaign axis is exact: each
campaign's rows live on one shard, the fold routes every event to its
owner (the sharded HLL treatment without the window ring), and
cross-shard state never merges.  Each rank runs the eager fold on its own
shard, as ``parallel/sketches.py`` does; every collective goes through
``parallel/collectives.py``, so a ``Recorder`` counts what is issued.

- **The fold** (``reach_fold_step``, ``reach_fold_scan``): the batch
  columns are all-gathered over the data group (5 columns unpacked, 3
  packed; the scan gathers each ``[K, b]`` stack once a dispatch and its
  loop issues no collective), then ``minhash.step`` runs against the join
  table rebased to this rank's campaigns ``[c0, c0 + Cl)``: every other
  ad maps to -1, the fold's drop slot.  The watermark comes from the
  replicated columns, with no collective.
- **The query** (``reach_query``): each rank reduces its own campaign
  rows to ``[Q, k]`` minima, ``[Q, k]`` maxima and ``[Q, R]`` register
  maxima, then the merge is exactly two collectives a dispatch whatever
  C, Q or the queries' fan-out: one all-reduce MIN of the ``[Q, k]``
  minima and one all-reduce MAX of the ``[Q, k + R]`` concatenation, both
  int64 (the port's signature plane holds uint32 values in int64).  The
  registers are cast back to int32 before ``hll.estimate``, so the
  arithmetic after the merge is ``reach.query.batch_query``'s, over the
  same integers: the answers are bit-identical to the unsharded
  engine's.  A shard whose selected rows are all False contributes the
  identities (``EMPTY`` to the min, 0 to the max).

``ShardedReachEngine`` is a drop-in for ``ReachSketchEngine``: the same
host loop, serving attachment (an attached query server evaluates
through ``query_callable``), snapshot format (planes gather to the
reference's host arrays, so a single-device snapshot restores here and
the other way round) and CLI flags.  With more than one rank it takes
the single controller (``parallel.controller``), and two threads issue
its commands, the host loop's folds and pushes and the query server's
evaluations: one lock orders each command and its collectives.  Every
push clones each rank's shard under a generation number, and a query
names the generation its planes came from, so every rank answers from
the same push while later folds update the live planes in place.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from streambench_tpu_torch.checkpoint import Snapshot
from streambench_tpu_torch.config import BenchmarkConfig
from streambench_tpu_torch.engine.sketches import ReachSketchEngine
from streambench_tpu_torch.io.redis_schema import RedisLike
from streambench_tpu_torch.ops import hll, minhash
from streambench_tpu_torch.ops.minhash import EMPTY
from streambench_tpu_torch.parallel import collectives
from streambench_tpu_torch.parallel.controller import SingleController
from streambench_tpu_torch.parallel.mesh import CAMPAIGN_AXIS, Mesh
from streambench_tpu_torch.parallel.sharded import (
    Axes,
    check_mesh_device,
    pad_campaigns,
)
from streambench_tpu_torch.parallel.sketches import (
    _batch_cols,
    _CampaignSharded,
    _campaign_shards,
    _scalar,
)
from streambench_tpu_torch.reach import query as rq


def sharded_reach_init(num_campaigns: int, k: int, num_registers: int,
                       mesh: Mesh) -> minhash.ReachState:
    """This rank's initial state: its ``[Cl, k]`` / ``[Cl, R]`` shards of
    the padded key space (pad rows are never touched: an ``EMPTY``
    signature and zero registers read as reach 0, like an unobserved
    campaign), and the replicated watermark and drops."""
    cl = pad_campaigns(num_campaigns, mesh) // mesh.shape[CAMPAIGN_AXIS]
    return minhash.init_state(cl, k, num_registers, device=mesh.device)


def _local_join(join_table: torch.Tensor, axes: Axes,
                cl: int) -> torch.Tensor:
    """The join table rebased to this rank's shard: an ad of a campaign in
    ``[c0, c0 + Cl)`` maps to its shard row, every other ad to -1, so
    ``minhash.step`` on the shard is the reference's shard-local fold
    (out-of-shard rows go to its drop slot) and the unsharded fold, bit
    for bit, on this shard's rows."""
    local = join_table - axes.c0
    return torch.where((local >= 0) & (local < cl), local, -1).to(
        join_table.dtype)


def reach_fold_step(state: minhash.ReachState, join_table, cols,
                    axes: Axes, *, packed: bool, view_type: int = 0,
                    recorder=None, in_loop: bool = False
                    ) -> minhash.ReachState:
    """Fold one batch of this rank's LOCAL columns (``(packed, user,
    time)`` or ``(ad, user, etype, time, valid)``, each ``[b]``) into its
    shard, in place."""
    ad, user, et, tm, v = _batch_cols(cols, axes, recorder, packed=packed,
                                      extra=("user_idx",), in_loop=in_loop)
    join = _local_join(join_table, axes, state.mins.shape[0])
    return minhash.step(state, join, ad, user, et, tm, v,
                        view_type=view_type)


def reach_fold_scan(state: minhash.ReachState, join_table, stacks,
                    axes: Axes, *, packed: bool, view_type: int = 0,
                    recorder=None) -> minhash.ReachState:
    """Fold ``[K, b]`` local stacks, one batch a row: each stack is
    gathered once a dispatch and the loop issues no collective (reach
    has no drop counter to sum)."""
    ad, user, et, tm, v = _batch_cols(stacks, axes, recorder, packed=packed,
                                      extra=("user_idx",))
    join = _local_join(join_table, axes, state.mins.shape[0])
    for i in range(ad.shape[0]):
        state = minhash.step(state, join, ad[i], user[i], et[i], tm[i],
                             v[i], view_type=view_type)
    return state


def reach_query(mins: torch.Tensor, registers: torch.Tensor,
                mask: torch.Tensor, overlap: torch.Tensor, axes: Axes, *,
                recorder=None):
    """One padded query batch evaluated next to the shards.

    ``mins [Cl, k]`` / ``registers [Cl, R]`` this rank's shard, ``mask
    [Q, Cl]`` bool its columns of the query mask, ``overlap [Q]`` bool.
    Returns ``batch_query``'s ``(estimate, union, jaccard, agree)``,
    replicated over the campaign group: two collectives."""
    k = mins.shape[1]
    sel = mask[:, :, None]
    m = mins[None]
    loc_min = torch.where(sel, m, EMPTY).amin(dim=1)
    loc_max = torch.where(sel, m, 0).amax(dim=1)
    loc_regs = torch.where(sel, registers[None], 0).amax(dim=1)
    sel_min = collectives.all_reduce_extreme(
        loc_min, axes.campaign, recorder, op="min", name="sig_min")
    merged = collectives.all_reduce_extreme(
        torch.cat([loc_max, loc_regs.to(torch.int64)], dim=1),
        axes.campaign, recorder, op="max", name="sig_max_registers")
    sel_max = merged[:, :k]
    union_regs = merged[:, k:].to(registers.dtype)
    agree = ((sel_min == sel_max) & (sel_min != EMPTY)).sum(
        dim=1, dtype=torch.int32)
    union = hll.estimate(union_regs).to(torch.float32)
    jacc = agree.to(torch.float32) / k
    est = torch.where(overlap, union * jacc, union)
    return est, union, jacc, agree


def _host_bool(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, bool)


class ShardedReachEngine(_CampaignSharded, ReachSketchEngine):
    """The reach engine with both planes sharded on the campaign axis of a
    ``(data, campaign)`` mesh and queries evaluated next to the shards
    (module doc).  The other ranks stop following at a multi-rank
    engine's close: a query its server commands after that is refused
    (``RuntimeError``), so close the server first."""

    # the per-batch step ships the separate columns, as the reference's
    STEP_PACKS = False

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 mesh: Mesh, campaigns: list[str] | None = None,
                 redis: RedisLike | None = None,
                 k: int | None = None, registers: int = 256,
                 device: torch.device | str | None = None):
        check_mesh_device(mesh, device)
        super().__init__(cfg, ad_to_campaign, campaigns=campaigns,
                         redis=redis, k=k, registers=registers,
                         device=mesh.device)
        self._init_campaign_mesh(mesh)
        self.state = sharded_reach_init(self.encoder.num_campaigns, self.k,
                                        self.registers, mesh)
        self._closed = False
        # rank 0's planes at a multi-rank close, read after it
        self._close_planes: dict | None = None
        # push generation -> this rank's pushed planes (rank 0 keeps a
        # weak reference to the signature clone the server holds, the
        # other ranks the clones, until rank 0 sees the server drop it)
        self._push_gen = 0
        self._pushed: dict = {}
        # rank 0's planes of the query being commanded
        self._query_planes: tuple | None = None

    # -- the protocol --------------------------------------------------
    def _command(self, name: str, *args, per_rank=None):
        with self._cmd_lock:
            if self._closed and self._leads and name != "stop":
                raise RuntimeError("the sharded reach engine is closed: "
                                   "its other ranks no longer follow")
            return super()._command(name, *args, per_rank=per_rank)

    def close(self) -> None:
        # the lock for the whole close: a query the server commands
        # meanwhile waits, then meets the closed engine instead of
        # ranks that no longer follow
        with self._cmd_lock:
            super().close()

    def _close_rank0(self) -> None:
        try:
            super()._close_rank0()
            if self._leads:
                # the other ranks stop following at close: keep the
                # close-time planes for what reads them after it (the
                # CLI ships them once its server has drained)
                self._close_planes = self.planes()
        finally:
            self._closed = True

    # -- the fold ------------------------------------------------------
    def _step_local(self, local: list, packed: bool) -> None:
        self.state = reach_fold_step(self.state, self.join_table, local,
                                     self._axes, packed=packed,
                                     recorder=self._recorder)

    def _scan_local(self, local: list, packed: bool) -> None:
        self.state = reach_fold_scan(self.state, self.join_table, local,
                                     self._axes, packed=packed,
                                     recorder=self._recorder)

    def _fold_args(self) -> tuple:
        return ()

    def _device_step(self, batch) -> None:
        SingleController._device_step(self, batch)
        # the dirty mask from the unpadded host columns
        self._note_fold([batch.ad_idx, batch.valid], False)

    def _fold_stack(self, batches: list) -> list[np.ndarray]:
        stacks = SingleController._fold_stack(self, batches)
        self._note_fold(stacks, self._pack_ok)
        return stacks

    # -- the pushed planes ---------------------------------------------
    def _push_planes(self) -> tuple:
        with self._cmd_lock:
            self._push_gen += 1
            dead = [g for g, ref in self._pushed.items() if ref() is None]
            return self._command("push", self._push_gen, dead)

    def _do_push(self, gen: int, dead: list) -> tuple:
        """Every rank clones its shard under generation ``gen`` and forgets
        the generations rank 0's server no longer holds."""
        for g in dead:
            self._pushed.pop(g, None)
        planes = self.state.mins.clone(), self.state.registers.clone()
        self._pushed[gen] = (planes if self._follows
                             else weakref.ref(planes[0]))
        return planes

    # -- queries next to the shards ------------------------------------
    def query_callable(self):
        """The evaluator an attached query server dispatches through: the
        ``[Q, C]`` mask padded to the sharded campaign width with False
        (a pad campaign is never selected) and evaluated next to the
        shards, two collectives a dispatch."""
        return self._query

    def _generation(self, mins: torch.Tensor):
        """The push generation whose signature clone is ``mins`` (None:
        the live planes)."""
        if mins is self.state.mins:
            return None
        for g, ref in self._pushed.items():
            if ref() is mins:
                return g
        if self._leads:
            raise ValueError("these planes came from no push of this "
                             "engine: the other ranks cannot answer "
                             "from them")
        return None

    def _query(self, mins, registers, mask, overlap):
        mask = _host_bool(mask)
        pad = self._c_pad - mask.shape[1]
        if pad:
            mask = np.concatenate(
                [mask, np.zeros((mask.shape[0], pad), bool)], axis=1)
        overlap = _host_bool(overlap)
        cl = self._c_pad // self.mesh.shape[CAMPAIGN_AXIS]
        nc = self.mesh.shape[CAMPAIGN_AXIS]
        with self._cmd_lock:
            gen = self._generation(mins)

            def per_rank(r: int) -> tuple:
                c0 = (r % nc) * cl          # the grid is row-major
                return (gen, np.ascontiguousarray(mask[:, c0:c0 + cl]),
                        overlap)
            self._query_planes = (mins, registers)
            try:
                return self._command("query", per_rank=per_rank)
            finally:
                self._query_planes = None

    def _do_query(self, gen, mask: np.ndarray, overlap: np.ndarray):
        if self._query_planes is not None:
            mins, registers = self._query_planes
        elif gen is None:
            mins, registers = self.state.mins, self.state.registers
        else:
            mins, registers = self._pushed[gen]
        dev = self.device
        return reach_query(mins, registers, torch.from_numpy(mask).to(dev),
                           torch.from_numpy(overlap).to(dev), self._axes,
                           recorder=self._recorder)

    def batch_query(self, masks, overlap):
        """Evaluate ``[Q, C]`` masks against the live planes next to the
        shards: numpy in, numpy out."""
        out = self._query(self.state.mins, self.state.registers, masks,
                          overlap)
        return tuple(x.cpu().numpy() for x in out)

    # -- host views ----------------------------------------------------
    def planes(self) -> dict:
        """The whole planes as the reference's numpy arrays, trimmed to
        the real campaigns: ``mins`` uint32 ``[C, k]``, ``registers``
        int32 ``[C, R]`` (a gather and a device sync; after a
        multi-rank close, the planes gathered at the close)."""
        if self._close_planes is not None:
            return self._close_planes
        return self._command("gather_planes")

    def _do_gather_planes(self):
        if self.mesh.data_index != 0:
            return None
        mins = self._gather_campaigns(self.state.mins)
        regs = self._gather_campaigns(self.state.registers)
        if self._follows:
            return None
        return {"mins": minhash.mins_numpy(mins),
                "registers": regs.cpu().numpy()}

    def host_state(self) -> minhash.ReachState:
        """The whole planes (numpy, trimmed to the real campaigns: the
        unsharded engine's view) and the replicated scalars."""
        p = self.planes()
        return minhash.ReachState(p["mins"], p["registers"],
                                  int(self.state.watermark),
                                  int(self.state.dropped))

    def estimates(self) -> np.ndarray:
        regs = torch.from_numpy(self.planes()["registers"]).to(self.device)
        return minhash.estimate(regs).cpu().numpy()

    # -- snapshot / restore (snapshot() is the unsharded engine's over
    # the gathered planes) ----------------------------------------------
    def restore(self, snap: Snapshot) -> None:
        """Any reach snapshot, sharded or single-device (the scale-out
        upgrade path): each rank takes its shard of the planes, the
        campaign axis padded with never-touched rows."""
        self._check_geometry(snap, extra=dict(
            reach_k=self.k, num_registers=self.registers))
        mins = np.asarray(snap.extra["mh_mins"], np.uint32)
        pad = self._c_pad - mins.shape[0]
        if pad > 0:
            mins = np.concatenate(
                [mins, np.full((pad, mins.shape[1]), EMPTY, np.uint32)])
        shard = _campaign_shards(
            [mins, np.asarray(snap.extra["hll_plane"], np.int32)],
            self._c_pad, self.mesh.shape[CAMPAIGN_AXIS])
        rest = (int(snap.watermark), int(snap.dropped))
        self._command("put_state", per_rank=lambda r: (*shard(r), *rest))
        self._restore_interns(snap)
        self._restore_host(snap)
        self.reach_epoch = max(self.reach_epoch,
                               int(snap.meta.get("reach_epoch", 0))) + 1
        self._reach_push(force_ship=True)

    def _do_put_state(self, mins, registers, watermark, dropped) -> None:
        dev = self.device
        self.state = minhash.ReachState(
            minhash.mins_tensor(mins, dev),
            torch.from_numpy(np.array(registers, np.int32)).to(dev),
            _scalar(watermark, dev), _scalar(dropped, dev))

    # -- collective accounting -----------------------------------------
    def collective_report(self, k: int | None = None, timed: bool = False,
                          query_batch: int = rq.DEFAULT_BATCH) -> dict:
        """The fold's step and hoisted scan (``SingleController``'s) and
        one query dispatch of ``query_batch`` queries, counted as issued:
        the query's per-dispatch ops read 2 on any mesh."""
        report = self._command("report", int(k or self.scan_batches), timed,
                               int(query_batch))
        if self._obs_reg is not None:
            collectives.publish_gauges(self._obs_reg, report)
        return report

    def _do_report(self, k: int, timed: bool,
                   query_batch: int = rq.DEFAULT_BATCH) -> dict:
        report = super()._do_report(k, timed)
        st, dev = self.state, self.device
        mask = torch.zeros((query_batch, st.mins.shape[0]), dtype=torch.bool,
                           device=dev)
        overlap = torch.zeros(query_batch, dtype=torch.bool, device=dev)

        def dispatch(rec) -> None:
            reach_query(st.mins, st.registers, mask, overlap, self._axes,
                        recorder=rec)
        report["query_batch"] = query_batch
        report["query"] = collectives.report_for(dispatch, timed=timed)
        return report
