"""Sketch-aggregation engines: BASELINE configs #2, #3 and #4, reach and hllx.

The port of ``streambench_tpu/engine/sketches.py``'s HLL, reach, hllx,
sliding and session engines.  The host loop, encoder, Redis writer, runner and
harness are the exact engine's (``engine.pipeline.AdAnalyticsEngine``);
only the device state and its fold change:

- ``HLLDistinctEngine``: distinct users per (campaign, 10 s window) in
  HyperLogLog registers (``ops.hll``).  Estimates are absolute, so the
  writeback HSETs and an open window is rewritten only when its estimate
  changed.  No count kernel runs on this path.
- ``SlidingTDigestEngine``: view counts per sliding window (size/slide,
  ``ops.sliding``) and a per-campaign t-digest of event latency
  (``ops.tdigest``), whose quantiles go to ``<hashtable>_quantiles`` at
  close.  With the sliced fold (``jax.sliding.sliced``: on, or auto
  where the ``[C, S, W]`` plane fits) the count kernel K1 counts every
  batch into the ``[C*S, W]`` view of that plane.
- ``SessionCMSEngine``: session windows (gap-based) of per-user clicks
  (``ops.session``); every closed session feeds a count-min sketch keyed
  by user with its clicks as weight (``ops.cms``: fixed, two-stage, or
  SALSA, ``ops.salsa``), whose update and point query are the kernel K3
  on the card; a device-side heavy-hitter ring, whose top-k estimates go
  to ``<hashtable>_hh`` at close, and a close->absorb latency histogram.
- ``ReachSketchEngine``: cumulative per-campaign MinHash signatures and
  HLL planes (``ops.minhash``) served live to union/overlap queries
  (``reach/``: the query server, its cache, and read replicas fed by
  shipped snapshots and deltas); ``<hashtable>_reach`` at close.
- ``HLLXEngine``: cumulative per-campaign hyper-extended HLL ladders
  (``ops.hllx``): distinct users, soft-capped counts and the log-count
  moment from one register plane; ``<hashtable>_hllx`` at close.

The JAX engines fuse each chunk's fold into one jitted program; here the
six programs are plain functions that loop over the chunk's batches, as
the exact engine's ``scan_steps`` does, with the same per-chunk clock
stamp and one t-digest compress per chunk.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from streambench_tpu_torch.checkpoint import Snapshot
from streambench_tpu_torch.config import BenchmarkConfig
from streambench_tpu_torch.engine.pipeline import AdAnalyticsEngine, _to_numpy
from streambench_tpu_torch.io.redis_schema import RedisLike
from streambench_tpu_torch.ops import (
    cms,
    hll,
    minhash,
    salsa,
    session,
    sliding,
    tdigest,
)
from streambench_tpu_torch.ops import count as count_ops
from streambench_tpu_torch.ops import hllx
from streambench_tpu_torch.ops import windowcount as wc
from streambench_tpu_torch.reach import query as rq
from streambench_tpu_torch.utils.ids import now_ms


class _SketchEngineBase(AdAnalyticsEngine):
    """Checkpoint plumbing shared by the sketch engines.

    Sketch state may be keyed by *interned* user/page indices, so every
    snapshot also carries the encoder's intern tables (empty where an
    engine hashes ids instead), and a resumed encoder re-assigns the same
    indices.  Resume is at-least-once relative to the journal offset, as
    the exact engine's."""

    # No scanned fold unless an engine ships one; sketch steps ship
    # separate columns; interned ids need one consistent intern table,
    # so no pool of per-thread encoders.
    SCAN_SUPPORTED = False
    STEP_PACKS = False
    PARALLEL_ENCODE_OK = False
    NEEDS_INTERNED_IDS = True

    @staticmethod
    def _pack_keys(keys: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
        """Concatenated uint8 blob + int64 offsets (never an "S" array,
        whose fixed-width bytes strip trailing NULs)."""
        blob = b"".join(keys)
        offs = np.zeros(len(keys) + 1, np.int64)
        np.cumsum([len(k) for k in keys], out=offs[1:])
        return (np.frombuffer(blob, np.uint8) if blob
                else np.zeros(0, np.uint8)), offs

    @staticmethod
    def _unpack_keys(blob: np.ndarray, offs: np.ndarray) -> list[bytes]:
        raw = blob.tobytes()
        return [raw[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]

    def _intern_extra(self) -> dict:
        users, pages = self.encoder.dump_intern_tables()
        ub, uo = self._pack_keys(users)
        pb, po = self._pack_keys(pages)
        return {"user_blob": ub, "user_offs": uo,
                "page_blob": pb, "page_offs": po}

    def _restore_interns(self, snap: Snapshot) -> None:
        self.encoder.restore_intern_tables(
            self._unpack_keys(snap.extra["user_blob"],
                              snap.extra["user_offs"]),
            self._unpack_keys(snap.extra["page_blob"],
                              snap.extra["page_offs"]))

    def _now_rel(self) -> int:
        """The host clock rebased to the encoder's origin, clamped into
        int32: the one copy of the two-clock rebase of latency sampling."""
        base = self.encoder.base_time_ms or 0
        return int(np.clip(np.int64(now_ms()) - base, 0, 2**31 - 2))

    def _devmem_kernels(self) -> list:
        return []


class HLLDistinctEngine(_SketchEngineBase):
    """Distinct users per (campaign, window): BASELINE config #2.

    ``seen_count`` in the canonical Redis schema holds the distinct
    estimate; a re-flush of a still-open window replaces the previous
    estimate.  ``registers`` per (campaign, slot), 128 by default (the
    reference engine's)."""

    absolute_counts = True
    ENGINE_FAMILY = "hll"
    # HLL reads user identity only through a hash, so the encoder emits
    # stateless crc32 ids: the same in every pool worker and after a
    # restart, no intern tables, and the encode pool is sound again.
    HASHED_IDS = True
    NEEDS_INTERNED_IDS = False
    PARALLEL_ENCODE_OK = True
    SCAN_SUPPORTED = True
    SCAN_COLUMNS = ("ad_idx", "user_idx", "event_type", "event_time",
                    "valid")
    PACKED_EXTRA_COLS = ("user_idx",)

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 campaigns: list[str] | None = None,
                 redis: RedisLike | None = None,
                 registers: int = 128,
                 method: str | None = None,
                 device: torch.device | str | None = None):
        super().__init__(cfg, ad_to_campaign, campaigns=campaigns,
                         redis=redis, method=method, device=device)
        self.registers = registers
        self.state = hll.init_state(self.encoder.num_campaigns, self.W,
                                    num_registers=registers,
                                    device=self.device)
        # the estimates and window ids last handed to the writer
        self._flush_cache: tuple | None = None

    def _device_step(self, batch) -> None:
        self.state = hll.step(
            self.state, self.join_table,
            self._to_device(batch.ad_idx), self._to_device(batch.user_idx),
            self._to_device(batch.event_type),
            self._to_device(batch.event_time), self._to_device(batch.valid),
            divisor_ms=self.divisor, lateness_ms=self.lateness)

    def _device_scan(self, ad_idx, user_idx, event_type, event_time,
                     valid) -> None:
        self.state = hll.scan_steps(
            self.state, self.join_table, ad_idx, user_idx, event_type,
            event_time, valid, divisor_ms=self.divisor,
            lateness_ms=self.lateness)

    def _device_scan_packed(self, packed, user_idx, event_time) -> None:
        self.state = hll.scan_steps_packed(
            self.state, self.join_table, packed, user_idx, event_time,
            divisor_ms=self.divisor, lateness_ms=self.lateness)

    def snapshot(self, offset) -> Snapshot:
        self._snapshot_sync()
        meta = self._snapshot_meta()
        meta["num_registers"] = self.registers
        return self._xo_decorate(Snapshot(
            offset=offset, meta=meta,
            counts=np.zeros((0, 0), np.int32),  # registers live in extra
            window_ids=self.state.window_ids.cpu().numpy(),
            watermark=int(self.state.watermark),
            dropped=int(self.state.dropped),
            pending=[(c, ts, n) for (c, ts), n in self._pending.items()],
            latency=sorted(self.window_latency.items()),
            extra={"hll_registers": self.state.registers.cpu().numpy(),
                   **self._intern_extra()},
        ))

    def restore(self, snap: Snapshot) -> None:
        self._check_geometry(snap, extra={"num_registers": self.registers})
        self._flush_cache = None  # the drains after a restore rewrite all
        regs = np.asarray(snap.extra["hll_registers"])
        self.state = hll.HLLState(
            registers=torch.from_numpy(np.array(regs)).to(self.device),
            window_ids=torch.from_numpy(
                np.asarray(snap.window_ids, np.int32).copy()).to(
                    self.device),
            watermark=torch.tensor(int(snap.watermark), dtype=torch.int32,
                                   device=self.device),
            dropped=torch.tensor(int(snap.dropped), dtype=torch.int32,
                                 device=self.device))
        self._restore_interns(snap)
        self._restore_host(snap)

    def _drain_device(self) -> None:
        """Park the estimate block (nothing here waits for the card); it
        is absorbed at materialization (``_materialize_custom``).  Open
        windows keep their registers on the device, so the unflushed
        event-time span restarts at the oldest window that may still be
        open, from the host's watermark mirror."""
        est, wids, self.state = hll.flush(
            self.state, divisor_ms=self.divisor, lateness_ms=self.lateness)
        self._park(("hll", est, wids))
        self._span_start = self._oldest_open_span_start()

    def _materialize_custom(self, parked: tuple) -> None:
        tag, est_t, wids_t = parked
        if tag != "hll":
            raise ValueError(f"unknown parked drain tag {tag!r}")
        est = _to_numpy(est_t)
        wids = _to_numpy(wids_t)
        base = self.encoder.base_time_ms or 0
        # Rewrite only CHANGED estimates: rewriting an open window whose
        # registers saw no new user would advance its time_updated every
        # flush, and the latency metric (final time_updated - window_ts)
        # would read the window's lifetime in the ring.
        cache = self._flush_cache
        if cache is None or cache[0].shape != est.shape:
            cache = (np.zeros_like(est), np.full_like(wids, -2))
        prev_est, prev_wids = cache
        fresh_slot = wids != prev_wids                           # [W]
        changed = fresh_slot[None, :] | (est != prev_est)
        live = (est > 0) & changed & (wids >= 0)[None, :]
        ci, si = np.nonzero(live)
        if ci.size:
            self._pending_np.append(
                (ci.astype(np.int64),
                 base + wids[si].astype(np.int64) * self.divisor,
                 est[ci, si].astype(np.int64)))
        self._flush_cache = (est, wids)

    @property
    def dropped(self) -> int:
        return int(self.state.dropped)


class ReachSketchEngine(_SketchEngineBase):
    """Cumulative per-campaign reach sketches: a MinHash signature and an
    HLL plane (``ops.minhash``), served live.

    Unlike the windowed engines, reach state is *cumulative audience*:
    no ring, no lateness cutoff, nothing dropped.  ``flush()`` writes no
    window rows; it pushes the planes to an attached
    ``reach.serve.ReachQueryServer`` (``attach_reach``) and ships them to
    an attached replica shipper (``attach_shipper``) at its cadence.
    ``close()`` writes per-campaign reach estimates to
    ``<redis.hashtable>_reach``.  No count kernel runs on this path: the
    fold is the torch ops of ``minhash.step``.

    The fold updates the planes in place, so a push hands the server
    clones (``_reach_push``), and ``planes()``, snapshots and ship
    records carry the reference's uint32 / int32 numpy arrays.  With
    ``jax.obs.fleet`` each push carries the writer-attached freshness
    stamps (``_fleet_stamps``)."""

    ENGINE_FAMILY = "reach"
    # Reach reads user identity only through hashes (the HLL rationale):
    # stateless crc32 ids, the parallel encode pool is sound, snapshots
    # carry no intern tables.
    HASHED_IDS = True
    NEEDS_INTERNED_IDS = False
    PARALLEL_ENCODE_OK = True
    SCAN_SUPPORTED = True
    SCAN_COLUMNS = ("ad_idx", "user_idx", "event_type", "event_time",
                    "valid")
    PACKED_EXTRA_COLS = ("user_idx",)

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 campaigns: list[str] | None = None,
                 redis: RedisLike | None = None,
                 k: int | None = None, registers: int = 256,
                 method: str | None = None,
                 device: torch.device | str | None = None):
        super().__init__(cfg, ad_to_campaign, campaigns=campaigns,
                         redis=redis, method=method, device=device)
        self.k = int(k if k is not None else cfg.jax_reach_k)
        self.registers = int(registers)
        self.state = minhash.init_state(self.encoder.num_campaigns,
                                        self.k, self.registers,
                                        device=self.device)
        # no ring to overrun: the span guard would only send wide
        # catchup groups down the per-batch path
        self._span_guard = 2**31 - 1
        self._reach_server = None
        self._reach_shipper = None
        # the epoch of the served state: bumped on every restore, so an
        # answer computed before a crash recovery is told apart by it
        self.reach_epoch = 0
        # wall stamp of the last fold into the planes: a ship record's
        # fold stamp
        self._fold_wall_ms: int | None = None
        # host-side [C] mask of campaigns folded since the last ship,
        # unioned from the host columns each fold ships (no device
        # work); None until a delta shipper (wants_dirty) attaches
        self._dirty_mask: np.ndarray | None = None

    # -- dirty-row tracking --------------------------------------------
    def _mark_dirty(self, ad_idx, valid=None) -> None:
        """Union the campaigns of these host rows into the dirty mask.
        Marking a superset (rows a later predicate drops) is sound: a
        clean row shipped early is idempotent under the min/max
        merge."""
        m = self._dirty_mask
        if m is None:
            return
        ad = np.asarray(ad_idx).ravel()
        if valid is not None:
            v = np.asarray(valid).ravel().astype(bool)
            if v.size == ad.size:
                ad = ad[v]
        ad = ad[(ad >= 0) & (ad < self._join_np.size)]
        camp = self._join_np[ad]
        m[camp[(camp >= 0) & (camp < m.size)]] = True

    def _mark_dirty_packed(self, packed) -> None:
        if self._dirty_mask is None:
            return
        w = np.asarray(packed).ravel().astype(np.int64)
        valid = (w >> (wc.PACK_AD_BITS + 2)) & 1
        self._mark_dirty(w & (wc.PACK_AD_MAX - 1), valid)

    def _note_fold(self, cols: list, packed: bool) -> None:
        """Stamp a fold and union the host columns it shipped into the
        dirty mask: the packed word first, or the unpacked columns in
        ``SCAN_COLUMNS`` order (the ad index first, ``valid`` last)."""
        self._fold_wall_ms = now_ms()
        if self._dirty_mask is not None:
            if packed:
                self._mark_dirty_packed(cols[0])
            else:
                self._mark_dirty(cols[0], cols[-1])

    def _fold_stack(self, batches: list) -> list[np.ndarray]:
        stacks = super()._fold_stack(batches)
        self._note_fold(stacks, self._pack_ok)
        return stacks

    # -- the fold ------------------------------------------------------
    def _device_step(self, batch) -> None:
        self.state = minhash.step(
            self.state, self.join_table,
            self._to_device(batch.ad_idx), self._to_device(batch.user_idx),
            self._to_device(batch.event_type),
            self._to_device(batch.event_time), self._to_device(batch.valid))
        self._note_fold([batch.ad_idx, batch.valid], False)

    def _device_scan(self, ad_idx, user_idx, event_type, event_time,
                     valid) -> None:
        self.state = minhash.scan_steps(
            self.state, self.join_table, ad_idx, user_idx, event_type,
            event_time, valid)

    def _device_scan_packed(self, packed, user_idx, event_time) -> None:
        self.state = minhash.scan_steps_packed(
            self.state, self.join_table, packed, user_idx, event_time)

    def warmup(self) -> None:
        """The base warmup, plus the close-time estimate (read-only, so
        state-neutral)."""
        super().warmup()
        minhash.estimate(self.state.registers).cpu()

    # -- serving -------------------------------------------------------
    def query_callable(self):
        """The batch evaluator an attached query server dispatches
        through (the sharded engine swaps in its two-collective
        evaluation next to the shards)."""
        return rq.batch_query

    def attach_reach(self, server) -> None:
        """Wire a ReachQueryServer: hand it this engine's evaluator, push
        at once (possibly empty state: queries answer 0 until events
        fold), then push on every flush and on restore."""
        self._reach_server = server
        server.use_query_fn(self.query_callable())
        self._reach_push()

    def attach_shipper(self, shipper) -> None:
        """Wire a replica SnapshotShipper (or DeltaShipper): it ships from
        the same flush-cadence push.  The attach itself forces a ship, so
        a writer restarted mid-lineage reaches its replicas at once."""
        self._reach_shipper = shipper
        if getattr(shipper, "wants_dirty", False):
            self._dirty_mask = np.zeros(self.encoder.num_campaigns,
                                        dtype=bool)
        self._reach_push(force_ship=True)

    def planes(self) -> dict:
        """The named state planes a shipper consumes, as the reference's
        numpy arrays: ``mins`` uint32 ``[C, k]``, ``registers`` int32
        ``[C, R]`` (a device sync)."""
        return {"mins": minhash.mins_numpy(self.state.mins),
                "registers": self.state.registers.cpu().numpy().copy()}

    def _push_planes(self) -> tuple:
        """The ``(mins, registers)`` a push hands the server: clones, not
        the planes.  The fold updates them in place, so a server holding
        them could answer from a half-folded batch.  The clone runs on
        the fold's stream, ordered after the folds before this push and
        before every later one."""
        return self.state.mins.clone(), self.state.registers.clone()

    def _reach_push(self, force_ship: bool = False) -> None:
        if self._reach_server is not None:
            mins, registers = self._push_planes()
            self._reach_server.update_state(
                mins, registers, self.reach_epoch,
                freshness=self._fleet_stamps())
        sh = self._reach_shipper
        if sh is not None and (force_ship or sh.due(self.reach_epoch)):
            # the due() pre-check keeps the planes' pull (a device sync)
            # off the flushes between cadence ticks
            dirty = (np.flatnonzero(self._dirty_mask)
                     if self._dirty_mask is not None else None)
            planes = self.planes()
            shipped = sh.note_state(
                planes["mins"], planes["registers"], self.reach_epoch,
                int(self.state.watermark), force=force_ship,
                folded_ms=self._fold_wall_ms, dirty_rows=dirty)
            if shipped and self._dirty_mask is not None:
                # rows shipped (in a delta or under a base) are clean
                # until the next fold touches them
                self._dirty_mask[:] = False

    def _fleet_stamps(self) -> dict | None:
        """Writer-attached freshness stamps (``jax.obs.fleet``): the
        server answers against live planes, so submit/ship/load all
        collapse to the push stamp — only ``fold_lag`` (push minus last
        fold) and ``serve`` (reply minus push) have width.  None when
        fleet obs is off, keeping replies byte-identical."""
        if not getattr(self.cfg, "jax_obs_fleet", False):
            return None
        push = now_ms()
        return {"folded_ms": self._fold_wall_ms or push,
                "submit_ms": push, "shipped_ms": push,
                "loaded_ms": push}

    # -- harness hooks -------------------------------------------------
    def _drain_device(self) -> None:
        # nothing to drain: the sketches are cumulative, read (not
        # reset) at flush and close
        self._span_start = None

    def flush(self, time_updated: int | None = None, *,
              final: bool = False) -> int:
        self._reach_push()
        return 0    # reach writes no canonical window rows

    def estimates(self) -> np.ndarray:
        """Per-campaign distinct-device estimates ``[C]`` (HLL plane)."""
        return minhash.estimate(self.state.registers).cpu().numpy()

    def snapshot(self, offset) -> Snapshot:
        self._snapshot_sync()
        meta = self._snapshot_meta()
        meta.update(reach_k=self.k, num_registers=self.registers,
                    reach_epoch=self.reach_epoch)
        planes = self.planes()
        return self._xo_decorate(Snapshot(
            offset=offset, meta=meta,
            counts=np.zeros((0, 0), np.int32),
            window_ids=np.zeros((0,), np.int32),     # no window ring
            watermark=int(self.state.watermark),
            dropped=int(self.state.dropped),
            extra={"mh_mins": planes["mins"],
                   "hll_plane": planes["registers"],
                   **self._intern_extra()},
        ))

    def restore(self, snap: Snapshot) -> None:
        self._check_geometry(snap, extra=dict(
            reach_k=self.k, num_registers=self.registers))
        self.state = minhash.ReachState(
            mins=minhash.mins_tensor(snap.extra["mh_mins"], self.device),
            registers=torch.from_numpy(np.array(
                snap.extra["hll_plane"], np.int32)).to(self.device),
            watermark=torch.tensor(int(snap.watermark), dtype=torch.int32,
                                   device=self.device),
            dropped=torch.tensor(int(snap.dropped), dtype=torch.int32,
                                 device=self.device))
        self._restore_interns(snap)
        self._restore_host(snap)
        # every restore starts a serving epoch STRICTLY ABOVE both the
        # snapshot's and this engine's lineage: an answer computed
        # against pre-crash state is then told apart by its epoch
        self.reach_epoch = max(self.reach_epoch,
                               int(snap.meta.get("reach_epoch", 0))) + 1
        # the restart path ships at once: a replica behind a crashed
        # writer must not serve the pre-crash epoch for a whole interval
        self._reach_push(force_ship=True)

    def close(self) -> None:
        self._reach_push()
        if self._encode_pool is not None:
            self._encode_pool.close()
            self._encode_pool = None
        if self.redis is not None and self.cfg.redis_hashtable:
            est = self.estimates()
            table = f"{self.cfg.redis_hashtable}_reach"
            cmds = [("HSET", table, name, str(int(round(float(e)))))
                    for name, e in zip(self.encoder.campaigns, est)
                    if e > 0]
            if cmds:
                self.redis.pipeline_execute(cmds)

    @property
    def dropped(self) -> int:
        return int(self.state.dropped)


class HLLXEngine(_SketchEngineBase):
    """Distinct count AND frequency moments from one register plane: the
    hyper-extended HLL ladder (``ops.hllx``, ``--engine hllx``).

    Cumulative per campaign like the reach engine: no window ring,
    nothing drops; ``flush()`` writes no window rows and ``close()``
    writes ``<redis.hashtable>_hllx`` fields per campaign:
    ``<name>:distinct`` (rung-0 HLL), ``<name>:logm`` (the calibrated
    log-count moment), ``<name>:views`` (exact F1) and ``<name>:cap<T>``
    (the soft-capped count of each rung).  One scatter-max a batch; no
    count kernel runs on this path."""

    ENGINE_FAMILY = "hllx"
    # identity is read through hashes only (the HLL rationale): stateless
    # crc32 ids, the parallel encode pool is sound, no intern tables
    HASHED_IDS = True
    NEEDS_INTERNED_IDS = False
    PARALLEL_ENCODE_OK = True
    SCAN_SUPPORTED = True
    SCAN_COLUMNS = ("ad_idx", "user_idx", "event_type", "event_time",
                    "valid")
    PACKED_EXTRA_COLS = ("user_idx",)

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 campaigns: list[str] | None = None,
                 redis: RedisLike | None = None,
                 groups: int = 8, registers: int = 128,
                 method: str | None = None,
                 device: torch.device | str | None = None):
        super().__init__(cfg, ad_to_campaign, campaigns=campaigns,
                         redis=redis, method=method, device=device)
        self.groups = int(groups)
        self.registers = int(registers)
        self.state = hllx.init_state(self.encoder.num_campaigns,
                                     self.groups, self.registers,
                                     device=self.device)
        # no ring to overrun: the span guard would only send wide catchup
        # groups down the per-batch path
        self._span_guard = 2**31 - 1

    def _device_step(self, batch) -> None:
        self.state = hllx.step(
            self.state, self.join_table,
            self._to_device(batch.ad_idx), self._to_device(batch.user_idx),
            self._to_device(batch.event_type),
            self._to_device(batch.event_time), self._to_device(batch.valid))

    def _device_scan(self, ad_idx, user_idx, event_type, event_time,
                     valid) -> None:
        self.state = hllx.scan_steps(
            self.state, self.join_table, ad_idx, user_idx, event_type,
            event_time, valid)

    def _device_scan_packed(self, packed, user_idx, event_time) -> None:
        self.state = hllx.scan_steps_packed(
            self.state, self.join_table, packed, user_idx, event_time)

    def warmup(self) -> None:
        """The base warmup, plus the close-time moments (read-only, so
        state-neutral)."""
        super().warmup()
        hllx.moments(self.state)["distinct"].cpu()

    # -- harness hooks -------------------------------------------------
    def _drain_device(self) -> None:
        self._span_start = None   # cumulative: nothing to drain

    def flush(self, time_updated: int | None = None, *,
              final: bool = False) -> int:
        return 0    # no window rows

    def moments(self) -> dict:
        """Host copies of every ladder answer (``[C]`` / ``[C, G]``
        numpy arrays)."""
        return {k: v.cpu().numpy()
                for k, v in hllx.moments(self.state).items()}

    def snapshot(self, offset) -> Snapshot:
        self._snapshot_sync()
        meta = self._snapshot_meta()
        meta.update(hllx_groups=self.groups, num_registers=self.registers)
        return self._xo_decorate(Snapshot(
            offset=offset, meta=meta,
            counts=np.zeros((0, 0), np.int32),
            window_ids=np.zeros((0,), np.int32),     # no window ring
            watermark=int(self.state.watermark),
            dropped=int(self.state.dropped),
            extra={"hllx_registers": self.state.registers.cpu().numpy(),
                   "hllx_totals": self.state.totals.cpu().numpy(),
                   **self._intern_extra()},
        ))

    def restore(self, snap: Snapshot) -> None:
        self._check_geometry(snap, extra=dict(
            hllx_groups=self.groups, num_registers=self.registers))
        dev = self.device
        self.state = hllx.HLLXState(
            registers=torch.from_numpy(np.array(
                snap.extra["hllx_registers"])).to(dev),
            totals=torch.from_numpy(np.array(
                snap.extra["hllx_totals"], np.int32)).to(dev),
            watermark=torch.tensor(int(snap.watermark), dtype=torch.int32,
                                   device=dev),
            dropped=torch.tensor(int(snap.dropped), dtype=torch.int32,
                                 device=dev))
        self._restore_interns(snap)
        self._restore_host(snap)

    def close(self) -> None:
        if self._encode_pool is not None:
            self._encode_pool.close()
            self._encode_pool = None
        if self.redis is None or not self.cfg.redis_hashtable:
            return
        m = self.moments()
        table = f"{self.cfg.redis_hashtable}_hllx"
        caps = [1 << g for g in range(self.groups)]
        cmds = []
        for c, name in enumerate(self.encoder.campaigns):
            if m["totals"][c] <= 0:
                continue
            cmds.append(("HSET", table, f"{name}:distinct",
                         str(int(round(float(m["distinct"][c]))))))
            cmds.append(("HSET", table, f"{name}:logm",
                         f"{float(m['log_moment'][c]):.1f}"))
            cmds.append(("HSET", table, f"{name}:views",
                         str(int(m["totals"][c]))))
            for g, t in enumerate(caps):
                cmds.append(("HSET", table, f"{name}:cap{t}",
                             f"{float(m['softcap'][c, g]):.1f}"))
        if cmds:
            self.redis.pipeline_execute(cmds)

    @property
    def dropped(self) -> int:
        return int(self.state.dropped)

def _sliced_auto(device_type: str, S: int, C: int, W: int) -> bool:
    """``jax.sliding.sliced: auto``: the sliced fold wherever its
    ``[C, S, W]`` plane fits (at most 2^27 cells) and the sliding-family
    winner of this device type measured at this ``[C, W]``
    (``ops.methodbench``, ``<device type>/sliding/S<S>``) does not say
    otherwise; unmeasured geometries take it."""
    if S > W or C * S * W > (1 << 27):
        return False
    try:
        from streambench_tpu_torch.ops import methodbench

        winner = methodbench.sliding_winner(device_type, S, C, W)
    except Exception:
        winner = None
    return winner is None or winner == "sliced"


# ----------------------------------------------------------------------
# The fused sliding + t-digest programs of the JAX engine, as loops over
# a chunk's batches.  Latency samples are taken against one ``now_rel``
# stamp per chunk (or per batch on the per-batch path); the scans
# accumulate them in the value-bucketed histogram and compress into the
# digest once at the end.

def _latency_sample(join_table, now_rel: int, ad_idx, event_type,
                    event_time, valid):
    """(campaign key, latency ms, views mask) of one batch."""
    lat = torch.clamp(now_rel - event_time, min=0)
    campaign = wc.gather_rows(join_table, ad_idx)
    mask = valid & (event_type == 0) & (campaign >= 0)
    return campaign, lat, mask


def _scan(step, win_state, digest, join_table, now_rel, batches, *,
          size_ms, slide_ms, lateness_ms, method):
    """Fold ``batches`` (an iterable of ``(ad_idx, event_type,
    event_time, valid)``) with ``step`` and one histogram absorb."""
    N = digest.means.shape[0]
    hn, hw = tdigest.hist_init(N, device=digest.means.device)
    for a, et, t, v in batches:
        win_state = step(win_state, join_table, a, et, t, v,
                         size_ms=size_ms, slide_ms=slide_ms,
                         lateness_ms=lateness_ms, method=method)
        campaign, lat, mask = _latency_sample(join_table, now_rel, a, et,
                                              t, v)
        w = torch.where(mask, 1.0, 0.0)
        hn, hw = tdigest.fold_hist(hn, hw, campaign, lat, w, N)
    return win_state, tdigest.absorb_hist(digest, hn, hw)


def _columns(ad_idx, event_type, event_time, valid):
    return ((ad_idx[k], event_type[k], event_time[k], valid[k])
            for k in range(ad_idx.shape[0]))


def _packed(packed, event_time):
    for k in range(packed.shape[0]):
        a, et, v = wc.unpack_columns(packed[k])
        yield a, et, event_time[k], v


def _sliding_tdigest_scan(win_state, digest, join_table, now_rel,
                          ad_idx, event_type, event_time, valid, *,
                          size_ms: int, slide_ms: int, lateness_ms: int,
                          method: str = "scatter"):
    """Unsliced sliding fold + t-digest over ``[N, B]`` batches."""
    return _scan(sliding.step, win_state, digest, join_table, now_rel,
                 _columns(ad_idx, event_type, event_time, valid),
                 size_ms=size_ms, slide_ms=slide_ms,
                 lateness_ms=lateness_ms, method=method)


def _sliding_tdigest_scan_packed(win_state, digest, join_table, now_rel,
                                 packed, event_time, *, size_ms: int,
                                 slide_ms: int, lateness_ms: int,
                                 method: str = "scatter"):
    """``_sliding_tdigest_scan`` over the packed wire word (8 B an
    event)."""
    return _scan(sliding.step, win_state, digest, join_table, now_rel,
                 _packed(packed, event_time), size_ms=size_ms,
                 slide_ms=slide_ms, lateness_ms=lateness_ms, method=method)


def _sliding_tdigest_scan_sliced(win_state, digest, join_table, now_rel,
                                 ad_idx, event_type, event_time, valid, *,
                                 size_ms: int, slide_ms: int,
                                 lateness_ms: int,
                                 method: str = "scatter"):
    """The sliced fold (one claim + one K1 count a batch) + t-digest."""
    return _scan(sliding.step_sliced_core, win_state, digest, join_table,
                 now_rel, _columns(ad_idx, event_type, event_time, valid),
                 size_ms=size_ms, slide_ms=slide_ms,
                 lateness_ms=lateness_ms, method=method)


def _sliding_tdigest_scan_sliced_packed(win_state, digest, join_table,
                                        now_rel, packed, event_time, *,
                                        size_ms: int, slide_ms: int,
                                        lateness_ms: int,
                                        method: str = "scatter"):
    """The sliced fold over the packed wire word."""
    return _scan(sliding.step_sliced_core, win_state, digest, join_table,
                 now_rel, _packed(packed, event_time), size_ms=size_ms,
                 slide_ms=slide_ms, lateness_ms=lateness_ms, method=method)


def _sliding_tdigest_step(win_state, digest, join_table, now_rel,
                          ad_idx, event_type, event_time, valid, *,
                          size_ms: int, slide_ms: int, lateness_ms: int,
                          sliced: bool, method: str = "scatter"):
    """The per-batch fold + latency sample (the sort-based
    ``tdigest.update``, O(N*K) memory at any key count)."""
    step = sliding.step_sliced_core if sliced else sliding.step
    st = step(win_state, join_table, ad_idx, event_type, event_time,
              valid, size_ms=size_ms, slide_ms=slide_ms,
              lateness_ms=lateness_ms, method=method)
    campaign, lat, mask = _latency_sample(join_table, now_rel, ad_idx,
                                          event_type, event_time, valid)
    return st, tdigest.update(digest, campaign, lat, mask)


class SlidingTDigestEngine(_SketchEngineBase):
    """Sliding-window view counts + per-campaign latency t-digest:
    BASELINE config #3 (10 s windows sliding by 1 s).

    Window rows use the canonical schema with ``window_ts`` = the
    slide-aligned window START; counts are deltas (HINCRBY), as the exact
    engine's.  At close the per-campaign latency quantiles land in the
    hash ``<redis.hashtable>_quantiles`` as ``<campaign>:p<q>``."""

    QUANTILES = (0.5, 0.9, 0.99)
    ENGINE_FAMILY = "sliding_tdigest"
    SCAN_SUPPORTED = True
    # the fold reads neither user nor page columns: no interning, and
    # per-thread encoders are sound
    NEEDS_INTERNED_IDS = False
    PARALLEL_ENCODE_OK = True

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 campaigns: list[str] | None = None,
                 redis: RedisLike | None = None,
                 size_ms: int | None = None, slide_ms: int = 1_000,
                 window_slots: int | None = None,
                 compression: int = 64,
                 sliced: str | None = None,
                 method: str | None = None,
                 device: torch.device | str | None = None):
        size = size_ms if size_ms is not None else cfg.jax_time_divisor_ms
        late_eff = sliding.effective_lateness(size, slide_ms,
                                              cfg.jax_allowed_lateness_ms)
        n_campaigns = (len(campaigns) if campaigns
                       else len(set(ad_to_campaign.values())))
        W = window_slots or sliding.ring_slots(
            n_campaigns, size, slide_ms, cfg.jax_allowed_lateness_ms)
        cfg2 = dataclasses.replace(
            cfg, jax_window_slots=W, jax_time_divisor_ms=slide_ms,
            jax_allowed_lateness_ms=late_eff)
        super().__init__(cfg2, ad_to_campaign, campaigns=campaigns,
                         redis=redis, method=method, device=device)
        self.size_ms = size
        self.slide_ms = slide_ms
        self.base_lateness = cfg.jax_allowed_lateness_ms
        mode = (sliced if sliced is not None
                else getattr(cfg, "jax_sliding_sliced", "auto"))
        mode = str(mode).strip().lower()
        if mode not in ("off", "on", "auto"):
            raise ValueError(f"sliced must be off/on/auto: {mode!r}")
        S = size // slide_ms
        if mode == "auto":
            self.sliced = _sliced_auto(self.device.type, S,
                                       self.encoder.num_campaigns, self.W)
        else:
            self.sliced = mode == "on"
        if self.sliced:
            self.state = sliding.init_sliced(self.encoder.num_campaigns,
                                             self.W, S, device=self.device)
        self.digest = tdigest.init_state(self.encoder.num_campaigns,
                                         compression=compression,
                                         device=self.device)
        # the scan's [C, HIST_BINS] x2 float32 histogram is 8 KB a
        # campaign: past 2^24 cells the per-batch sort-based fold
        # (O(C*K) memory) takes over
        if self.encoder.num_campaigns * tdigest.HIST_BINS > (1 << 24):
            self.SCAN_SUPPORTED = False

    def _fold_kw(self) -> dict:
        return dict(size_ms=self.size_ms, slide_ms=self.slide_ms,
                    lateness_ms=self.base_lateness, method=self.method)

    def _device_scan(self, ad_idx, event_type, event_time, valid) -> None:
        fn = (_sliding_tdigest_scan_sliced if self.sliced
              else _sliding_tdigest_scan)
        self.state, self.digest = fn(
            self.state, self.digest, self.join_table, self._now_rel(),
            ad_idx, event_type, event_time, valid, **self._fold_kw())

    def _device_scan_packed(self, packed, event_time) -> None:
        fn = (_sliding_tdigest_scan_sliced_packed if self.sliced
              else _sliding_tdigest_scan_packed)
        self.state, self.digest = fn(
            self.state, self.digest, self.join_table, self._now_rel(),
            packed, event_time, **self._fold_kw())

    def _device_step(self, batch) -> None:
        # One fold + latency sample per batch.  TWO-CLOCK CAVEAT: now_ms()
        # is this host's clock and event_time the generator's, as in the
        # reference (core.clj:149 subtracts them the same way); the clamp
        # only keeps negative skew out of the digest.
        self.state, self.digest = _sliding_tdigest_step(
            self.state, self.digest, self.join_table, self._now_rel(),
            self._to_device(batch.ad_idx), self._to_device(batch.event_type),
            self._to_device(batch.event_time), self._to_device(batch.valid),
            sliced=self.sliced, **self._fold_kw())

    def _track_dirty_rows(self) -> bool:
        # the sliced drain reconstructs windows from the whole plane
        return False if self.sliced else super()._track_dirty_rows()

    def _drain_device(self) -> None:
        if not self.sliced:
            return super()._drain_device()
        # window deltas rebuilt on the device (flush_deltas' contract),
        # parked for the shared dense materialization
        deltas, wids, self.state = sliding.flush_sliced(
            self.state, size_ms=self.size_ms, slide_ms=self.slide_ms,
            lateness_ms=self.base_lateness)
        self._park(("dense", deltas, wids))
        self._span_start = None

    def _devmem_kernels(self) -> list:
        """K1's footprint on the sliced fold's ``[C*S, W]`` plane at the
        step's B rows (the unsliced fold's factored product launches no
        hand-written kernel)."""
        if (not self.sliced or self.method != "kernel"
                or self.device.type != "cuda"):
            return []
        B = self.batch_size
        C, S, W = self.state.counts.shape
        plan = count_ops.launch_plan(
            B, C * S, W, (0, 0, 0),
            *count_ops.device_limits(self.device.index or 0))
        plane = C * S * W * 4
        args = 4 * B + 4 * B + B + count_ops.PLAN_BYTES
        return [("count_cells", {
            "supported": True, "rows": B, "tier": plan.tier,
            "blocks": plan.blocks, "threads": plan.threads,
            "smem_bytes": plan.smem_bytes, "argument_bytes": args,
            "output_bytes": plane, "alias_bytes": plane, "temp_bytes": 0,
            "total_bytes": args + plane})]

    def snapshot(self, offset) -> Snapshot:
        self._snapshot_sync()
        meta = self._snapshot_meta()
        meta.update(size_ms=self.size_ms, slide_ms=self.slide_ms,
                    compression=int(self.digest.means.shape[1]),
                    sliced=int(self.sliced))
        # the sliced plane rides the counts slot flattened to [C, S*W]
        counts = self.state.counts.cpu().numpy()
        if self.sliced:
            counts = counts.reshape(counts.shape[0], -1)
        return self._xo_decorate(Snapshot(
            offset=offset, meta=meta,
            counts=counts,
            window_ids=self.state.window_ids.cpu().numpy(),
            watermark=int(self.state.watermark),
            dropped=int(self.state.dropped),
            pending=[(c, ts, n) for (c, ts), n in self._pending.items()],
            latency=sorted(self.window_latency.items()),
            extra={"td_means": self.digest.means.cpu().numpy(),
                   "td_weights": self.digest.weights.cpu().numpy(),
                   **self._intern_extra()},
        ))

    def restore(self, snap: Snapshot) -> None:
        self._check_geometry(snap, extra=dict(
            size_ms=self.size_ms, slide_ms=self.slide_ms,
            compression=int(self.digest.means.shape[1]),
            sliced=int(self.sliced)))
        self.state = self._put_state(
            snap.counts, snap.window_ids, snap.watermark, snap.dropped)
        self.digest = tdigest.TDigestState(*(
            torch.from_numpy(np.array(snap.extra[k], np.float32)).to(
                self.device) for k in ("td_means", "td_weights")))
        self._restore_interns(snap)
        self._restore_host(snap)

    def _put_state(self, counts, window_ids, watermark, dropped):
        if not self.sliced:
            return super()._put_state(counts, window_ids, watermark,
                                      dropped)
        S = self.size_ms // self.slide_ms
        plane = np.asarray(counts, np.int32).reshape(-1, S, self.W)
        st = wc.state_from_numpy((plane, window_ids, watermark, dropped),
                                 self.device)
        return sliding.SlicedWindowState(*st)

    def quantiles(self) -> np.ndarray:
        """Per-campaign latency quantiles ``[C, len(QUANTILES)]`` (ms)."""
        qs = torch.tensor(self.QUANTILES, dtype=torch.float32)
        return tdigest.quantile(self.digest, qs).cpu().numpy()

    def close(self) -> None:
        super().close()
        if self.redis is not None and self.cfg.redis_hashtable:
            q = self.quantiles()
            table = f"{self.cfg.redis_hashtable}_quantiles"
            cmds = [("HSET", table, f"{name}:p{int(qq * 100)}",
                     f"{q[c, j]:.1f}")
                    for c, name in enumerate(self.encoder.campaigns)
                    for j, qq in enumerate(self.QUANTILES)]
            self.redis.pipeline_execute(cmds)


# ----------------------------------------------------------------------
# BASELINE #4: session windows + count-min heavy hitters

def _cms_auto(device_type: str, width: int) -> str:
    """``jax.cms.mode: auto``: the SALSA plane where the cms-family winner
    of this device type measured at this width (``ops.methodbench``,
    ``<device type>/cms/W<Wd>``) is its update; fixed otherwise (auto picks
    by speed; a memory-motivated deployment sets ``salsa``)."""
    try:
        from streambench_tpu_torch.ops import methodbench

        winner = methodbench.cms_winner(device_type, width)
    except Exception:
        winner = None
    return "salsa" if winner == "salsa" else "fixed"


# The close->absorb latency histogram: 250 ms bins to 120 s and one
# overflow bin.  A histogram keeps the hot path free of host syncs;
# quantiles are read from it at report time.
LAT_BIN_MS = 250
LAT_BINS = 481


def _hist_scalar(hist: torch.Tensor, lat: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """All rows share one latency (their closure was decided by this
    batch): one clipped bin, one add, in place."""
    b = torch.clamp(torch.div(lat, LAT_BIN_MS, rounding_mode="floor"), 0,
                    LAT_BINS - 1)
    hist.index_add_(0, b.reshape(1).to(torch.int64),
                    valid.sum(dtype=torch.int32).reshape(1))
    return hist


def _hist_rows(hist: torch.Tensor, lat: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Per-row latencies (time-expired closures), in place: a row that is
    not valid adds 0 to its bin (the reference drops it)."""
    b = torch.clamp(torch.div(lat, LAT_BIN_MS, rounding_mode="floor"), 0,
                    LAT_BINS - 1)
    hist.index_add_(0, b.to(torch.int64), valid.to(torch.int32))
    return hist


def _det_lat(now_rel: int, event_time: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """The latency of closures this batch decided: the host stamp at
    dispatch less the batch's newest event time, in int32 as the
    reference computes it (it may wrap for an all-invalid batch, whose
    closures are none)."""
    newest = torch.where(valid, event_time, wc.NEG).max()
    return torch.clamp(now_rel - newest, min=0)


def _counted(ck_acc, closed: session.ClosedSessions):
    """The device counters with the closed sessions and their clicks."""
    n = closed.valid.sum(dtype=torch.int32)
    c = torch.where(closed.valid, closed.clicks, 0).sum(dtype=torch.int32)
    return ck_acc[0] + n, ck_acc[1] + c


def _absorb_closed(cm, ck_acc, closed: session.ClosedSessions):
    """Fold closed sessions into the sketch and the device counters."""
    cm = cms.sk_update(cm, closed.user, closed.clicks, closed.valid)
    return cm, _counted(ck_acc, closed)


def _session_cms_scan(sess_state, cms_state, topk_state, closed_n,
                      clicks_n, lat_hist, now_rel: int, salt: int,
                      user_idx, event_type, event_time, valid, *,
                      gap_ms: int, lateness_ms: int):
    """The session + CMS + heavy-hitter fold over ``[N, B]`` batches: per
    batch the session step, then for each closed set the sketch update
    and the query of its users (``cms.update_query``: one K3 call for
    the fixed and two-stage sketches), the counters, the latency bin and
    the candidate fold; the candidate table merges into the ring once,
    after the loop.  No host sync.

    ``salt`` must differ chunk to chunk (the engine passes a sequence
    number), so a hash collision in the candidate table never shadows the
    same pair of keys twice.  Returns (session state, sketch, ring,
    closed count, click count, histogram)."""
    M2 = 1 << (4 * topk_state.keys.shape[0] - 1).bit_length()
    ckeys, cests = cms.init_candidates(M2, device=lat_hist.device)
    st, cm, acc, hist = sess_state, cms_state, (closed_n, clicks_n), lat_hist
    for k in range(user_idx.shape[0]):
        v, t = valid[k], event_time[k]
        st, in_batch, carried = session.step(
            st, user_idx[k], event_type[k], t, v, gap_ms=gap_ms,
            lateness_ms=lateness_ms)
        det_lat = _det_lat(now_rel, t, v)
        for closed in (in_batch, carried):
            cm, est = cms.update_query(cm, closed.user, closed.clicks,
                                       closed.valid)
            acc = _counted(acc, closed)
            hist = _hist_scalar(hist, det_lat, closed.valid)
            ckeys, cests = cms.fold_candidates(
                ckeys, cests, closed.user, est, closed.valid, salt)
    tk = cms.update_topk(cm, topk_state, ckeys, ckeys >= 0)
    return st, cm, tk, acc[0], acc[1], hist


class SessionCMSEngine(_SketchEngineBase):
    """Per-user session click aggregation + count-min heavy hitters:
    BASELINE config #4 ("session-window per-user click aggregation
    (gap=30s) with count-min heavy-hitter sketch").

    Closed sessions (in a batch, carried, or expired by the watermark)
    feed the sketch keyed by user with the session's clicks as weight;
    ``close()`` writes the top-k user estimates to
    ``<redis.hashtable>_hh``.  The sketch family follows
    ``jax.cms.mode`` (fixed, salsa, auto), ``jax.cms.cell.bits`` and
    ``jax.cms.stages`` (2: the two-stage sketch; not with salsa).  No
    window rows are written: ``flush`` drains expired sessions and
    returns 0."""

    ENGINE_FAMILY = "session_cms"
    SCAN_SUPPORTED = True
    SCAN_COLUMNS = ("user_idx", "event_type", "event_time", "valid")

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 campaigns: list[str] | None = None,
                 redis: RedisLike | None = None,
                 gap_ms: int = 30_000, user_capacity: int = 1 << 16,
                 cms_depth: int = 4, cms_width: int = 2048,
                 top_k: int = 16, candidate_capacity: int | None = None,
                 cms_mode: str | None = None,
                 cms_stages: int | None = None,
                 cms_cell_bits: int | None = None,
                 method: str | None = None,
                 device: torch.device | str | None = None):
        super().__init__(cfg, ad_to_campaign, campaigns=campaigns,
                         redis=redis, method=method, device=device)
        # the fold reads unpacked columns (user ids among them): no
        # packed wire word on this engine
        self._pack_ok = False
        self.gap_ms = gap_ms
        self.user_capacity = user_capacity
        self.top_k = top_k
        self.state = session.init_state(user_capacity, device=self.device)
        mode = str(cms_mode if cms_mode is not None
                   else getattr(cfg, "jax_cms_mode", "fixed")
                   ).strip().lower()
        if mode not in ("fixed", "salsa", "auto"):
            raise ValueError(f"cms_mode must be fixed/salsa/auto: {mode!r}")
        stages = int(cms_stages if cms_stages is not None
                     else getattr(cfg, "jax_cms_stages", 1))
        bits = int(cms_cell_bits if cms_cell_bits is not None
                   else getattr(cfg, "jax_cms_cell_bits", 8))
        if mode == "auto":
            mode = _cms_auto(self.device.type, cms_width)
        if mode == "salsa" and stages == 2:
            raise ValueError(
                "jax.cms.mode=salsa does not compose with "
                "jax.cms.stages=2: the SF small stage refreshes from "
                "fat-stage estimates, pick one counter design")
        self.cms_mode = mode
        self.cms_stages = stages
        self.cms_cell_bits = bits
        if mode == "salsa":
            self.cms = salsa.init_state(depth=cms_depth, width=cms_width,
                                        cell_bits=bits, device=self.device)
        elif stages == 2:
            self.cms = cms.init_two_stage(depth=cms_depth, width=cms_width,
                                          device=self.device)
        else:
            self.cms = cms.init_state(depth=cms_depth, width=cms_width,
                                      device=self.device)
        # the device-side candidate ring: report cost O(ring), not
        # O(interned users)
        self.topk = cms.init_topk(candidate_capacity or max(8 * top_k, 128),
                                  device=self.device)
        self.sessions_closed = 0
        self.session_clicks = 0
        self.lat_hist = torch.zeros(LAT_BINS, dtype=torch.int32,
                                    device=self.device)
        # no window ring: the span guard would only send wide catchup
        # groups down the per-batch path
        self._span_guard = 2**31 - 1
        # the candidate table's per-chunk salt: a sequence number
        self._scan_seq = 0

    # counters live on the device: absorbing never blocks, reading does
    @property
    def sessions_closed(self) -> int:
        return int(self._closed_dev)

    @sessions_closed.setter
    def sessions_closed(self, v: int) -> None:
        self._closed_dev = torch.tensor(v, dtype=torch.int32,
                                        device=self.device)

    @property
    def session_clicks(self) -> int:
        return int(self._clicks_dev)

    @session_clicks.setter
    def session_clicks(self, v: int) -> None:
        self._clicks_dev = torch.tensor(v, dtype=torch.int32,
                                        device=self.device)

    def _device_scan(self, user_idx, event_type, event_time, valid) -> None:
        self._scan_seq += 1
        (self.state, self.cms, self.topk, self._closed_dev,
         self._clicks_dev, self.lat_hist) = _session_cms_scan(
            self.state, self.cms, self.topk, self._closed_dev,
            self._clicks_dev, self.lat_hist, self._now_rel(),
            self._scan_seq, user_idx, event_type, event_time, valid,
            gap_ms=self.gap_ms, lateness_ms=self.lateness)

    def _cms_shape(self) -> tuple[int, int]:
        """[D, Wd] of the primary counter plane, any family."""
        t = (self.cms.fat.table if isinstance(self.cms, cms.CMS2State)
             else self.cms.table)
        return int(t.shape[0]), int(t.shape[1])

    def snapshot(self, offset) -> Snapshot:
        self._snapshot_sync()
        meta = self._snapshot_meta()
        depth, width = self._cms_shape()
        meta.update(gap_ms=self.gap_ms, user_capacity=self.user_capacity,
                    cms_depth=depth, cms_width=width,
                    cms_total=int(cms.sk_total(self.cms)),
                    cms_mode=self.cms_mode, cms_stages=self.cms_stages,
                    sessions_closed=self.sessions_closed,
                    session_clicks=self.session_clicks,
                    # the candidate salt's sequence, so a resumed run
                    # salts its chunks as the uninterrupted one does
                    scan_seq=self._scan_seq)
        if self.cms_mode == "salsa":
            sketch = {"cms_table": self.cms.table, "cms_m1": self.cms.m1,
                      "cms_m2": self.cms.m2}
        elif self.cms_stages == 2:
            sketch = {"cms_table": self.cms.fat.table,
                      "cms_small": self.cms.small}
        else:
            sketch = {"cms_table": self.cms.table}
        arrays = {"sess_last": self.state.last_time,
                  "sess_start": self.state.sess_start,
                  "sess_clicks": self.state.clicks, **sketch,
                  "hh_keys": self.topk.keys, "hh_ests": self.topk.ests,
                  "lat_hist": self.lat_hist}
        # copies: the sketch and histogram are updated in place
        extra = {k: v.cpu().numpy().copy() for k, v in arrays.items()}
        return self._xo_decorate(Snapshot(
            offset=offset, meta=meta,
            counts=np.zeros((0, 0), np.int32),
            window_ids=np.zeros((0,), np.int32),     # no window ring
            watermark=int(self.state.watermark),
            dropped=int(self.state.dropped),
            extra={**extra, **self._intern_extra()},
        ))

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=dtype)).to(self.device)

    def restore(self, snap: Snapshot) -> None:
        depth, width = self._cms_shape()
        self._check_geometry(snap, extra=dict(
            gap_ms=self.gap_ms, user_capacity=self.user_capacity,
            cms_depth=depth, cms_width=width,
            cms_stages=self.cms_stages))
        # legacy snapshots predate the mode key: they are "fixed"
        snap_mode = str(snap.meta.get("cms_mode", "fixed"))
        if snap_mode != self.cms_mode:
            raise ValueError(
                f"checkpoint cms_mode={snap_mode!r} != engine "
                f"{self.cms_mode!r}; restart with the original "
                "jax.cms.mode or discard the checkpoint")
        x = snap.extra
        i32 = np.int32

        def scalar(v) -> torch.Tensor:
            return torch.tensor(int(v), dtype=torch.int32,
                                device=self.device)

        self.state = session.SessionState(
            last_time=self._tensor(x["sess_last"], i32),
            sess_start=self._tensor(x["sess_start"], i32),
            clicks=self._tensor(x["sess_clicks"], i32),
            watermark=scalar(snap.watermark), dropped=scalar(snap.dropped))
        total = scalar(snap.meta["cms_total"])
        if self.cms_mode == "salsa":
            self.cms = salsa.SalsaState(
                table=self._tensor(x["cms_table"], np.uint8),
                m1=self._tensor(x["cms_m1"], np.uint8),
                m2=self._tensor(x["cms_m2"], np.uint8), total=total)
        elif self.cms_stages == 2:
            self.cms = cms.CMS2State(
                fat=cms.CMSState(table=self._tensor(x["cms_table"], i32),
                                 total=total),
                small=self._tensor(x["cms_small"], i32))
        else:
            self.cms = cms.CMSState(table=self._tensor(x["cms_table"], i32),
                                    total=total)
        self.sessions_closed = int(snap.meta["sessions_closed"])
        self.session_clicks = int(snap.meta["session_clicks"])
        # absent from the reference's snapshots, whose resume restarts it
        self._scan_seq = int(snap.meta.get("scan_seq", 0))
        self.lat_hist = (self._tensor(x["lat_hist"], i32)
                         if "lat_hist" in x
                         else torch.zeros(LAT_BINS, dtype=torch.int32,
                                          device=self.device))
        self._restore_interns(snap)
        self._restore_host(snap)
        if "hh_keys" in x:
            self.topk = cms.TopKState(keys=self._tensor(x["hh_keys"], i32),
                                      ests=self._tensor(x["hh_ests"], i32))
        else:
            # a snapshot from before the candidate ring: seed the ring
            # once from the restored intern universe, or the pre-crash
            # heavy hitters would vanish until they reappeared
            self._seed_topk_from_universe()

    def _seed_topk_from_universe(self, chunk: int = 8192) -> None:
        n = self.encoder.num_interned_users()
        for off in range(0, n, chunk):
            width = min(chunk, n - off)
            keys = np.zeros(chunk, np.int32)
            keys[:width] = np.arange(off, off + width, dtype=np.int32)
            mask = np.zeros(chunk, bool)
            mask[:width] = True
            self.topk = cms.update_topk(self.cms, self.topk,
                                        self._to_device(keys),
                                        self._to_device(mask))

    def _absorb(self, closed: session.ClosedSessions) -> None:
        self.cms, (self._closed_dev, self._clicks_dev) = _absorb_closed(
            self.cms, (self._closed_dev, self._clicks_dev), closed)
        self.topk = cms.update_topk(self.cms, self.topk, closed.user,
                                    closed.valid)

    def _device_step(self, batch) -> None:
        valid = self._to_device(batch.valid)
        tm = self._to_device(batch.event_time)
        self.state, in_batch, carried = session.step(
            self.state, self._to_device(batch.user_idx),
            self._to_device(batch.event_type), tm, valid,
            gap_ms=self.gap_ms, lateness_ms=self.lateness)
        det_lat = _det_lat(self._now_rel(), tm, valid)
        for closed in (in_batch, carried):
            self._absorb(closed)
            self.lat_hist = _hist_scalar(self.lat_hist, det_lat,
                                         closed.valid)

    def _drain_device(self) -> None:
        self.state, expired = session.flush(
            self.state, gap_ms=self.gap_ms, lateness_ms=self.lateness)
        self._absorb(expired)
        # a time-expired closure became decidable when the watermark
        # passed end + gap + lateness: its latency is the stamp less that
        due = expired.end + (self.gap_ms + self.lateness)
        self.lat_hist = _hist_rows(
            self.lat_hist, torch.clamp(self._now_rel() - due, min=0),
            expired.valid)
        self._span_start = None

    def flush(self, time_updated: int | None = None, *,
              final: bool = False) -> int:
        self._drain_device()
        return 0    # sessions write no canonical window rows

    def latency_quantile(self, qs) -> tuple[list[float], int]:
        """Close->absorb latency quantiles (ms) from the histogram,
        linearly interpolated within 250 ms bins; the overflow bin
        reports its lower edge.  Returns ``(values, sessions sampled)``."""
        hist = self.lat_hist.cpu().numpy().astype(np.int64)
        total = int(hist.sum())
        if total == 0:
            return [], 0
        cum = np.cumsum(hist)
        out = []
        for q in qs:
            target = q * total
            b = min(int(np.searchsorted(cum, target, side="left")),
                    LAT_BINS - 1)
            prev = int(cum[b - 1]) if b else 0
            frac = ((target - prev) / max(int(hist[b]), 1)
                    if b < LAT_BINS - 1 else 0.0)
            out.append((b + min(max(frac, 0.0), 1.0)) * LAT_BIN_MS)
        return out, total

    def heavy_hitters(self) -> list[tuple[str, int]]:
        """Top-k (user, estimated clicks), estimates > 0 only: the ring's
        keys re-queried against the final sketch; only the winners are
        looked up by name."""
        ring_keys = self.topk.keys.cpu().numpy()
        cand = ring_keys[ring_keys >= 0]
        if cand.size == 0:
            return []
        vals, idx = cms.heavy_hitters(self.cms, self._to_device(cand),
                                      k=min(self.top_k, int(cand.size)))
        out = []
        for v, i in zip(vals.cpu().numpy(), idx.cpu().numpy()):
            if v > 0:
                u = self.encoder.user_key(int(cand[int(i)]))
                out.append((u.decode() if isinstance(u, bytes) else u,
                            int(v)))
        return out

    def _write_heavy_hitters(self) -> None:
        """Top-k estimates -> the Redis hash ``<redis.hashtable>_hh``."""
        if self.redis is not None and self.cfg.redis_hashtable:
            table = f"{self.cfg.redis_hashtable}_hh"
            cmds = [("HSET", table, user, str(est))
                    for user, est in self.heavy_hitters()]
            if cmds:
                self.redis.pipeline_execute(cmds)

    def close(self) -> None:
        self.state, final = session.flush(
            self.state, gap_ms=self.gap_ms, lateness_ms=self.lateness,
            force=True)
        self._absorb(final)
        self._write_heavy_hitters()

    def sketch_summary(self, merges: bool = False) -> dict:
        """Sketch-memory census for the stats line and the obs report:
        family and state bytes (host-side reads, no device sync); with
        ``merges=True`` (close-time callers only: it waits for the card)
        SALSA's widened-counter counts."""
        from streambench_tpu_torch.obs.devmem import state_nbytes

        out = {"mode": self.cms_mode, "stages": self.cms_stages,
               "state_bytes": state_nbytes(self.cms)}
        if merges and self.cms_mode == "salsa":
            out.update(salsa.stats(self.cms))
        return out

    @property
    def dropped(self) -> int:
        return int(self.state.dropped)
