"""Sketch-aggregation engines: BASELINE configs #2 and #3.

The port of ``streambench_tpu/engine/sketches.py``'s HLL and sliding
engines.  The host loop, encoder, Redis writer, runner and harness are
the exact engine's (``engine.pipeline.AdAnalyticsEngine``); only the
device state and its fold change:

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

The JAX engines fuse each chunk's fold into one jitted program; here the
five programs are plain functions that loop over the chunk's batches, as
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
from streambench_tpu_torch.ops import count as count_ops
from streambench_tpu_torch.ops import hll, sliding, tdigest
from streambench_tpu_torch.ops import windowcount as wc
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
