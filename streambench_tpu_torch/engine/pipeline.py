"""The exact-count engine: encode -> device fold -> delta drain -> Redis.

The port of ``streambench_tpu/engine/pipeline.py:AdAnalyticsEngine``: the
exact per-(campaign, 10 s window) view count of BASELINE config #1, and
the same count at config #5's key space (1,000,000 campaigns, a 64-slot
ring) on one card.  Host code (encoding, the Redis writer, the span
guard, snapshots, the exactly-once ledger) is the JAX engine's; the
device fold is ``ops.windowcount`` on torch tensors, with the count going
through the hand-written CUDA kernel on the card.

Correctness invariant (ring reuse): between two drains the stream's
event-time span must stay within the ring's safe span, or a new window
could claim a slot whose counts were never drained.  The engine tracks
event times on the host (no device sync) and drains the device deltas
into a host-side pending buffer when the span guard trips; the wall-clock
flush cadence to Redis stays the reference's 1 Hz.

With ``jax.encode.workers > 1`` the host encode runs on a pool of
per-thread native encoders (``encode.parallel``); the ingest pipeline
(``engine.ingest``) calls the encode halves from its own thread, and only
the host loop's thread folds.

With ``jax.decode.device`` on (``ops.devdecode``) the host only probes
raw journal blocks; one launch of the decode kernel (K2) per dispatch
turns their bytes into columns and joins each ad to its campaign on the
device, and the same window fold (K1) counts them.

Observability (``obs/``) attaches through ``attach_obs``; until then the
engine carries ``None`` attributes and one None check per dispatch,
flush and write.

The sketch engines (``engine.sketches``: HLL, sliding + t-digest)
subclass this one through the JAX engine's hooks: ``absolute_counts``
(HSET estimates), the encoder's id mode (``HASHED_IDS`` /
``NEEDS_INTERNED_IDS``), ``SCAN_SUPPORTED``, ``PACKED_EXTRA_COLS``,
``STEP_PACKS``, ``_materialize_custom`` and ``_check_geometry``'s
``extra``.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import weakref
from collections import defaultdict

import numpy as np
import torch

from streambench_tpu_torch.checkpoint import Snapshot
from streambench_tpu_torch.config import BenchmarkConfig
from streambench_tpu_torch.encode.native_encoder import make_encoder
from streambench_tpu_torch.encode.parallel import ParallelEncodePool
from streambench_tpu_torch.io.redis_schema import (
    RedisLike,
    claim_epoch,
    dump_latency_hash,
    fence_key,
    read_fence,
    write_windows_pipelined,
)
from streambench_tpu_torch.metrics import FaultCounters, LatencyTracker
from streambench_tpu_torch.ops import count as count_ops
from streambench_tpu_torch.ops import devdecode
from streambench_tpu_torch.ops import windowcount as wc
from streambench_tpu_torch.trace import Tracer
from streambench_tpu_torch.utils.device import resolve_device
from streambench_tpu_torch.utils.ids import now_ms


def default_method(device: torch.device) -> str:
    """The count method for ``device``: the hand-written kernel on CUDA,
    the plain PyTorch version on the CPU.  Never the plain version on the
    card unless a caller asks for it by name."""
    return "kernel" if device.type == "cuda" else "scatter"


def _unique_ts(ts: np.ndarray) -> np.ndarray:
    """``np.unique`` for window-timestamp columns, without the sort where
    the value range is dense (a bounded flag array dedups in O(n))."""
    if ts.size < (1 << 12):
        return np.unique(ts)
    tmin = int(ts.min())
    span = int(ts.max()) - tmin + 1
    if span > 16 * ts.size or span > (1 << 26):
        return np.unique(ts)
    flags = np.zeros(span, bool)
    flags[ts - tmin] = True
    return np.flatnonzero(flags) + tmin


class _ArrayRows:
    """A flush batch as numpy columns — (campaign_idx, abs_window_ts,
    count) — plus the campaign-name table needed to write or recover
    them.  ``table`` is ``(names_blob, names_off, native_store)``."""

    __slots__ = ("ci", "ts", "cnt", "table", "campaigns")

    def __init__(self, ci, ts, cnt, table, campaigns):
        self.ci, self.ts, self.cnt = ci, ts, cnt
        self.table = table
        self.campaigns = campaigns

    def __len__(self) -> int:
        return int(self.ci.shape[0])

    def to_rows(self) -> list:
        """Expand to (campaign, ts, count) rows (failure/reclaim path
        only — the success path never leaves numpy)."""
        names = self.campaigns
        return [(names[c], int(t), int(n))
                for c, t, n in zip(self.ci.tolist(), self.ts.tolist(),
                                   self.cnt.tolist())]


class _RedisWriter:
    """Background window-writeback thread (the reference's flusher thread,
    ``CampaignProcessorCommon.java:35-55``), copied from the JAX engine.

    ``time_updated`` is stamped by THIS thread at actual write time
    (``core.clj:149`` defines latency truth).  A bounded queue provides
    backpressure.  A failed write is retained for reclaim (never dropped),
    the next attempt waits a capped exponential backoff, a
    ``reconnect()``-capable client is re-dialed, and the retained buffer
    is coalesced by (campaign, window) past a high-water row count.

    Exactly-once mode (``exactly_once=True``): every flush rides ONE
    pipeline bracketed by fence records -- ``intent``/``epoch`` first, the
    commit ``seq`` last -- and each apply is preceded by an epoch check,
    so a superseded writer (an abandoned engine's thread still draining
    its queue) drops its batch instead of applying stale deltas
    (``fence_conflicts``).  A failed apply whose commit fence IS on the
    sink actually landed (the error was response-side): the retry is
    suppressed (``dedup_suppressed_flushes``) instead of applied twice.
    """

    def __init__(self, redis: RedisLike, tracer: Tracer,
                 on_written, faults: "FaultCounters | None" = None,
                 absolute: bool = False,
                 retry_base_ms: int = 100, retry_cap_ms: int = 5000,
                 dirty_cap_rows: int = 1 << 18,
                 exactly_once: bool = False, fence_key: str = "",
                 epoch: int | None = None, start_seq: int = 0) -> None:
        self._redis = redis
        # HSET absolute values (sketch estimates) instead of HINCRBY
        # deltas, unless a submit says otherwise
        self._absolute = bool(absolute)
        self._tracer = tracer
        # (rows, stamp) latency bookkeeping: a bound method of the engine,
        # held weakly.  An engine abandoned without close() (a supervised
        # crash) leaves this thread draining its queue, as the reference's
        # zombie writer does; a strong reference would pin the dead
        # engine's device state for as long as the thread lives.
        self._on_written = weakref.WeakMethod(on_written)
        self._faults = faults if faults is not None else FaultCounters()
        self._retry_base_ms = max(int(retry_base_ms), 1)
        self._retry_cap_ms = max(int(retry_cap_ms), self._retry_base_ms)
        self._dirty_cap_rows = max(int(dirty_cap_rows), 1)
        # exactly-once fence state (dormant when the flag is off): the
        # epoch is claimed engine-side before the first submit; seq
        # continues from the sink's high-water and is never reused, so
        # the landed-or-not check is unambiguous
        self._xo = bool(exactly_once)
        self._fence_key = fence_key
        self._epoch = epoch
        self._seq = int(start_seq)
        self._seq_acked = int(start_seq)
        self._fenced = False            # a newer epoch owns the sink
        self._last_attempt_seq: int | None = None
        self._consec_failures = 0
        # window/list-UUID memo across flushes (sole-writer assumption,
        # see write_windows_pipelined); only this thread touches it
        self._uuid_cache: dict = {}
        self._q: queue.Queue = queue.Queue(maxsize=8)
        self._error: BaseException | None = None
        self._lock = threading.Lock()
        # Batches whose write raised: retained for the engine to re-merge
        # into _pending (take_failed).
        self._failed: list[list] = []
        self._failed_rows = 0
        # interruptible backoff sleep: close() sets this
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="redis-writer")
        self._thread.start()

    def _backoff_ms(self) -> int:
        """Capped exponential backoff for the current failure streak."""
        n = min(self._consec_failures, 16)  # 2**16 already >> any cap
        return min(self._retry_base_ms * (1 << max(n - 1, 0)),
                   self._retry_cap_ms)

    def _on_failure(self, rows: list, err: BaseException) -> None:
        self._consec_failures += 1
        self._faults.inc("sink_errors")
        back = self._backoff_ms()
        self._faults.inc("sink_backoff_ms", back)
        print(f"redis writer: write of {len(rows)} rows failed "
              f"({err!r}); retained for retry, backoff {back} ms",
              file=sys.stderr, flush=True)
        with self._lock:
            self._failed.append(rows)
            self._failed_rows += len(rows)
            self._error = err
            if self._failed_rows > self._dirty_cap_rows:
                self._coalesce_failed_locked()
        # Re-dial before the next attempt: a half-open socket hangs every
        # command until its timeout; a fresh connect fails fast or works.
        reconnect = getattr(self._redis, "reconnect", None)
        if reconnect is not None:
            try:
                reconnect()
                self._faults.inc("sink_reconnects")
            except Exception:
                pass  # still down; the backoff covers it
        self._wake.wait(back / 1000.0)
        self._wake.clear()

    def _coalesce_failed_locked(self) -> None:
        """Merge the retained batches by (campaign, window): deltas sum,
        absolute values keep the freshest (batch order is write order).
        Called with the lock held, past the high-water mark only.  (In
        exactly-once mode a failed batch only taints its windows, so its
        values are never written back.)"""
        merged: dict[tuple, int] = {}
        for batch in self._failed:
            for camp, ts, n in batch:
                if self._absolute:
                    merged[(camp, ts)] = n
                else:
                    merged[(camp, ts)] = merged.get((camp, ts), 0) + n
        rows = [(c, ts, n) for (c, ts), n in merged.items()]
        before = self._failed_rows
        self._failed = [rows]
        self._failed_rows = len(rows)
        self._faults.inc("sink_dirty_high_water")
        print(f"redis writer: retained rows passed high water "
              f"({before} > {self._dirty_cap_rows}); coalesced to "
              f"{len(rows)} dirty windows", file=sys.stderr, flush=True)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                payload, stamp, absolute = item
                stamp = now_ms() if stamp is None else stamp
                if absolute is None:
                    absolute = self._absolute
                arrays = not isinstance(payload, list)
                fenced_out = False
                try:
                    with self._tracer.span("redis_flush"):
                        if self._xo:
                            fenced_out = not self._apply_fenced(
                                payload, stamp, absolute)
                        elif arrays:
                            # (ci, ts, cnt) numpy triple against the
                            # native store: campaign table passed once,
                            # zero per-row Python work
                            blob, off, store = payload.table
                            store.write_windows_arrays(
                                blob, off, payload.ci, payload.ts,
                                payload.cnt, str(stamp),
                                absolute=self._absolute)
                        else:
                            write_windows_pipelined(
                                self._redis, payload, time_updated=stamp,
                                absolute=absolute, cache=self._uuid_cache)
                except BaseException as e:  # retained for reclaim/retry
                    if self._xo and self._landed(self._last_attempt_seq):
                        # the whole pipeline, commit fence last, landed;
                        # the failure was response-side: a retry would
                        # apply the deltas twice
                        self._faults.inc("dedup_suppressed_flushes")
                        self._seq_acked = self._last_attempt_seq
                        self._consec_failures = 0
                        self._written(payload, stamp)
                    else:
                        self._on_failure(payload.to_rows() if arrays
                                         else payload, e)
                else:
                    if fenced_out:
                        continue   # superseded epoch: dropped, not written
                    self._consec_failures = 0
                    if self._xo:
                        self._seq_acked = self._last_attempt_seq
                    # latency bookkeeping only for rows that actually landed
                    self._written(payload, stamp)
            finally:
                self._q.task_done()

    def _written(self, payload, stamp: int) -> None:
        """Hand landed rows to the engine's bookkeeping, if it lives."""
        on_written = self._on_written()
        if on_written is not None:
            on_written(payload, stamp)

    # -- exactly-once fence protocol -----------------------------------
    def _apply_fenced(self, rows: list, stamp: int, absolute: bool) -> bool:
        """One fenced apply: check the epoch, then rows + fence in one
        pipeline.  Returns False when a newer epoch owns the sink: this
        writer is a zombie and the batch is DROPPED, never retained (the
        new lineage's ledger is the truth).  Raises on sink errors like
        the plain path (the rows are then retained)."""
        self._last_attempt_seq = None
        # The epoch is only ever claimed engine-side (_xo_attach_sink): a
        # writer claiming lazily could be a zombie that reads the fence
        # after its successor claimed and fences out the live writer.
        if self._epoch is None:
            raise RuntimeError(
                "fenced writer received a batch without a claimed epoch")
        e, _, _ = read_fence(self._redis, self._fence_key)
        if e > self._epoch:
            if not self._fenced:
                print(f"redis writer: fenced out (sink epoch {e} > "
                      f"writer epoch {self._epoch}); dropping "
                      f"{len(rows)} stale rows", file=sys.stderr,
                      flush=True)
            self._fenced = True
            self._faults.inc("fence_conflicts")
            return False
        self._seq += 1
        self._last_attempt_seq = self._seq
        write_windows_pipelined(
            self._redis, rows, time_updated=stamp, absolute=absolute,
            cache=self._uuid_cache,
            fence=(self._fence_key, self._epoch, self._seq))
        return True

    def _landed(self, seq: int | None) -> bool:
        """Did the flush with ``seq`` fully land despite the raised
        error?  True iff the sink's commit fence -- the LAST command of
        that flush's pipeline -- records exactly our (epoch, seq)."""
        if seq is None or self._epoch is None:
            return False
        try:
            e, s, _ = read_fence(self._redis, self._fence_key)
        except BaseException:
            return False    # sink still down: treat as not landed
        return e == self._epoch and s == seq

    def fence_state(self) -> tuple[int, int]:
        """(epoch, last fully-landed flush seq): the fence a snapshot
        covers.  Read after ``drain()`` for a stable value."""
        return (self._epoch or 0, self._seq_acked)

    def has_failed(self) -> bool:
        with self._lock:
            return bool(self._failed)

    def dirty_rows(self) -> int:
        """Retained failed-write rows awaiting reclaim."""
        with self._lock:
            return self._failed_rows

    def take_failed(self) -> list[list]:
        """Hand back batches whose write failed (clears the retention)."""
        with self._lock:
            failed, self._failed = self._failed, []
            self._failed_rows = 0
        return failed

    def submit(self, rows, stamp: int | None,
               absolute: bool | None = None) -> None:
        """Queue one writeback payload (rows list or ``_ArrayRows``).
        ``absolute`` HSETs the counts instead of HINCRBY (the
        exactly-once ledger's reconcile writes); None keeps the writer's
        own mode."""
        self._q.put((rows, stamp, absolute))

    def drain(self) -> None:
        """Block until every submitted batch was attempted.  Failures are
        not raised here -- they sit in ``take_failed`` for reclaim."""
        self._q.join()

    def close(self) -> None:
        """Stop the thread.  Raises if batches failed and were never
        reclaimed (the lost rows are counted in ``rows_lost`` first)."""
        if self._thread.is_alive():
            self._q.put(None)
            self._wake.set()  # cut short any in-progress backoff sleep
            self._thread.join()
        with self._lock:
            lost, err = len(self._failed), self._error
            rows_lost = self._failed_rows
        if lost:
            self._faults.inc("rows_lost", rows_lost)
            raise RuntimeError(
                f"redis writer shut down with {lost} unwritten batches "
                f"({rows_lost} window rows lost)"
            ) from err


def _to_numpy(x) -> np.ndarray:
    """A parked drain handle as numpy: tensors (device or host) are
    copied or viewed, numpy arrays pass through."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class AdAnalyticsEngine:
    """Exact per-(campaign, 10 s window) view counting: BASELINE config #1
    (100 campaigns x 10 ads, 16 ring slots) and config #5's key space
    (1,000,000 campaigns x 1 ad, 64 slots) on one device, with snapshots
    for checkpoint/resume and, under ``jax.sink.exactly_once``, the fenced
    exactly-once writeback.

    ``device`` defaults to ``"cuda"``; without CUDA the constructor
    raises unless the caller passes ``device="cpu"``."""

    # Subclasses whose pending values are absolute (sketch estimates,
    # not deltas) set this: the writer HSETs instead of HINCRBY.
    absolute_counts = False
    # Checkpoint compatibility class, as in the JAX engine: restore
    # refuses a snapshot of another family.
    ENGINE_FAMILY = "exact"

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 campaigns: list[str] | None = None,
                 redis: RedisLike | None = None,
                 method: str | None = None,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.redis = redis
        self.divisor = cfg.jax_time_divisor_ms
        self.lateness = cfg.jax_allowed_lateness_ms

        def _new_encoder():
            """ONE construction+configuration site: the primary encoder
            and every pool worker must be configured identically."""
            e = make_encoder(ad_to_campaign, campaigns,
                             divisor_ms=self.divisor,
                             lateness_ms=self.lateness,
                             use_native=cfg.jax_use_native_encoder)
            if self.HASHED_IDS:
                e.set_hash_ids(True)
            elif not self.NEEDS_INTERNED_IDS:
                e.set_intern_ids(False)
            return e

        self.encoder = _new_encoder()
        self.join_table = torch.from_numpy(
            self.encoder.join_table).to(self.device)
        self.W = cfg.jax_window_slots
        self.method = method or default_method(self.device)
        if self.method not in wc.METHODS:
            raise ValueError(f"unknown method {self.method!r}; expected one "
                             f"of {wc.METHODS}")
        self.batch_size = cfg.jax_batch_size
        self.scan_batches = max(cfg.jax_scan_batches, 1)
        if self.W * self.divisor <= self.lateness + 2 * self.divisor:
            raise ValueError(
                f"window ring too small: {self.W} slots x {self.divisor} ms "
                f"must exceed lateness {self.lateness} ms + 2 windows")
        # Safe event-time span between device drains.
        self._span_guard = (self.W * self.divisor - self.lateness
                            - 2 * self.divisor)
        self.state = wc.init_state(self.encoder.num_campaigns, self.W,
                                   self.device)

        self._span_start: int | None = None   # min unflushed event time (abs)
        # Host mirror of the device watermark (max absolute event time
        # folded), read by telemetry and _oldest_open_span_start without
        # a device pull.
        self._host_wm: int | None = None
        # Parked drains, each ``((tag, *handles), copied_event)``:
        #   ("dense", deltas, wids)
        #   ("compact", idx, vals, nnz, dense, wids)
        #   ("rows_compact", rows_np, idx, vals, nnz, sub, wids)
        #   ("rows_host", rows_np, sub_np, wids)          [CPU]
        # whose host materialization is postponed to flush time.  On CUDA
        # the device->host copies start at park time, non_blocking into
        # pinned buffers, gated by a CUDA event, and (_defer_pull) a
        # periodic flush materializes only the drains parked one cycle
        # earlier (_undrained_ready), whose copies have long landed.
        self._undrained: list[tuple] = []
        self._undrained_ready: list[tuple] = []
        self._defer_pull = self.device.type == "cuda"
        # Drains taken per branch of _drain_device, and compact drains
        # whose nonzero cells overflowed COMPACT_DRAIN_CAP.
        self.drain_stats = dict.fromkeys(
            ("free_slots", "rows_host", "rows_compact", "compact", "dense",
             "overflow"), 0)
        # Packed wire word (ops.windowcount.pack_columns) while the ad
        # space fits its 28-bit field.
        self._pack_ok = self.encoder.join_table.size < wc.PACK_AD_MAX
        # Dirty-campaign tracking (large key spaces only): per-batch
        # campaign sets gathered on the host, so a drain reads just the
        # touched rows instead of all C x W cells.
        self._join_np = self.encoder.join_table
        self._dirty_rows: list[np.ndarray] = []
        # pending Redis deltas: (campaign_idx, abs_window_ts) -> count
        # (dict = slow path for reclaims and snapshots; _pending_np =
        # numpy triples straight from drains, the hot path)
        self._pending: dict[tuple[int, int], int] = defaultdict(int)
        self._pending_np: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        # campaign-name table for the native store's index-form bulk
        # writeback; False = not yet resolved (resolution needs redis)
        self._camp_table = False
        self.events_processed = 0
        self.windows_written = 0
        self.started_ms = now_ms()
        self.last_event_ms = self.started_ms
        # fork-style latency accounting: abs_window_ts -> last time_updated
        self.window_latency: dict[int, int] = {}
        self.tracer = Tracer()
        self.latency_tracker = LatencyTracker(window_ms=self.divisor)
        self.faults = FaultCounters()
        # exactly-once writeback (jax.sink.exactly_once), all dormant when
        # the flag is off:
        #   _sink_totals  cumulative per-window ledger of every delta
        #                 handed to the writer (what an absolute
        #                 reconcile writes)
        #   _taint        windows whose last flush failed or may have
        #                 partly applied: the next flush rewrites them
        #                 absolute from the ledger
        #   _reconcile_all  resumed over a sink holding unfenced flushes:
        #                 every flush of this attempt writes absolute
        #   _xo_baseline  the restored snapshot's (epoch, seq) fence,
        #                 what the sink's fence is compared against
        self._xo = bool(cfg.jax_sink_exactly_once)
        self._fence_key = fence_key(cfg.kafka_topic)
        self._sink_totals: dict[tuple[int, int], int] = {}
        self._taint: set[tuple[int, int]] = set()
        self._reconcile_all = False
        self._xo_baseline: tuple[int, int] = (0, 0)
        self._xo_attached = not self._xo
        self._sink_epoch: int | None = None
        self._sink_seq0 = 0
        self._writer: _RedisWriter | None = None
        # live telemetry (obs/): None until attach_obs — the writeback
        # latency histogram, the per-window lifecycle, the occupancy
        # sampler and the transfer ledger; one None check each per
        # dispatch, flush or write otherwise
        self._obs_hist = None
        self._obs_lifecycle = None
        self._obs_occupancy = None
        self._obs_xfer = None
        # Parallel encode pool (multi-core hosts): per-thread encoders,
        # sound only for engines whose fold never reads the interned
        # user/page columns (see encode.parallel).  GIL-bound (pure
        # Python) encoders gain nothing from threads; only the native
        # encoder's ctypes scan parallelizes.
        self._encode_pool: ParallelEncodePool | None = None
        if (cfg.jax_encode_workers > 1 and self.PARALLEL_ENCODE_OK
                and getattr(self.encoder, "RELEASES_GIL", False)):
            self._encode_pool = ParallelEncodePool(
                self.encoder, _new_encoder,
                workers=cfg.jax_encode_workers)
        # On-device event decode (ops.devdecode; jax.decode.device): raw
        # journal blocks go to the device, where K2 turns bytes into
        # columns and joins ads to campaigns, and the window fold counts
        # them; the host keeps only the layout probe.  None whenever the
        # mode is off or this engine or its data shape is not eligible:
        # then the host encoders run, unchanged.
        self._devdecode = self._maybe_device_decoder(cfg.jax_decode_device)

    # Engines whose device state is keyed by interned ids must keep one
    # consistent intern table and clear this (encode.parallel).
    PARALLEL_ENCODE_OK = True
    # Whether process_chunk folds groups of scan_batches through
    # _device_scan / _device_scan_packed; False folds batch by batch
    # (drains stay deferred either way).
    SCAN_SUPPORTED = True
    # the encoded columns the unpacked wire ships, in scan order
    SCAN_COLUMNS = ("ad_idx", "event_type", "event_time", "valid")
    # Extra columns a packed scan ships between the packed word and
    # event_time (HLL's user ids).
    PACKED_EXTRA_COLS: tuple = ()
    # Whether the fold reads the interned user/page columns; when False
    # the encoder skips interning (two hash probes an event).
    NEEDS_INTERNED_IDS = False
    # Stateless crc32 id columns instead of intern indices (wins over
    # NEEDS_INTERNED_IDS), for folds that only need a well-mixed
    # identity (HLL): the same across pool workers and restarts.
    HASHED_IDS = False
    # Whether _device_step ships the packed word when _pack_ok (the
    # sketch steps ship separate columns); read by the transfer ledger.
    STEP_PACKS = True

    # ------------------------------------------------------------------
    def _maybe_device_decoder(self, mode: str, pipelined: bool = False):
        """The device decoder when the mode and this engine allow it;
        None otherwise (callers treat None as "host encode").

        Eligibility fails CLOSED, as in the JAX engine: only the pure
        exact-count device hooks are decodable (a subclass overriding
        ``_device_step``/``_device_scan`` consumes columns this path never
        builds), the key space must stay under the dirty-row-drain
        threshold (those drains track touched campaigns from host-side
        ``ad_idx`` columns that no longer exist, so config #5 keeps the
        host encode), and the ad table must be the generator's fixed
        36-byte uuid wire format.  ``auto`` also gates on the measured A/B
        of the ingest mode (``devdecode.auto_enabled``; serial until the
        runner says otherwise, ``settle_decode``).  These are rules of the
        configuration: an eligible engine's decode never falls back."""
        if mode == "off":
            return None
        if not (type(self)._device_step is AdAnalyticsEngine._device_step
                and type(self)._device_scan
                is AdAnalyticsEngine._device_scan):
            if mode == "on":
                print(f"device decode requested but the "
                      f"{self.ENGINE_FAMILY!r} engine's fold reads columns "
                      f"the decode kernel does not build; host encode",
                      file=sys.stderr, flush=True)
            return None
        if self._track_dirty_rows():
            return None
        if mode == "auto" and not devdecode.auto_enabled(self.device.type,
                                                         pipelined):
            return None
        try:
            return devdecode.DeviceDecoder(
                self.encoder, batch_size=self.batch_size,
                scan_batches=self.scan_batches, divisor_ms=self.divisor,
                lateness_ms=self.lateness, device=self.device)
        except ValueError as e:
            if mode == "on":
                print(f"device decode requested but unsupported here "
                      f"({e}); falling back to host encode",
                      file=sys.stderr, flush=True)
            return None

    def settle_decode(self, pipelined: bool) -> None:
        """``jax.decode.device: auto`` follows the A/B winner of the
        ingest mode the runner resolved: the serial loop's and the staged
        pipeline's differ.  Called before any block is folded."""
        if self.cfg.jax_decode_device == "auto":
            self._devdecode = self._maybe_device_decoder("auto", pipelined)

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Build the count kernel (and the decode kernel, with device
        decode on) and run every device path once — a step, a scan
        group, a decode dispatch and a drain — on all-invalid rows
        (masked in every op, so state is semantically unchanged), then
        synchronise."""
        zb = self.encoder.encode([], self.batch_size)
        with self.tracer.span("warmup"):
            self._device_step(zb)
            if self.SCAN_SUPPORTED and self.scan_batches > 1:
                self._fold_stack([zb, zb])
            if self._devdecode is not None:
                self.state = self._devdecode.warmup(self.state,
                                                    method=self.method)
            self._drain_device()
            self._materialize_drains()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._span_start = None

    # ------------------------------------------------------------------
    def process_chunk(self, lines: list[bytes]) -> int:
        """Encode + fold up to ``scan_batches`` batches per group."""
        self.fold_batches(self.encode_chunk_lines(lines))
        return len(lines)

    def encode_chunk_lines(self, lines: list[bytes]) -> list:
        """Encode-only half of ``process_chunk``: batch-sized slices
        through the encode pool (or the primary encoder), empty batches
        dropped.  The ingest pipeline's encode stage calls this from its
        own thread, so it is host-only: no torch, no device."""
        if self._devdecode is not None and lines:
            # line-mode ingest with device decode: rejoin into one block
            # (a memcpy) so paced and streaming readers share the
            # raw-bytes path; poll() strips the newlines, so restore them
            return self._prepare_device_blocks(b"\n".join(lines) + b"\n")
        B = self.batch_size
        if self._encode_pool is not None:
            with self.tracer.span("encode"):
                encoded = self._encode_pool.encode_chunks(
                    [lines[off:off + B] for off in range(0, len(lines), B)],
                    B)
            batches = [b for b in encoded if b.n]
        else:
            batches = []
            for off in range(0, len(lines), B):
                with self.tracer.span("encode"):
                    b = self.encoder.encode(lines[off:off + B], B)
                if b.n:
                    batches.append(b)
        if self._obs_lifecycle is not None:
            self._obs_lifecycle.stamp_encoded(batches)
        return batches

    def fold_batches(self, batches: list) -> int:
        """Fold encoded batches into device state IN ORDER, grouped by
        ``scan_batches``.  Returns parsed events folded.

        Device-decode items (``devdecode.PreparedBlock``) interleave with
        encoded batches in journal order: runs of encoded batches keep
        the grouped path, prepared blocks go through the decode + fold."""
        before = self.events_processed
        K = self.scan_batches
        run: list = []

        def flush_run() -> None:
            if not self.SCAN_SUPPORTED or K <= 1:
                for b in run:
                    self._fold(b)
            else:
                for g in range(0, len(run), K):
                    self._fold_group(run[g:g + K])
            run.clear()

        for b in batches:
            if getattr(b, "is_device_block", False):
                flush_run()
                self._fold_prepared(b)
            else:
                run.append(b)
        flush_run()
        return self.events_processed - before

    def _fold_group(self, batches: list) -> None:
        """Fold up to ``scan_batches`` encoded batches as one stack."""
        if len(batches) == 1:
            self._fold(batches[0])
            return
        lo = min(int(b.event_time[:b.n].min()) + b.base_time_ms
                 for b in batches)
        hi = max(int(b.event_time[:b.n].max()) + b.base_time_ms
                 for b in batches)
        if hi - lo > self._span_guard:
            # The group alone outspans the ring; the per-batch path can
            # drain between batches and halve over-wide ones.
            for b in batches:
                self._fold(b)
            return
        if self._span_start is None:
            self._span_start = lo
        if hi - self._span_start > self._span_guard:
            with self.tracer.span("drain"):
                self._drain_device()
            if self._span_start is None or lo < self._span_start:
                self._span_start = lo
        # No power-of-two padding of partial groups, unlike the JAX engine:
        # it pads for its compile buckets, and eager steps have none (an
        # all-invalid pad batch leaves the state unchanged anyway).
        if self._track_dirty_rows():
            self._note_batch_campaigns(batches)
        with self.tracer.span("device_scan"):
            stacks = self._fold_stack(batches)
        if self._obs_occupancy is not None:
            self._obs_occupancy.note_dispatch(self.state)
        if self._obs_xfer is not None:
            # the numpy stacks ARE the dispatched host payload
            self._note_xfer("packed" if self._pack_ok else "unpacked",
                            sum(b.n for b in batches), stacks)
        for b in batches:
            self._note_watermark(b)
        self.events_processed += sum(b.n for b in batches)
        self.last_event_ms = now_ms()

    def _fold_stack(self, batches: list) -> list[np.ndarray]:
        """Ship ``batches`` as [K, B] stacks and fold them with one scan
        call.  Returns the host stacks shipped."""
        if self._pack_ok:
            stacks = ([np.stack([wc.pack_columns(b.ad_idx, b.event_type,
                                                 b.valid) for b in batches])]
                      + [np.stack([getattr(b, c) for b in batches])
                         for c in self.PACKED_EXTRA_COLS]
                      + [np.stack([b.event_time for b in batches])])
            self._device_scan_packed(*map(self._to_device, stacks))
            return stacks
        stacks = [np.stack([getattr(b, name) for b in batches])
                  for name in self.SCAN_COLUMNS]
        self._device_scan(*map(self._to_device, stacks))
        return stacks

    def _fold_prepared(self, pb) -> None:
        """Ring-guarded fold of one device-decode block: the span hazards
        of ``_fold`` (drain when the unflushed span would overrun; halve
        when the block ALONE outspans the ring), then one decode + fold
        dispatch.  Host bookkeeping (watermark mirror, attribution, event
        counting) reads the probe's times through the block's
        ``EncodedBatch``-shaped surface."""
        if pb.n == 0:
            return
        vt = pb.event_time
        batch_max = int(vt.max()) + pb.base_time_ms
        batch_min = int(vt.min()) + pb.base_time_ms
        if batch_max - batch_min > self._span_guard and pb.n > 1:
            for half in pb.halves():
                self._fold_prepared(half)
            return
        if self._span_start is None:
            self._span_start = batch_min
        if batch_max - self._span_start > self._span_guard:
            with self.tracer.span("drain"):
                self._drain_device()
            if self._span_start is None or batch_min < self._span_start:
                self._span_start = batch_min
        with self.tracer.span("device_decode"):
            self.state = self._devdecode.fold(self.state, pb,
                                              method=self.method)
        if self._obs_occupancy is not None:
            self._obs_occupancy.note_dispatch(self.state)
        if self._obs_xfer is not None:
            # the raw byte buffer crosses once, at the first fold that
            # reads it (span-guard halves share it), plus each fold's row
            # vectors
            wire = pb.starts.nbytes + pb.lens.nbytes
            if not pb.raw.counted:
                pb.raw.counted = True
                wire += pb.raw.nbytes
            self._obs_xfer.note_dispatch("devdecode", pb.n, wire,
                                         rows=pb.n)
        self._note_watermark(pb)
        self.events_processed += pb.n
        self.last_event_ms = now_ms()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host column -> device tensor (a synchronous copy from pageable
        memory: the numpy buffer may be reused as soon as this returns)."""
        return torch.from_numpy(a).to(self.device)

    def _device_scan(self, ad_idx, event_type, event_time, valid) -> None:
        """Fold ``[K, B]`` stacked batches."""
        self.state = wc.scan_steps(
            self.state, self.join_table, ad_idx, event_type, event_time,
            valid, divisor_ms=self.divisor, lateness_ms=self.lateness,
            method=self.method)

    def _device_scan_packed(self, packed, event_time) -> None:
        """``_device_scan`` over the packed wire word."""
        self.state = wc.scan_steps_packed(
            self.state, self.join_table, packed, event_time,
            divisor_ms=self.divisor, lateness_ms=self.lateness,
            method=self.method)

    # ------------------------------------------------------------------
    @property
    def supports_block_ingest(self) -> bool:
        """True when raw journal blocks can be encoded without per-line
        Python objects (the native encoder, or the device-decode path,
        which wants raw bytes by construction)."""
        if self._devdecode is not None:
            return True
        return hasattr(self.encoder, "encode_block")

    def process_block(self, data: bytes) -> int:
        """Ingest one raw journal block (complete newline-delimited
        records).  Returns parsed events folded."""
        if not data:
            return 0
        return self.fold_batches(self.encode_raw_block(data))

    def encode_raw_block(self, data: bytes) -> list:
        """Encode-only half of ``process_block``: carve + parse one raw
        journal block into ``EncodedBatch`` groups without folding (the
        ingest pipeline's encode stage; host-only, like
        ``encode_chunk_lines``)."""
        if not data:
            return []
        if self._devdecode is not None:
            return self._prepare_device_blocks(data)
        if not self.supports_block_ingest:
            lines = data.split(b"\n")
            if lines and not lines[-1]:
                lines.pop()
            return self.encode_chunk_lines(lines)
        B = self.batch_size
        with self.tracer.span("encode"):
            if self._encode_pool is not None:
                batches, start = self._encode_pool.carve_block_parallel(
                    data, B)
            else:
                batches, start = self.encoder.carve_block(data, B)
            if start < len(data):
                # unterminated trailing record: parse it as one line so
                # both process_block branches see identical events
                b = self.encoder.encode([data[start:]], B)
                if b.n:
                    batches.append(b)
        if self._obs_lifecycle is not None:
            self._obs_lifecycle.stamp_encoded(batches)
        return batches

    def _prepare_device_blocks(self, data: bytes) -> list:
        """Device-decode "encode" stage (host-only, like
        ``encode_chunk_lines``): probe the raw block (record boundaries,
        fixed-layout validation, times; NO columns) and return the items
        to fold: the probe-rejected rows re-encoded through the host
        encoder first (bad-line counting and dead-letter parity), then
        the :class:`devdecode.PreparedBlock`\\ s.  The fallback batches
        fold before the device rows of the same call, so a malformed row
        is never judged against a watermark its own block advanced."""
        with self.tracer.span("decode_probe"):
            blocks, bad_lines = self._devdecode.prepare(data)
            nl_end = data.rfind(b"\n") + 1
            if nl_end < len(data):
                # unterminated trailing record: the host block path's
                # one-line rule
                bad_lines.append(data[nl_end:])
        out: list = []
        if bad_lines:
            B = self.batch_size
            for off in range(0, len(bad_lines), B):
                with self.tracer.span("encode"):
                    b = self.encoder.encode(bad_lines[off:off + B], B)
                if b.n:
                    out.append(b)
        out.extend(blocks)
        if self._obs_lifecycle is not None:
            self._obs_lifecycle.stamp_encoded(out)
        return out

    def _fold(self, batch) -> None:
        """Ring-guarded fold of one encoded batch, splitting when needed.

        Two span hazards: (a) the batch stretches the *unflushed* span
        past the safe limit -> drain first; (b) the batch ALONE spans more
        event time than the ring can hold -> halve and recurse."""
        vt = batch.event_time[:batch.n]
        batch_max = int(vt.max()) + batch.base_time_ms
        batch_min = int(vt.min()) + batch.base_time_ms
        if batch_max - batch_min > self._span_guard and batch.n > 1:
            for half in self._halves(batch):
                if half.n:
                    self._fold(half)
            return
        if self._span_start is None:
            self._span_start = batch_min
        if batch_max - self._span_start > self._span_guard:
            with self.tracer.span("drain"):
                self._drain_device()
            if self._span_start is None or batch_min < self._span_start:
                self._span_start = batch_min
        if self._track_dirty_rows():
            self._note_batch_campaigns([batch])
        with self.tracer.span("device_step"):
            self._device_step(batch)
        if self._obs_occupancy is not None:
            self._obs_occupancy.note_dispatch(self.state)
        if self._obs_xfer is not None:
            fmt, cols = self._xfer_step_cols(batch)
            self._note_xfer(fmt, batch.n, cols)
        self._note_watermark(batch)
        self.events_processed += batch.n
        self.last_event_ms = now_ms()

    def _note_watermark(self, batch) -> None:
        """Advance the host watermark mirror — strictly AFTER the fold
        that carries these events is dispatched, and over VALID rows
        only, so ``_host_wm`` equals the device watermark at every drain
        point (device work runs in dispatch order).  Reads the host
        batch, never the device."""
        if self._obs_lifecycle is not None:
            # attribution hook (obs.lifecycle): this batch's windows
            # just folded — record its read/encode stamps + fold time
            self._obs_lifecycle.note_fold(batch)
        v = batch.valid[:batch.n]
        if not v.any():
            return
        vt = batch.event_time[:batch.n]
        mx = int(vt.max() if v.all() else vt[v].max()) + batch.base_time_ms
        if self._host_wm is None or mx > self._host_wm:
            self._host_wm = mx

    # ------------------------------------------------------------------
    # host->device transfer accounting (obs.xfer) — called only when
    # attach_obs handed over a TransferLedger; never on the default path
    def _xfer_step_cols(self, batch):
        """``(fmt, cols)`` describing what ``_device_step`` ships for one
        batch: the column buffers at their wire dtypes, with
        ``batch.ad_idx`` standing in for the packed word (same int32
        ``[B]`` shape)."""
        if self._pack_ok and self.STEP_PACKS:
            return "packed", ([batch.ad_idx]
                              + [getattr(batch, c)
                                 for c in self.PACKED_EXTRA_COLS]
                              + [batch.event_time])
        return "unpacked", [getattr(batch, c) for c in self.SCAN_COLUMNS]

    def _note_xfer(self, fmt: str, events: int, cols) -> None:
        """Account one dispatch's payload: exact wire bytes of the
        dispatched host buffers (``[B]`` columns or ``[K, B]`` stacks,
        every element one shipped row of its column), int32-normalized
        column bytes alongside (see obs.xfer); ``cols`` double as the
        timed copy's payload."""
        wire = sum(c.nbytes for c in cols)
        colb = sum(c.size * 4 for c in cols)
        self._obs_xfer.note_dispatch(fmt, events, wire, colb,
                                     rows=cols[0].size,
                                     sample_arrays=cols, device=self.device)

    # ------------------------------------------------------------------
    # device-memory accounting (obs.devmem) — analysis time only
    def _devmem_kernels(self) -> list:
        """``(name, footprint)`` of every kernel this engine launches: K1
        at the step's B rows, on the ``[C, W]`` plane, from the launch
        plan it takes on this card (16-byte-aligned columns, as the
        caching allocator hands them out).  A CPU engine's count is the
        plain version: no kernel, an empty list."""
        if self.method != "kernel" or self.device.type != "cuda":
            return []
        B = self.batch_size
        C, W = self.state.counts.shape
        plan = count_ops.launch_plan(
            B, C, W, (0, 0, 0),
            *count_ops.device_limits(self.device.index or 0))
        plane = C * W * 4
        # campaign and slot int32, the mask one byte, the plan struct
        args = 4 * B + 4 * B + B + count_ops.PLAN_BYTES
        return [("count_cells", {
            "supported": True, "rows": B, "tier": plan.tier,
            "blocks": plan.blocks, "threads": plan.threads,
            "smem_bytes": plan.smem_bytes, "argument_bytes": args,
            "output_bytes": plane, "alias_bytes": plane, "temp_bytes": 0,
            "total_bytes": args + plane})]

    @staticmethod
    def _halves(batch):
        """Split an encoded batch into two fixed-shape halves (valid rows
        are compacted to the front, so column slices stay consistent)."""
        B = batch.batch_size
        B0 = B // 2
        n0 = min(batch.n, B0)
        cols = ("ad_idx", "event_type", "event_time", "user_idx",
                "page_idx", "ad_type", "valid")
        lo = dataclasses.replace(
            batch, **{c: getattr(batch, c)[:B0] for c in cols}, n=n0)
        hi = dataclasses.replace(
            batch, **{c: getattr(batch, c)[B0:] for c in cols},
            n=batch.n - n0)
        return lo, hi

    def _device_step(self, batch) -> None:
        """Fold one ``EncodedBatch`` into device state."""
        if self._pack_ok:
            packed = wc.pack_columns(batch.ad_idx, batch.event_type,
                                     batch.valid)
            self.state = wc.step_packed(
                self.state, self.join_table, self._to_device(packed),
                self._to_device(batch.event_time),
                divisor_ms=self.divisor, lateness_ms=self.lateness,
                method=self.method)
            return
        self.state = wc.step(
            self.state, self.join_table,
            self._to_device(batch.ad_idx), self._to_device(batch.event_type),
            self._to_device(batch.event_time), self._to_device(batch.valid),
            divisor_ms=self.divisor, lateness_ms=self.lateness,
            method=self.method)

    # ------------------------------------------------------------------
    # Drains at large key spaces (C x W >= COMPACT_DRAIN_MIN_CELLS, e.g.
    # config #5's 1e6 x 64 = 2^26 cells): never move the whole [C, W]
    # block.  First choice: the campaign rows the host saw batches touch
    # since the last drain, gathered on the device; on the card their
    # nonzero cells are compacted there too (rows_compact), on the CPU
    # they are read through a numpy view (rows_host).  When the touched
    # set overflows DIRTY_ROWS_CAP: on the card, on-device compaction of
    # the whole plane (compact), else the dense walk.  A compact drain
    # with more than COMPACT_DRAIN_CAP nonzero cells reads its pre-drain
    # block instead (the overflow).
    COMPACT_DRAIN_MIN_CELLS = 1 << 22
    COMPACT_DRAIN_CAP = 1 << 18
    DIRTY_ROWS_CAP = 1 << 17

    def _device_compacts(self) -> bool:
        """Whether drains compact on the device (the card) or read the
        counts through host memory (the CPU)."""
        return self.device.type != "cpu"

    def _use_compact_drain(self) -> bool:
        cells = self.state.counts.shape[0] * self.state.counts.shape[1]
        return (cells >= self.COMPACT_DRAIN_MIN_CELLS
                and self._device_compacts())

    def _track_dirty_rows(self) -> bool:
        counts = getattr(self.state, "counts", None)
        if counts is None:  # sketch states keep no dense [C, W] block
            return False
        return (counts.shape[0] * counts.shape[1]
                >= self.COMPACT_DRAIN_MIN_CELLS)

    def _note_batch_campaigns(self, batches) -> None:
        """Record which campaign rows the given encoded batches touch.
        Over-inclusion is harmless (rows drain as zero), so invalid rows
        inside [:n] need no masking beyond the join-miss filter."""
        parts = []
        for b in batches:
            c = self._join_np[b.ad_idx[:b.n]]
            parts.append(c[c >= 0])
        if parts:
            self._dirty_rows.append(
                np.unique(np.concatenate(parts))
                if len(parts) > 1 else np.unique(parts[0]))

    def _rows_on_device(self, rows: np.ndarray) -> torch.Tensor:
        """The touched rows as an int64 index tensor on the device: from
        pinned memory without waiting for the copy on the card."""
        t = torch.from_numpy(rows.astype(np.int64))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _drain_device(self) -> None:
        """Hand the device deltas to a parked drain for ring reuse;
        materialization is deferred to ``_materialize_drains``.  Only
        dispatches device work: nothing here waits for the card."""
        kw = dict(divisor_ms=self.divisor, lateness_ms=self.lateness)
        self._span_start = None
        if self._track_dirty_rows():
            rows = (np.unique(np.concatenate(self._dirty_rows))
                    if len(self._dirty_rows) > 1
                    else (self._dirty_rows[0] if self._dirty_rows
                          else np.empty(0, np.int64)))
            self._dirty_rows = []
            if rows.size == 0:
                # nothing counted since the last drain: the counts are
                # already zero, only closed slots need freeing
                self.state = wc.flush_free_slots(self.state, **kw)
                self.drain_stats["free_slots"] += 1
                return
            if rows.size <= self.DIRTY_ROWS_CAP:
                # exactly the touched rows: no padding to one fixed size,
                # which the JAX engine needs only to spare recompiles
                rows_t = self._rows_on_device(rows)
                if self._device_compacts():
                    idx, vals, nnz, sub, wids, self.state = \
                        wc.flush_deltas_rows_compact(
                            self.state, rows_t, rows.size,
                            cap=self.COMPACT_DRAIN_CAP, **kw)
                    self._park(("rows_compact", rows, idx, vals, nnz, sub,
                                wids))
                else:
                    # host memory: the fancy index copies the rows out
                    # before they are zeroed in place
                    sub_np = self.state.counts.numpy()[rows]
                    wids, self.state = wc.flush_rows_zero(
                        self.state, rows_t, **kw)
                    self._park(("rows_host", rows, sub_np, wids))
                return
            # touched set overflowed the cap: fall through to the full-
            # space drains
        if self._use_compact_drain():
            idx, vals, nnz, dense, wids, self.state = \
                wc.flush_deltas_compact(
                    self.state, cap=self.COMPACT_DRAIN_CAP, **kw)
            self._park(("compact", idx, vals, nnz, dense, wids))
        else:
            deltas, wids, self.state = wc.flush_deltas(self.state, **kw)
            self._park(("dense", deltas, wids))

    # The dense fallback handle of each compact tuple, read only when the
    # nonzero cells overflow the cap: never copied at park time.
    _FALLBACK = {"compact": 4, "rows_compact": 5}

    def _park(self, parked: tuple) -> None:
        """Park one drain ``(tag, *handles)``.  On CUDA the device->host
        copies of its handles start NOW (non_blocking into pinned
        buffers, on the stream that ran the steps, so they see every step
        before the drain) behind one CUDA event; the dense fallback of a
        compact drain stays on the card."""
        self.drain_stats[parked[0]] = self.drain_stats.get(parked[0], 0) + 1
        done = None
        if self.device.type == "cuda":
            skip = self._FALLBACK.get(parked[0])
            items = [parked[0]]
            for i, x in enumerate(parked[1:], 1):
                if isinstance(x, torch.Tensor) and x.is_cuda and i != skip:
                    host = torch.empty(x.shape, dtype=x.dtype,
                                       pin_memory=True)
                    host.copy_(x, non_blocking=True)
                    x = host
                items.append(x)
            done = torch.cuda.Event()
            done.record()
            parked = tuple(items)
        self._undrained.append((parked, done))

    def _materialize_drains(self, ready_only: bool = False) -> None:
        """Merge parked drain results into ``_pending_np`` as numpy
        (campaign, window_ts, count) triples, in dispatch order.

        ``ready_only`` materializes just the drains parked at least one
        flush cycle ago (``_undrained_ready``)."""
        if ready_only:
            parked_list = self._undrained_ready
            self._undrained_ready = []
        else:
            parked_list = self._undrained_ready + self._undrained
            self._undrained_ready = []
            self._undrained = []
        if not parked_list:
            return
        base = self.encoder.base_time_ms or 0
        for parked, done in parked_list:
            if done is not None:
                done.synchronize()
            tag = parked[0]
            if tag == "rows_host":
                _, rows_np, sub, wids_t = parked
                ci_l, si = np.nonzero(sub)
                vals = sub[ci_l, si]
                ci = rows_np[ci_l]
            elif tag == "compact":
                _, idx, vals_t, nnz, dense, wids_t = parked
                ci, si, vals = self._decode_compact(
                    idx, vals_t, nnz, lambda: _to_numpy(dense))
            elif tag == "rows_compact":
                _, rows_np, idx, vals_t, nnz, sub, wids_t = parked
                ci_l, si, vals = self._decode_compact(
                    idx, vals_t, nnz,
                    lambda: _to_numpy(sub)[:rows_np.size])
                ci = rows_np[ci_l]
            elif tag == "dense":
                _, deltas_t, wids_t = parked
                deltas = _to_numpy(deltas_t)
                ci, si = np.nonzero(deltas)
                vals = deltas[ci, si]
            else:
                # an engine's own parked drain (the HLL estimate block):
                # the subclass absorbs it, still in dispatch order
                self._materialize_custom(parked)
                continue
            if ci.size == 0:
                continue
            wid = _to_numpy(wids_t)[si]
            keep = wid >= 0
            if not keep.all():
                ci, wid, vals = ci[keep], wid[keep], vals[keep]
            if ci.size:
                self._pending_np.append(
                    (ci.astype(np.int64),
                     base + wid.astype(np.int64) * self.divisor,
                     vals.astype(np.int64)))

    def _materialize_custom(self, parked: tuple) -> None:
        """Hook for engines that park drains under their own tag (see
        ``_materialize_drains``); this engine parks none."""
        raise ValueError(f"unknown parked drain tag {parked[0]!r}")

    def _decode_compact(self, idx_t, vals_t, nnz_t, fallback):
        """Decode one cap-compacted drain: ``(row_idx, slot, vals)`` from
        the (idx, vals) pairs, or, when ``nnz`` overflowed the cap and the
        pairs are incomplete, from the pre-drain block ``fallback()``
        materializes (a blocking copy off the card)."""
        nnz = int(nnz_t)
        if nnz <= self.COMPACT_DRAIN_CAP:
            idx = _to_numpy(idx_t)[:nnz].astype(np.int64)
            vals = _to_numpy(vals_t)[:nnz]
            ci, si = np.divmod(idx, self.W)
            return ci, si, vals
        self.drain_stats["overflow"] += 1
        dense = fallback()
        ci, si = np.nonzero(dense)
        return ci, si, dense[ci, si]

    def _fold_pending_arrays(self) -> None:
        """Merge ``_pending_np`` array triples into the ``_pending`` dict
        (snapshots and the exactly-once ledger need the dict view).
        Absolute engines (HLL) replace: list order is recency, so the
        freshest estimate of a cell wins, as in write order."""
        for ci, ts, cnt in self._pending_np:
            if self.absolute_counts:
                for c, t, n in zip(ci.tolist(), ts.tolist(), cnt.tolist()):
                    self._pending[(c, t)] = n
            else:
                for c, t, n in zip(ci.tolist(), ts.tolist(), cnt.tolist()):
                    self._pending[(c, t)] += n
        self._pending_np.clear()

    def pending_counts(self) -> dict[tuple[int, int], int]:
        """Materialized-but-unflushed deltas as one dict view --
        ``(campaign_idx, abs_window_ts) -> count`` -- folding the numpy
        drain triples in."""
        self._fold_pending_arrays()
        return dict(self._pending)

    def flush(self, time_updated: int | None = None, *,
              final: bool = False) -> int:
        """Drain device + write all pending deltas to Redis.

        Stamps ``time_updated`` at actual write time.  Returns window rows
        submitted.  On CUDA a periodic (non-``final``) flush materializes
        only the drains parked LAST cycle and rotates this cycle's drains
        in behind them; ``final=True`` drains everything."""
        with self.tracer.span("drain"):
            self._drain_device()
            if self._defer_pull and not final:
                self._materialize_drains(ready_only=True)
                self._undrained_ready += self._undrained
                self._undrained = []
            else:
                self._materialize_drains()
        self._reclaim_failed_writes()
        if self._xo:
            return self._flush_exactly_once(time_updated)
        if not self._pending and not self._pending_np:
            return 0
        campaigns = self.encoder.campaigns
        rows = [(campaigns[c], ts, n)
                for (c, ts), n in self._pending.items()]
        self._pending.clear()
        if self.absolute_counts and len(self._pending_np) > 1:
            # several drains between flushes re-estimate the same
            # open-window cells: write only the freshest value of each
            ci = np.concatenate([t[0] for t in self._pending_np])
            ts_a = np.concatenate([t[1] for t in self._pending_np])
            cnt = np.concatenate([t[2] for t in self._pending_np])
            order = np.lexsort((np.arange(len(ci)), ts_a, ci))
            ci_s, ts_s = ci[order], ts_a[order]
            last = np.concatenate(
                [(ci_s[1:] != ci_s[:-1]) | (ts_s[1:] != ts_s[:-1]),
                 [True]])
            keep = np.sort(order[last])  # freshest per cell, stable order
            self._pending_np = [(ci[keep], ts_a[keep], cnt[keep])]
        arrays = None
        table = self._native_table()
        if table is not None and self._pending_np:
            tri = self._pending_np
            ci = np.concatenate([t[0] for t in tri])
            ts_a = np.concatenate([t[1] for t in tri])
            cnt = np.concatenate([t[2] for t in tri])
            arrays = _ArrayRows(ci.astype(np.int32), ts_a, cnt, table,
                                campaigns)
        else:
            for ci, ts_a, cnt in self._pending_np:
                rows.extend(zip((campaigns[c] for c in ci.tolist()),
                                ts_a.tolist(), cnt.tolist()))
        self._pending_np.clear()
        if self._obs_lifecycle is not None:
            # attribution hook: these windows' rows leave for the sink
            # writer NOW — everything before this stamp is device/pending
            # residency (flush_ms), everything after is sink_ms
            ts_out = [ts for _, ts, _ in rows]
            if arrays is not None:
                ts_out.extend(np.unique(arrays.ts).tolist())
            self._obs_lifecycle.note_flush(ts_out)
        total = len(rows) + (len(arrays) if arrays is not None else 0)
        if self.redis is not None:
            writer = self._ensure_writer()
            if rows:
                writer.submit(rows, time_updated)
            if arrays is not None:
                writer.submit(arrays, time_updated)
        else:
            stamp = now_ms() if time_updated is None else time_updated
            if rows:
                self._note_written(rows, stamp)
            if arrays is not None:
                self._note_written(arrays, stamp)
        return total

    def _ensure_writer(self) -> _RedisWriter:
        """Get-or-start the background writeback thread; in exactly-once
        mode it takes the epoch and seq the sink attach claimed."""
        if self._writer is None:
            self._writer = _RedisWriter(
                self.redis, self.tracer,
                self._note_written, faults=self.faults,
                absolute=self.absolute_counts,
                retry_base_ms=self.cfg.jax_sink_retry_base_ms,
                retry_cap_ms=self.cfg.jax_sink_retry_cap_ms,
                dirty_cap_rows=self.cfg.jax_sink_dirty_cap_rows,
                exactly_once=self._xo, fence_key=self._fence_key,
                epoch=self._sink_epoch, start_seq=self._sink_seq0)
        return self._writer

    # ------------------------------------------------------------------
    # exactly-once writeback (jax.sink.exactly_once)
    def _xo_attach_sink(self) -> None:
        """First fenced flush of an attempt: read the sink fence, detect
        unfenced flushes of a previous lineage, claim the next epoch.

        ``sink_seq > snapshot_seq`` means whole flushes landed after the
        snapshot this attempt restored; ``intent > seq`` on top catches a
        partly applied pipeline (intent is its first command, the commit
        seq its last).  Either way replayed increments would count twice,
        so the attempt writes every window it flushes absolute from the
        ledger.  A failed read cannot prove the sink clean: reconcile and
        retry the attach at the next flush."""
        if self._xo_attached or self.redis is None:
            return
        base_e, base_s = self._xo_baseline
        try:
            e, s, i = read_fence(self.redis, self._fence_key)
        except Exception:
            self.faults.inc("fence_read_errors")
            self._reconcile_all = True
            return   # _xo_attached stays False: retry next flush
        if max(s, i) > base_s:
            if not self._reconcile_all:
                self.faults.inc("sink_unfenced_resumes")
            self._reconcile_all = True
        epoch = max(e, base_e) + 1
        try:
            claim_epoch(self.redis, self._fence_key, epoch)
        except Exception:
            # nothing is submitted without a claimed epoch: retry the
            # whole attach next flush (a claim that landed despite the
            # error is simply superseded by the next one)
            self.faults.inc("fence_read_errors")
            return
        self._sink_epoch = epoch
        self._sink_seq0 = max(s, i, base_s)
        self._xo_attached = True

    def _fence_state(self) -> tuple[int, int]:
        """The (epoch, committed seq) a snapshot records; stable after
        ``drain_writes`` (``_snapshot_sync`` makes sure of it)."""
        if self._writer is not None and self._xo:
            return self._writer.fence_state()
        if self._sink_epoch is not None:
            return (self._sink_epoch, self._sink_seq0)
        return self._xo_baseline

    def _flush_exactly_once(self, time_updated: int | None) -> int:
        """The fenced flush.  Deltas fold into the cumulative per-window
        ledger first; tainted windows and, in reconcile mode, every
        window are written ABSOLUTE from the ledger (idempotent); the
        rest go as HINCRBY deltas.  Each submitted batch carries its
        (epoch, seq) fence inside the same pipeline."""
        self._xo_attach_sink()
        self._fold_pending_arrays()
        if not self._pending and not self._taint:
            return 0
        if self.redis is not None and self._sink_epoch is None:
            # no claimed epoch (sink unreachable at attach): hold every
            # delta in _pending and retry the attach next flush
            return 0
        totals = self._sink_totals
        for key, n in self._pending.items():
            if self.absolute_counts:
                totals[key] = n        # absolute engines: freshest wins
            else:
                totals[key] = totals.get(key, 0) + n
        if self._reconcile_all:
            abs_keys = self._taint | set(self._pending)
            delta_keys: list = []
        else:
            abs_keys = set(self._taint)
            delta_keys = [k for k in self._pending if k not in abs_keys]
        campaigns = self.encoder.campaigns
        rows_abs = [(campaigns[c], ts, totals[(c, ts)])
                    for (c, ts) in sorted(abs_keys)]
        rows_delta = [(campaigns[c], ts, self._pending[(c, ts)])
                      for (c, ts) in delta_keys]
        self._pending.clear()
        self._taint.clear()
        if rows_abs:
            self.faults.inc("reconciled_windows", len(rows_abs))
        if self._obs_lifecycle is not None:
            self._obs_lifecycle.note_flush(
                [ts for _, ts, _ in rows_abs] +
                [ts for _, ts, _ in rows_delta])
        total = len(rows_abs) + len(rows_delta)
        if self.redis is not None:
            writer = self._ensure_writer()
            # ledger rewrites first: FIFO order keeps an absolute write of
            # a window ahead of any later delta to it
            if rows_abs:
                writer.submit(rows_abs, time_updated, absolute=True)
            if rows_delta:
                writer.submit(rows_delta, time_updated,
                              absolute=self.absolute_counts)
        else:
            stamp = now_ms() if time_updated is None else time_updated
            if rows_abs:
                self._note_written(rows_abs, stamp)
            if rows_delta:
                self._note_written(rows_delta, stamp)
        return total

    def _native_table(self):
        """(names_blob, names_off, native_store) when the sink is the
        in-process native store, else None; built once.  Exactly-once
        mode always returns None: the array writeback has no fence hook,
        and the fence must ride the same pipeline as its rows."""
        if self._xo:
            return None
        if self._camp_table is False:
            tbl = None
            store = getattr(self.redis, "_store", None)
            if store is not None and hasattr(store,
                                             "write_windows_arrays"):
                names = [c.encode() for c in self.encoder.campaigns]
                off = np.zeros(len(names) + 1, np.int64)
                np.cumsum([len(b) for b in names], out=off[1:])
                tbl = (b"".join(names), off, store)
            self._camp_table = tbl
        return self._camp_table

    def _note_written(self, payload, stamp: int) -> None:
        """Latency + write-count bookkeeping at actual write time (writer
        thread).  With telemetry attached, each unique window's writeback
        latency also lands in the live histogram and the lifecycle."""
        if isinstance(payload, _ArrayRows):
            self.windows_written += len(payload)
            uniq = [int(t) for t in _unique_ts(payload.ts).tolist()]
            for t in uniq:
                self.window_latency[t] = stamp - t
            if self._obs_hist is not None:
                for t in uniq:
                    self._obs_hist.observe(stamp - t)
            if self._obs_lifecycle is not None:
                self._obs_lifecycle.note_written(uniq, stamp)
            self.latency_tracker.record_bulk(
                payload.ci, payload.ts, stamp, payload.campaigns)
            return
        self.windows_written += len(payload)
        for camp, ts, _ in payload:
            self.window_latency[ts] = stamp - ts
            self.latency_tracker.record(camp, ts, stamp)
        if self._obs_hist is not None or self._obs_lifecycle is not None:
            uniq = {ts for _, ts, _ in payload}
            if self._obs_hist is not None:
                for ts in uniq:
                    self._obs_hist.observe(stamp - ts)
            if self._obs_lifecycle is not None:
                self._obs_lifecycle.note_written(uniq, stamp)

    def _reclaim_failed_writes(self) -> None:
        """Fold failed writeback batches back into ``_pending`` so the
        next flush retries them (and snapshots never lose them)."""
        if self._writer is None:
            return
        idx = self.encoder.campaign_index
        for batch in self._writer.take_failed():
            self.faults.inc("sink_retries", len(batch))
            if self._xo:
                # the ledger already counted these deltas, and a failed
                # pipeline may have landed a prefix of them: re-merging
                # would count twice, dropping would count short.  Taint
                # the windows: the next flush rewrites them absolute.
                self._taint.update((idx[camp], int(ts))
                                   for camp, ts, _ in batch)
                continue
            for camp, ts, n in batch:
                if self.absolute_counts:
                    # a fresher re-drained estimate already pending
                    # supersedes the stale failed one
                    self._pending.setdefault((idx[camp], ts), n)
                else:
                    self._pending[(idx[camp], ts)] += n

    # ------------------------------------------------------------------
    # live telemetry (obs/): pull-oriented — the sampler thread polls
    # host-side bookkeeping; the pushed signals are the writeback
    # histogram and lifecycle (writer thread) and the dispatch hooks
    # (host loop)
    def attach_obs(self, registry, lifecycle: bool = False,
                   spans=None, occupancy=None, xfer=None) -> None:
        """Opt into live telemetry: register the window-latency streaming
        histogram on ``registry`` (obs.MetricsRegistry), fed at write
        time.  ``lifecycle=True`` attaches the per-window attribution
        tracker (obs.lifecycle); ``spans`` (obs.spans.SpanTracer) takes
        every Tracer stage span, the writer thread's included;
        ``occupancy`` (obs.occupancy.OccupancySampler) is called after
        every device dispatch; ``xfer`` (obs.xfer.TransferLedger)
        accounts every dispatch's host->device payload."""
        from streambench_tpu_torch.obs.lifecycle import WindowLifecycle

        self._obs_hist = registry.histogram(
            "streambench_window_latency_ms",
            "window writeback latency (time_updated - window_ts), ms")
        if lifecycle:
            self._obs_lifecycle = WindowLifecycle(
                registry, divisor_ms=self.divisor,
                lateness_ms=self.lateness)
        if spans is not None:
            spans.attach(self.tracer)
        if occupancy is not None:
            self._obs_occupancy = occupancy
        if xfer is not None:
            self._obs_xfer = xfer

    def telemetry(self) -> dict:
        """Point-in-time snapshot of host bookkeeping: plain field reads
        and one wall-clock call, no device sync — safe from the sampler
        thread at any cadence."""
        wm = self._host_wm
        writer = self._writer
        out = {
            "events": self.events_processed,
            "windows_written": self.windows_written,
            "watermark_lag_ms": (now_ms() - wm) if wm is not None else None,
            "sink_dirty_rows": (writer.dirty_rows()
                                if writer is not None else 0),
            # parked/pending flush backlog; tuple() snapshots the list
            # atomically under the GIL while the host loop appends
            "pending_rows": (len(self._pending)
                             + sum(int(t[0].shape[0])
                                   for t in tuple(self._pending_np))),
        }
        if self._xo:
            e, s = self._fence_state()
            out["sink_fence"] = {"epoch": e, "seq": s,
                                 "reconcile": self._reconcile_all,
                                 "tainted_windows": len(self._taint)}
        if self._devdecode is not None:
            out["device_decode"] = self._devdecode.telemetry()
        return out

    def _oldest_open_span_start(self) -> int | None:
        """Absolute event time of the oldest window that could still be
        open, from the host watermark mirror (no device pull): a window
        starting at ``ws`` is closed once ``ws + divisor + lateness <=
        watermark``.  Conservative — it may point at a window that
        already closed, never past one still open.  Read by the HLL
        engine, whose drains keep open windows' registers on the
        device."""
        if self._host_wm is None:
            return None
        base = self.encoder.base_time_ms or 0
        min_open_wid = (self._host_wm - base - self.lateness) // self.divisor
        if min_open_wid < 0:
            min_open_wid = 0
        return base + min_open_wid * self.divisor

    def drain_writes(self) -> None:
        """Block until every queued Redis writeback has landed: the sync
        point before a checkpoint commits."""
        if self._writer is not None:
            self._writer.drain()

    # ------------------------------------------------------------------
    # checkpoint/resume: the state is four fixed-shape tensors plus host
    # dicts, so a snapshot is one npz (``checkpoint.py``)
    def _snapshot_sync(self) -> None:
        """Make host bookkeeping snapshot-complete: parked drain deltas
        live in neither the counts (zeroed) nor _pending, so fold them
        in; queued writebacks must land before the snapshot commits;
        batches whose write failed are reclaimed into _pending."""
        self._materialize_drains()
        self._fold_pending_arrays()
        self.drain_writes()
        self._reclaim_failed_writes()

    def _snapshot_meta(self) -> dict:
        """Host-side snapshot meta, as the JAX engine writes it."""
        return dict(
            engine_family=self.ENGINE_FAMILY,
            base_time_ms=self.encoder.base_time_ms,
            divisor_ms=self.divisor,
            lateness_ms=self.lateness,
            window_slots=self.W,
            span_start=self._span_start,
            events_processed=self.events_processed,
            windows_written=self.windows_written,
            started_ms=self.started_ms,
            last_event_ms=self.last_event_ms,
            num_campaigns=self.encoder.num_campaigns,
        )

    def snapshot(self, offset) -> Snapshot:
        """Capture exact engine state as of journal byte ``offset`` (or a
        per-partition offset vector)."""
        self._snapshot_sync()
        state = wc.state_to_numpy(self.state)
        return self._xo_decorate(Snapshot(
            offset=offset,
            meta=self._snapshot_meta(),
            counts=state.counts,
            window_ids=state.window_ids,
            watermark=int(state.watermark),
            dropped=int(state.dropped),
            pending=[(c, ts, n) for (c, ts), n in self._pending.items()],
            latency=sorted(self.window_latency.items()),
        ))

    def _xo_decorate(self, snap: Snapshot) -> Snapshot:
        """Attach the exactly-once ledger, taint and fence to a snapshot
        (a no-op with the flag off).  Call after ``_snapshot_sync``."""
        if not self._xo:
            return snap
        e, s = self._fence_state()
        snap.meta["sink_epoch"] = int(e)
        snap.meta["sink_seq"] = int(s)
        snap.extra["xo_totals"] = np.asarray(
            [(c, ts, n)
             for (c, ts), n in sorted(self._sink_totals.items())],
            np.int64).reshape(-1, 3)
        snap.extra["xo_taint"] = np.asarray(
            sorted(self._taint), np.int64).reshape(-1, 2)
        return snap

    def _check_geometry(self, snap: Snapshot,
                        extra: dict[str, int] | None = None) -> None:
        """Family + ring-geometry validation: window ids are relative to
        divisor and base, slots to W, so a mismatch is a hard error;
        ``extra`` adds an engine's own meta keys (sketch geometry)."""
        fam = snap.meta.get("engine_family", "exact")
        if fam != self.ENGINE_FAMILY:
            raise ValueError(
                f"checkpoint was written by engine family {fam!r}; this "
                f"engine is {self.ENGINE_FAMILY!r} -- device state is not "
                "interchangeable across families")
        checks = dict(num_campaigns=self.encoder.num_campaigns,
                      divisor_ms=self.divisor,
                      lateness_ms=self.lateness,
                      window_slots=self.W)
        checks.update(extra or {})
        for key, mine in checks.items():
            if int(snap.meta[key]) != mine:
                raise ValueError(
                    f"checkpoint {key}={snap.meta[key]} != engine {mine}; "
                    "restart with the original config or discard the "
                    "checkpoint")

    def _restore_host(self, snap: Snapshot) -> None:
        """Re-establish every host-side field from the snapshot."""
        self.drain_writes()
        self._undrained.clear()
        self._undrained_ready.clear()
        self._dirty_rows = []
        if self._track_dirty_rows() and snap.counts.size:
            # restored counts may hold undrained cells the tracker never
            # saw: mark their rows dirty so the next drain finds them
            live = np.nonzero(np.asarray(snap.counts).any(axis=1))[0]
            if live.size:
                self._dirty_rows.append(live)
        self.encoder.set_base_time(snap.meta["base_time_ms"])
        self._span_start = snap.meta["span_start"]
        # gate on the NEG "no events" sentinel, not truthiness: a
        # relative watermark of 0 is set (host_wm = base); NEG, or a
        # snapshot taken before the first event (no base), is unset
        wm = int(snap.watermark)
        base = snap.meta["base_time_ms"]
        self._host_wm = (int(base) + wm
                         if base is not None and wm > wc.NEG else None)
        self.events_processed = int(snap.meta["events_processed"])
        self.windows_written = int(snap.meta["windows_written"])
        self.started_ms = int(snap.meta["started_ms"])
        self.last_event_ms = int(snap.meta["last_event_ms"])
        self._pending = defaultdict(int)
        self._pending_np = []
        for c, ts, n in snap.pending:
            self._pending[(int(c), int(ts))] = int(n)
        self.window_latency = {int(ts): int(v) for ts, v in snap.latency}
        # exactly-once bookkeeping (flag off: the arrays are absent and
        # everything resets to its dormant state); the sink fence is read
        # at the first flush and judged against the baseline set here
        self._sink_totals = {
            (int(c), int(ts)): int(n)
            for c, ts, n in snap.extra.get(
                "xo_totals", np.empty((0, 3), np.int64))}
        self._taint = {(int(c), int(ts))
                       for c, ts in snap.extra.get(
                           "xo_taint", np.empty((0, 2), np.int64))}
        self._xo_baseline = (int(snap.meta.get("sink_epoch", 0)),
                             int(snap.meta.get("sink_seq", 0)))
        self._reconcile_all = False
        self._xo_attached = not self._xo
        self._sink_epoch = None
        self._sink_seq0 = 0

    def restore(self, snap: Snapshot) -> None:
        """Reset this engine to a snapshot; the caller re-tails the
        journal at ``snap.offset``."""
        self._check_geometry(snap)
        self.state = self._put_state(
            snap.counts, snap.window_ids, snap.watermark, snap.dropped)
        self._restore_host(snap)

    def _put_state(self, counts, window_ids, watermark, dropped):
        """Place restored host arrays on the engine's device."""
        return wc.state_from_numpy((counts, window_ids, watermark, dropped),
                                   self.device)

    # ------------------------------------------------------------------
    # Bounded shutdown retry: a transient sink outage at close must not
    # abandon the last flush's rows.
    CLOSE_RETRY_LIMIT = 8

    def _close_unwritten(self) -> int:
        """Window rows still unflushed at close: writer-retained failed
        batches, plus (exactly-once) pending and tainted windows that a
        sink-unreachable attach kept from ever being submitted."""
        n = self._writer.dirty_rows() if self._writer is not None else 0
        if self._xo:
            n += len(self._pending) + len(self._taint)
        return n

    def close(self) -> None:
        """Final flush + fork-style latency dump
        (``AdvertisingTopologyNative.java:521-532``).  Retries the final
        writeback up to ``CLOSE_RETRY_LIMIT`` times before declaring the
        rows lost."""
        self.flush(final=True)
        if self._writer is not None:
            self._writer.drain()
        for _ in range(self.CLOSE_RETRY_LIMIT):
            if not self._close_unwritten():
                break
            self.flush(final=True)  # reclaims failed rows, resubmits
            if self._writer is not None:
                self._writer.drain()
        if self._writer is None and self._close_unwritten():
            # exactly-once with the sink down since before the first
            # flush: no writer ever started, so account and raise here
            lost = self._close_unwritten()
            self.faults.inc("rows_lost", lost)
            raise RuntimeError(
                f"exactly-once close with {lost} windows never flushed "
                "(sink unreachable: no writer epoch was ever claimed)")
        if self._encode_pool is not None:
            self._encode_pool.close()
            self._encode_pool = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self.redis is not None and self.cfg.redis_hashtable:
            dump_latency_hash(
                self.redis, self.cfg.redis_hashtable, self.window_latency,
                running_time_ms=self.last_event_ms - self.started_ms)

    @property
    def dropped(self) -> int:
        return int(self.state.dropped)
