"""The exact-count engine: encode -> device fold -> delta drain -> Redis.

The port of ``streambench_tpu/engine/pipeline.py:AdAnalyticsEngine`` for
BASELINE config #1 (the exact per-(campaign, 10 s window) view count).
Host code (encoding, the Redis writer, the span guard) is the JAX
engine's; the device fold is ``ops.windowcount`` on torch tensors, with
the count going through the hand-written CUDA kernel on the card.

Correctness invariant (ring reuse): between two drains the stream's
event-time span must stay within the ring's safe span, or a new window
could claim a slot whose counts were never drained.  The engine tracks
event times on the host (no device sync) and drains the device deltas
into a host-side pending buffer when the span guard trips; the wall-clock
flush cadence to Redis stays the reference's 1 Hz.

Not ported yet (later slices): the dirty-rows and compact drains (needed
only at >= 2^22 cells), snapshot/restore, exactly-once writeback,
observability hooks, device decode and the parallel encode pool.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
from collections import defaultdict

import numpy as np
import torch

from streambench_tpu_torch.config import BenchmarkConfig
from streambench_tpu_torch.encode.native_encoder import make_encoder
from streambench_tpu_torch.io.redis_schema import (
    RedisLike,
    dump_latency_hash,
    write_windows_pipelined,
)
from streambench_tpu_torch.metrics import FaultCounters, LatencyTracker
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
    ``CampaignProcessorCommon.java:35-55``), copied from the JAX engine
    without its exactly-once fence protocol.

    ``time_updated`` is stamped by THIS thread at actual write time
    (``core.clj:149`` defines latency truth).  A bounded queue provides
    backpressure.  A failed write is retained for reclaim (never dropped),
    the next attempt waits a capped exponential backoff, a
    ``reconnect()``-capable client is re-dialed, and the retained buffer
    is coalesced by (campaign, window) past a high-water row count.
    """

    def __init__(self, redis: RedisLike, tracer: Tracer,
                 on_written, faults: "FaultCounters | None" = None,
                 retry_base_ms: int = 100, retry_cap_ms: int = 5000,
                 dirty_cap_rows: int = 1 << 18) -> None:
        self._redis = redis
        self._tracer = tracer
        self._on_written = on_written   # (rows, stamp) latency bookkeeping
        self._faults = faults if faults is not None else FaultCounters()
        self._retry_base_ms = max(int(retry_base_ms), 1)
        self._retry_cap_ms = max(int(retry_cap_ms), self._retry_base_ms)
        self._dirty_cap_rows = max(int(dirty_cap_rows), 1)
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
        """Merge the retained batches by (campaign, window); deltas sum.
        Called with the lock held, past the high-water mark only."""
        merged: dict[tuple, int] = {}
        for batch in self._failed:
            for camp, ts, n in batch:
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
                payload, stamp = item
                stamp = now_ms() if stamp is None else stamp
                arrays = not isinstance(payload, list)
                try:
                    with self._tracer.span("redis_flush"):
                        if arrays:
                            # (ci, ts, cnt) numpy triple against the
                            # native store: campaign table passed once,
                            # zero per-row Python work
                            blob, off, store = payload.table
                            store.write_windows_arrays(
                                blob, off, payload.ci, payload.ts,
                                payload.cnt, str(stamp), absolute=False)
                        else:
                            write_windows_pipelined(
                                self._redis, payload, time_updated=stamp,
                                cache=self._uuid_cache)
                except BaseException as e:  # retained for reclaim/retry
                    self._on_failure(payload.to_rows() if arrays
                                     else payload, e)
                else:
                    self._consec_failures = 0
                    # latency bookkeeping only for rows that actually landed
                    self._on_written(payload, stamp)
            finally:
                self._q.task_done()

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

    def submit(self, rows, stamp: int | None) -> None:
        """Queue one writeback payload (rows list or ``_ArrayRows``)."""
        self._q.put((rows, stamp))

    def drain(self) -> None:
        """Block until every submitted batch was attempted.  Failures are
        not raised here — they sit in ``take_failed`` for reclaim."""
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


class AdAnalyticsEngine:
    """Exact per-(campaign, 10 s window) view counting — BASELINE config #1.

    ``device`` defaults to ``"cuda"``; without CUDA the constructor
    raises unless the caller passes ``device="cpu"``."""

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 campaigns: list[str] | None = None,
                 redis: RedisLike | None = None,
                 method: str | None = None,
                 device: torch.device | str | None = None):
        if cfg.jax_sink_exactly_once:
            raise ValueError("jax.sink.exactly_once is not ported to the "
                             "PyTorch engine yet")
        if cfg.jax_decode_device != "off":
            raise ValueError("jax.decode.device is not ported to the "
                             "PyTorch engine yet; set it to \"off\"")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.redis = redis
        self.divisor = cfg.jax_time_divisor_ms
        self.lateness = cfg.jax_allowed_lateness_ms
        self.encoder = make_encoder(ad_to_campaign, campaigns,
                                    divisor_ms=self.divisor,
                                    lateness_ms=self.lateness,
                                    use_native=cfg.jax_use_native_encoder)
        # the exact count never reads the user/page columns
        self.encoder.set_intern_ids(False)
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
        # Parked drains ("dense", deltas, wids, copied_event): device
        # tensors whose host materialization is postponed to flush time.
        # On CUDA (_defer_pull) the device->host copies start at park
        # time, non_blocking into pinned buffers, gated by a CUDA event;
        # a periodic flush materializes only the drains parked one cycle
        # earlier (_undrained_ready), whose copies have long landed.
        self._undrained: list[tuple] = []
        self._undrained_ready: list[tuple] = []
        self._defer_pull = self.device.type == "cuda"
        # Packed wire word (ops.windowcount.pack_columns) while the ad
        # space fits its 28-bit field.
        self._pack_ok = self.encoder.join_table.size < wc.PACK_AD_MAX
        # pending Redis deltas: (campaign_idx, abs_window_ts) -> count
        # (dict = slow path for reclaims; _pending_np = numpy triples
        # straight from drains, the hot path)
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
        self._writer: _RedisWriter | None = None

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Build the count kernel and run every device path once — a step,
        a scan group and a drain — on all-invalid batches (masked in every
        op, so state is semantically unchanged), then synchronise."""
        zb = self.encoder.encode([], self.batch_size)
        with self.tracer.span("warmup"):
            self._device_step(zb)
            if self.scan_batches > 1:
                self._fold_stack([zb, zb])
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
        through the encoder, empty batches dropped."""
        B = self.batch_size
        batches = []
        for off in range(0, len(lines), B):
            with self.tracer.span("encode"):
                b = self.encoder.encode(lines[off:off + B], B)
            if b.n:
                batches.append(b)
        return batches

    def fold_batches(self, batches: list) -> int:
        """Fold encoded batches into device state IN ORDER, grouped by
        ``scan_batches``.  Returns parsed events folded."""
        before = self.events_processed
        K = self.scan_batches
        if K <= 1:
            for b in batches:
                self._fold(b)
        else:
            for g in range(0, len(batches), K):
                self._fold_group(batches[g:g + K])
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
        with self.tracer.span("device_scan"):
            self._fold_stack(batches)
        self.events_processed += sum(b.n for b in batches)
        self.last_event_ms = now_ms()

    def _fold_stack(self, batches: list) -> None:
        """Ship ``batches`` as [K, B] stacks and fold them with one scan
        call."""
        if self._pack_ok:
            packs = [wc.pack_columns(b.ad_idx, b.event_type, b.valid)
                     for b in batches]
            self._device_scan_packed(
                self._to_device(np.stack(packs)),
                self._to_device(np.stack([b.event_time for b in batches])))
            return
        self._device_scan(*(
            self._to_device(np.stack([getattr(b, name) for b in batches]))
            for name in ("ad_idx", "event_type", "event_time", "valid")))

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
        Python objects (the native encoder)."""
        return hasattr(self.encoder, "encode_block")

    def process_block(self, data: bytes) -> int:
        """Ingest one raw journal block (complete newline-delimited
        records).  Returns parsed events folded."""
        if not data:
            return 0
        return self.fold_batches(self.encode_raw_block(data))

    def encode_raw_block(self, data: bytes) -> list:
        """Encode-only half of ``process_block``: carve + parse one raw
        journal block into ``EncodedBatch`` groups without folding."""
        if not data:
            return []
        if not self.supports_block_ingest:
            lines = data.split(b"\n")
            if lines and not lines[-1]:
                lines.pop()
            return self.encode_chunk_lines(lines)
        B = self.batch_size
        with self.tracer.span("encode"):
            batches, start = self.encoder.carve_block(data, B)
            if start < len(data):
                # unterminated trailing record: parse it as one line so
                # both process_block branches see identical events
                b = self.encoder.encode([data[start:]], B)
                if b.n:
                    batches.append(b)
        return batches

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
        with self.tracer.span("device_step"):
            self._device_step(batch)
        self.events_processed += batch.n
        self.last_event_ms = now_ms()

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
    def _drain_device(self) -> None:
        """Hand the device deltas to a parked drain for ring reuse;
        materialization is deferred to ``_materialize_drains``."""
        deltas, wids, self.state = wc.flush_deltas(
            self.state, divisor_ms=self.divisor, lateness_ms=self.lateness)
        self._park(deltas, wids)
        self._span_start = None

    def _park(self, deltas: torch.Tensor, wids: torch.Tensor) -> None:
        """Park one dense drain.  On CUDA the device->host copies start
        NOW (non_blocking into pinned buffers, on the stream that ran the
        steps, so they see every step before the drain), and a CUDA event
        marks their completion; the buffers live in the parked tuple
        until it is materialized."""
        done = None
        if self._defer_pull:
            host_d = torch.empty(deltas.shape, dtype=deltas.dtype,
                                 pin_memory=True)
            host_w = torch.empty(wids.shape, dtype=wids.dtype,
                                 pin_memory=True)
            host_d.copy_(deltas, non_blocking=True)
            host_w.copy_(wids, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            deltas, wids = host_d, host_w
        self._undrained.append(("dense", deltas, wids, done))

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
        for tag, deltas_t, wids_t, done in parked_list:
            if tag != "dense":
                raise ValueError(f"unknown parked drain tag {tag!r}")
            if done is not None:
                done.synchronize()
            deltas = deltas_t.numpy()
            wids = wids_t.numpy()
            ci, si = np.nonzero(deltas)
            if ci.size == 0:
                continue
            vals = deltas[ci, si]
            wid = wids[si]
            keep = wid >= 0
            if not keep.all():
                ci, wid, vals = ci[keep], wid[keep], vals[keep]
            if ci.size:
                self._pending_np.append(
                    (ci.astype(np.int64),
                     base + wid.astype(np.int64) * self.divisor,
                     vals.astype(np.int64)))

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
        if not self._pending and not self._pending_np:
            return 0
        campaigns = self.encoder.campaigns
        rows = [(campaigns[c], ts, n)
                for (c, ts), n in self._pending.items()]
        self._pending.clear()
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
        """Get-or-start the background writeback thread."""
        if self._writer is None:
            self._writer = _RedisWriter(
                self.redis, self.tracer,
                self._note_written, faults=self.faults,
                retry_base_ms=self.cfg.jax_sink_retry_base_ms,
                retry_cap_ms=self.cfg.jax_sink_retry_cap_ms,
                dirty_cap_rows=self.cfg.jax_sink_dirty_cap_rows)
        return self._writer

    def _native_table(self):
        """(names_blob, names_off, native_store) when the sink is the
        in-process native store, else None; built once."""
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
        """Latency + write-count bookkeeping at actual write time."""
        if isinstance(payload, _ArrayRows):
            self.windows_written += len(payload)
            for t in _unique_ts(payload.ts).tolist():
                self.window_latency[int(t)] = stamp - int(t)
            self.latency_tracker.record_bulk(
                payload.ci, payload.ts, stamp, payload.campaigns)
            return
        self.windows_written += len(payload)
        for camp, ts, _ in payload:
            self.window_latency[ts] = stamp - ts
            self.latency_tracker.record(camp, ts, stamp)

    def _reclaim_failed_writes(self) -> None:
        """Fold failed writeback batches back into ``_pending`` so the
        next flush retries them."""
        if self._writer is None:
            return
        idx = self.encoder.campaign_index
        for batch in self._writer.take_failed():
            self.faults.inc("sink_retries", len(batch))
            for camp, ts, n in batch:
                self._pending[(idx[camp], ts)] += n

    def drain_writes(self) -> None:
        """Block until every queued Redis writeback has landed."""
        if self._writer is not None:
            self._writer.drain()

    # ------------------------------------------------------------------
    # Bounded shutdown retry: a transient sink outage at close must not
    # abandon the last flush's rows.
    CLOSE_RETRY_LIMIT = 8

    def close(self) -> None:
        """Final flush + fork-style latency dump
        (``AdvertisingTopologyNative.java:521-532``).  Retries the final
        writeback up to ``CLOSE_RETRY_LIMIT`` times before declaring the
        rows lost."""
        self.flush(final=True)
        if self._writer is not None:
            self._writer.drain()
            for _ in range(self.CLOSE_RETRY_LIMIT):
                if not self._writer.dirty_rows():
                    break
                self.flush(final=True)  # reclaims failed rows, resubmits
                self._writer.drain()
            self._writer.close()
            self._writer = None
        if self.redis is not None and self.cfg.redis_hashtable:
            dump_latency_hash(
                self.redis, self.cfg.redis_hashtable, self.window_latency,
                running_time_ms=self.last_event_ms - self.started_ms)

    @property
    def dropped(self) -> int:
        return int(self.state.dropped)
