"""Streaming host loop: journal tail -> engine -> 1 Hz Redis flush.

The port of ``streambench_tpu/engine/runner.py``: the serial loops
(``run`` and ``run_catchup``, in block mode where the engine and reader
support it) and their pipelined twins over the staged ingest pipeline
(``engine.ingest``), with the checkpoint cadence and ``resume``.  The
operating policies are the reference engines':

- **buffer timeout** — a partial batch is dispatched once it is
  ``buffer_timeout_ms`` old (Flink's ``setBufferTimeout(100)``,
  ``AdvertisingTopologyNative.java:77-79``).
- **1 Hz flusher** — dirty windows are written to Redis every
  ``flush_interval_ms`` (``CampaignProcessorCommon.java:41-54``).
- **pipelining** — CUDA launches are asynchronous: while the card folds
  batch N, the host is already tailing and encoding batch N+1.  With
  ``jax.ingest.pipeline`` "on" (or "auto" where it pays) the journal read
  and the encode also run on their own threads, so the host loop only
  dispatches folds and flushes.
- **checkpoints** — with a ``Checkpointer``, a snapshot of the engine at
  the reader's offset is saved after a flush once
  ``checkpoint_interval_ms`` has passed (0 = after every flush), and once
  more at the end of a run; ``resume()`` restores the newest one.  Under
  the ingest pipeline the stages are quiesced around the snapshot, whose
  offset is the folded position, never the read-ahead.
- **observability** — with a flight recorder (``obs.flightrec``) the
  loop records a tick at every flush and the checkpoints, and a loop
  that dies dumps the ring; with a span tracer (``obs.spans``) the
  serial loops add their journal reads and the pipeline its stage
  spans; ``flush_hooks`` run on the host loop after every periodic
  flush (the triggered profiler capture and the device-memory census,
  which must touch torch from this thread only).
- **chaos points** — with a crash scheduler (``crash_points``, the
  chaos layer's ``CrashScheduler``) the loops pass a ``batch`` point
  after each committed fold, a ``flush`` point after each flush (before
  its checkpoint check) and a ``checkpoint`` point after each save, the
  reference runner's boundaries; the scheduler raises the scripted
  ``EngineCrash`` there.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.engine import ingest
from streambench_tpu_torch.engine.pipeline import AdAnalyticsEngine
from streambench_tpu_torch.io.journal import JournalReader
from streambench_tpu_torch.metrics import StallDetector
from streambench_tpu_torch.utils.ids import now_ms


@dataclass
class RunStats:
    events: int = 0
    batches: int = 0
    flushes: int = 0
    windows_written: int = 0
    started_ms: int = 0
    finished_ms: int = 0
    # Fault/retry accounting for this run (sink errors, retries, skipped
    # corrupt records...) — non-zero keys only; {} on a clean run.
    faults: dict = field(default_factory=dict)

    @property
    def wall_s(self) -> float:
        return max(self.finished_ms - self.started_ms, 1) / 1000.0

    @property
    def events_per_s(self) -> float:
        return self.events / self.wall_s


class StreamRunner:
    """Drives one engine from one journal reader until stopped."""

    # Wire bytes per event, rounded up (sizes block-mode reads; the
    # generator's JSON events run ~230 B).
    EST_EVENT_BYTES = 256

    def __init__(self, engine: AdAnalyticsEngine, reader: JournalReader,
                 batch_size: int | None = None,
                 buffer_timeout_ms: int | None = None,
                 flush_interval_ms: int | None = None,
                 checkpointer: Checkpointer | None = None,
                 checkpoint_interval_ms: int | None = None,
                 ingest_pipeline: str | None = None,
                 crash_points=None,
                 flightrec=None, spans=None):
        cfg = engine.cfg
        self.engine = engine
        self.reader = reader
        self.batch_size = batch_size or cfg.jax_batch_size
        self.buffer_timeout_ms = (buffer_timeout_ms
                                  if buffer_timeout_ms is not None
                                  else cfg.jax_buffer_timeout_ms)
        self.flush_interval_ms = (flush_interval_ms
                                  if flush_interval_ms is not None
                                  else cfg.jax_flush_interval_ms)
        self.checkpointer = checkpointer
        self.checkpoint_interval_ms = (
            checkpoint_interval_ms if checkpoint_interval_ms is not None
            else cfg.jax_checkpoint_interval_ms)
        self._last_ckpt = time.monotonic()
        # Backpressure canary: warn when the flush cadence slips to >2x its
        # period (the Apex stall warning, ProcessTimeAwareStore.java:84-87).
        self.stall_detector = StallDetector(
            expected_period_ms=max(self.flush_interval_ms, 1),
            counters=engine.faults)
        self.stats = RunStats()
        self._stop = False
        self._drain_on_stop = False
        # Staged ingest pipeline (engine.ingest): "off" keeps the serial
        # loops byte-identical, "on" forces the overlapped stages, "auto"
        # enables them where block-mode ingest makes the overlap pay.
        mode = (ingest_pipeline if ingest_pipeline is not None
                else cfg.jax_ingest_pipeline)
        self.ingest_mode = (mode or "off").strip().lower()
        self._pipeline: ingest.IngestPipeline | None = None
        # Chaos hook (chaos.plan.CrashScheduler or None): the loops call
        # point(kind) at every batch/flush/checkpoint boundary, which
        # raises the simulated EngineCrash where the script says.  None
        # (the default) keeps the loops as they are.
        self.crash_points = crash_points
        if cfg.jax_decode_device == "auto":
            # auto device decode follows the A/B of the mode resolved here
            engine.settle_decode(self._pipeline_on())
        # Crash flight recorder (obs.flightrec or None): a "tick" record
        # at every flush cycle + checkpoint offsets, dumped with the
        # terminal fault when a run loop dies.
        self.flightrec = flightrec
        self._flight_prev_faults: dict = {}
        # Span tracer (obs.spans or None): the engine's Tracer spans are
        # forwarded by attach_obs; the runner adds the READ side — the
        # serial loops' journal polls and the pipeline's stage spans.
        self.spans = spans
        # Callables run on the host loop after every periodic flush; the
        # CLI sets them (capture, device-memory census).
        self.flush_hooks: tuple = ()

    # A drain-on-stop reads the source for at most this long.
    STOP_DRAIN_S = 30.0

    def stop(self, drain: bool = False) -> None:
        """End the run loop.  ``drain`` (the CLI's SIGTERM) first folds
        what the source already holds, up to a poll that comes back empty
        (at most ``STOP_DRAIN_S``), so a stop that follows the producer's
        counts everything it wrote (the serial loop; the pipelined one
        folds what its stages read)."""
        self._drain_on_stop = drain
        self._stop = True

    def _chaos_point(self, kind: str) -> None:
        if self.crash_points is not None:
            self.crash_points.point(kind)

    # ------------------------------------------------------------------
    # crash flight recorder (obs.flightrec)
    def _flight_tick(self) -> None:
        """One structured sample into the flight ring (flush cadence):
        progress counters, watermark lag, sink health, fault deltas,
        and — when the staged pipeline is live — its queue depths."""
        fr = self.flightrec
        if fr is None:
            return
        tel = self.engine.telemetry()
        rec = {"events": tel["events"],
               "windows_written": tel["windows_written"],
               "watermark_lag_ms": tel["watermark_lag_ms"],
               "pending_rows": tel["pending_rows"],
               "sink_dirty_rows": tel["sink_dirty_rows"],
               "batches": self.stats.batches,
               "flushes": self.stats.flushes}
        if "sink_fence" in tel:
            rec["sink_fence"] = tel["sink_fence"]
        faults = self.engine.faults.snapshot()
        deltas = {k: v - self._flight_prev_faults.get(k, 0)
                  for k, v in faults.items()
                  if v != self._flight_prev_faults.get(k, 0)}
        self._flight_prev_faults = faults
        if deltas:
            rec["fault_deltas"] = deltas
        pipe = self._pipeline
        if pipe is not None and not pipe.closed:
            ing = pipe.telemetry()
            rec["ingest"] = {k: ing[k] for k in
                             ("block_queue_depth", "batch_queue_depth",
                              "reader_stalls", "encode_stalls")}
        fr.record("tick", **rec)

    def _flight_crash(self, err: BaseException) -> None:
        """A run loop died: freeze the ring with the terminal fault as
        the last record."""
        fr = self.flightrec
        if fr is None:
            return
        try:
            offset = self._reader_position()
        except Exception:
            offset = None
        fr.dump("crash", terminal={
            "kind": "fault", "event": "crash", "error": repr(err),
            "offset": offset, "events": self.stats.events,
            "batches": self.stats.batches,
            "flushes": self.stats.flushes})

    def _read_span(self, t0_ns: int, records: "int | None") -> None:
        """A non-empty journal read of a serial loop, as a span (empty
        polls at the 1 ms yield cadence would flood the bounded ring)."""
        self.spans.add("journal_read", t0_ns, time.perf_counter_ns() - t0_ns,
                       cat="ingest",
                       args=None if records is None else {"records": records})

    def _block_mode(self) -> bool:
        """Native scanner over raw bytes when both ends support it."""
        return (self.engine.supports_block_ingest
                and hasattr(self.reader, "poll_block"))

    def _collect_faults(self) -> None:
        """Surface fault/retry accounting in ``stats.faults`` (end of a
        run): engine counters + encoder rejects + reader corruption."""
        f: dict[str, int] = dict(self.engine.faults.snapshot())

        def add(key: str, n: int) -> None:
            if n:
                f[key] = f.get(key, 0) + n

        enc = self.engine.encoder
        add("bad_lines", int(enc.bad_lines))
        add("dlq_lines", int(enc.dlq_lines))
        add("journal_corrupt_skipped",
            int(getattr(self.reader, "corrupt_records", 0)))
        # a chaos-wrapped reader's injector counters (journal faults,
        # sink faults, crashes injected so far)
        chaos_counts = getattr(self.reader, "fault_counters", None)
        if chaos_counts is not None:
            for k, v in chaos_counts.snapshot().items():
                add(k, v)
        self.stats.faults = f

    def _reader_position(self) -> int | list[int]:
        """Single-partition byte offset, or the per-partition offsets
        vector of a ``MultiReader`` (whose scalar ``.offset`` raises).
        With the ingest pipeline active this is the FOLDED position —
        the offset covering exactly the dispatched blocks, never the
        reader thread's read-ahead — so checkpoints stay consistent."""
        if self._pipeline is not None:
            return self._pipeline.position()
        try:
            return self.reader.offset
        except AttributeError:
            return list(self.reader.offsets)

    def resume(self) -> bool:
        """Restore engine + reader from the newest checkpoint, if any.
        Call before ``run``; returns True when a snapshot was applied."""
        if self.checkpointer is None:
            return False
        snap = self.checkpointer.load()
        if snap is None:
            return False
        self.engine.restore(snap)
        if isinstance(snap.offset, list):
            self.reader.seek_offsets(snap.offset)
        else:
            self.reader.seek(snap.offset)
        return True

    def _checkpoint_now(self, now: float) -> None:
        pipe = self._pipeline
        if pipe is not None and not pipe.closed:
            # Quiesce the stages at a work-item boundary so the snapshot
            # can serialize encoder state (the base time) without racing
            # the encode thread; the returned offset covers exactly the
            # folded blocks (in-flight prefetched blocks stay replayable,
            # never skippable).
            off = pipe.quiesce()
            try:
                self.checkpointer.save(self.engine.snapshot(off))
            finally:
                pipe.resume()
        else:
            off = self._reader_position()
            self.checkpointer.save(self.engine.snapshot(off))
        if self.flightrec is not None:
            self.flightrec.record("checkpoint", offset=off,
                                  events=self.engine.events_processed)
        self._last_ckpt = now
        self._chaos_point("checkpoint")

    def _checkpoint_due(self, now: float) -> bool:
        return (self.checkpointer is not None and
                (now - self._last_ckpt) * 1000 >= self.checkpoint_interval_ms)

    def _flush(self, now: float) -> None:
        """The periodic flush, its stall tick, the flight tick, the flush
        hooks, the flush crash point and the checkpoint cadence.  The
        crash point sits between the flush and its checkpoint: the
        replay window the at-least-once bound covers."""
        st = self.stats
        st.windows_written += self.engine.flush()
        st.flushes += 1
        self.stall_detector.tick(int(time.monotonic() * 1000))
        self._flight_tick()
        for hook in self.flush_hooks:
            hook()
        self._chaos_point("flush")
        if self._checkpoint_due(now):
            self._checkpoint_now(now)

    def _finish_run(self) -> None:
        """Final flush + checkpoint shared by every loop's exit path."""
        st = self.stats
        st.windows_written += self.engine.flush(final=True)
        st.flushes += 1
        self._flight_tick()   # short runs still leave ring context
        self._chaos_point("flush")
        if self.checkpointer is not None:
            self._checkpoint_now(time.monotonic())

    # ------------------------------------------------------------------
    # staged ingest pipeline (engine.ingest)
    def _pipeline_on(self) -> bool:
        """Resolve the ingest mode: "on" always pipelines, "auto" only
        where the overlap can pay — block-mode ingest (native encoder +
        a ``poll_block`` reader) AND more than one host core (on one
        core the stages just timeslice it), "off" (default) never — the
        serial loops below stay byte-identical."""
        if self.ingest_mode == "on":
            return True
        if self.ingest_mode == "auto":
            return (os.cpu_count() or 1) > 1 and self._block_mode()
        return False

    def _make_pipeline(self, catchup: bool) -> ingest.IngestPipeline:
        cfg = self.engine.cfg
        pipe = ingest.IngestPipeline(
            self.engine, self.reader,
            batch_size=self.batch_size,
            chunk_records=self.batch_size * self.engine.scan_batches,
            buffer_timeout_ms=self.buffer_timeout_ms,
            catchup=catchup,
            est_event_bytes=self.EST_EVENT_BYTES,
            block_queue=cfg.jax_ingest_block_queue,
            batch_queue=cfg.jax_ingest_batch_queue,
            flightrec=self.flightrec, spans=self.spans)
        self._pipeline = pipe
        return pipe

    def _fold_item(self, item: ingest.IngestItem) -> None:
        """Dispatch one ready group: fold in journal order, then publish
        its offset as folded (strictly after — a crash between the two
        replays the block instead of skipping it)."""
        st = self.stats
        st.events += self.engine.fold_batches(item.batches)
        st.batches += 1
        self._pipeline.commit(item)
        self._chaos_point("batch")

    def _flush_cycle(self, now: float, last_flush: float) -> float:
        """The 1 Hz flush + stall tick + checkpoint cadence of the
        pipelined loops.  Returns the new ``last_flush``."""
        if (now - last_flush) * 1000 >= self.flush_interval_ms:
            self._flush(now)
            last_flush = now
        return last_flush

    def _run_pipelined(self, duration_s: float | None,
                       idle_timeout_s: float | None,
                       max_events: int | None) -> RunStats:
        """Streaming loop over the staged pipeline: the reader thread
        owns polling + batching (buffer_timeout semantics included), the
        encode thread owns encoding, and this loop does only device
        dispatch + flush — the stages overlap instead of taking turns."""
        st = self.stats
        st.started_ms = now_ms()
        deadline = (time.monotonic() + duration_s) if duration_s else None
        last_flush = time.monotonic()
        pipe = self._make_pipeline(catchup=False)
        try:
            while not self._stop:
                now = time.monotonic()
                if deadline and now >= deadline:
                    break
                if max_events and st.events >= max_events:
                    break
                item = pipe.get(timeout_s=0.02)
                if item is not None and item is not ingest.EOF:
                    self._fold_item(item)
                elif (idle_timeout_s and pipe.drained()
                        and pipe.idle_for() >= idle_timeout_s):
                    # idle means the READER polled and found nothing for
                    # a while AND everything it did read was folded
                    break
                last_flush = self._flush_cycle(time.monotonic(),
                                               last_flush)
            # Drain what the stages already read (the serial loop's
            # trailing ``if pending: dispatch()``) — unless the cutoff
            # was max_events, where uncommitted blocks stay replayable.
            pipe.finish()
            drain_deadline = time.monotonic() + 10.0
            while time.monotonic() < drain_deadline:
                if max_events and st.events >= max_events:
                    break
                item = pipe.get(timeout_s=0.1)
                if item is ingest.EOF:
                    break
                if item is not None:
                    self._fold_item(item)
            self._finish_run()
        finally:
            pipe.close()
        st.finished_ms = now_ms()
        self._collect_faults()
        return st

    def _run_catchup_pipelined(self, max_events: int | None) -> RunStats:
        """Catchup over the staged pipeline: chunk-sized reads + encode
        run ahead on their threads; this loop pays only device dispatch
        and flush."""
        st = self.stats
        st.started_ms = now_ms()
        last_flush = time.monotonic()
        pipe = self._make_pipeline(catchup=True)
        try:
            while not self._stop:
                item = pipe.get(timeout_s=0.05)
                if item is ingest.EOF:
                    break
                if item is not None:
                    self._fold_item(item)
                    if max_events and st.events >= max_events:
                        break
                last_flush = self._flush_cycle(time.monotonic(),
                                               last_flush)
            self._finish_run()
        finally:
            pipe.close()
        st.finished_ms = now_ms()
        self._collect_faults()
        return st

    # ------------------------------------------------------------------
    def run(self, duration_s: float | None = None,
            idle_timeout_s: float | None = None,
            max_events: int | None = None) -> RunStats:
        """Consume until stopped / duration / idle-timeout / max_events.
        A loop that dies leaves its flight-recorder black box (when one
        is attached) before the exception propagates."""
        try:
            return self._run(duration_s, idle_timeout_s, max_events)
        except BaseException as e:
            self._flight_crash(e)
            raise

    def _run(self, duration_s: float | None,
             idle_timeout_s: float | None,
             max_events: int | None) -> RunStats:
        if self._pipeline_on():
            return self._run_pipelined(duration_s, idle_timeout_s,
                                       max_events)
        st = self.stats
        st.started_ms = now_ms()
        deadline = (time.monotonic() + duration_s) if duration_s else None
        last_flush = time.monotonic()
        last_data = time.monotonic()
        block_mode = self._block_mode()
        est_bytes = self.EST_EVENT_BYTES
        pending: list[bytes] = []      # lines, or raw blocks in block mode
        pending_n = 0                  # records pending
        pending_since: float | None = None
        # Adaptive batching under backlog: while the reader keeps handing
        # back full reads, grow the dispatch target toward one scan-chunk;
        # any short read snaps it back to one batch.
        chunk_cap = self.batch_size * self.engine.scan_batches
        target = self.batch_size

        def dispatch() -> None:
            nonlocal pending, pending_n, pending_since, last_data
            before = self.engine.events_processed
            if block_mode:
                self.engine.process_block(b"".join(pending))
            else:
                self.engine.process_chunk(pending)
            st.events += self.engine.events_processed - before
            st.batches += 1
            pending = []
            pending_n = 0
            pending_since = None
            last_data = time.monotonic()  # processing isn't idleness
            self._chaos_point("batch")

        while not self._stop:
            now = time.monotonic()
            if deadline and now >= deadline:
                break
            if max_events and st.events >= max_events:
                break

            room = target - pending_n
            full_read = False
            spans = self.spans
            t0_ns = time.perf_counter_ns() if spans is not None else 0
            if room <= 0:
                got = 0
            elif block_mode:
                budget = room * est_bytes
                data = self.reader.poll_block(budget)
                got = data.count(b"\n") if data else 0
                # judge backlog by BYTES: a non-empty read that nearly
                # filled its budget means more data is waiting
                full_read = got > 0 and len(data) >= budget - est_bytes
                if got:
                    pending.append(data)
            else:
                lines = self.reader.poll(max_records=room)
                got = len(lines)
                full_read = got >= room
                if got:
                    pending.extend(lines)
            if spans is not None and got:
                self._read_span(t0_ns, got)
            if got:
                last_data = now
                if pending_since is None:
                    pending_since = now
                pending_n += got
                if full_read:                # backlog: scale the batch up
                    target = min(target * 2, chunk_cap)
                elif pending_n < self.batch_size:
                    target = self.batch_size
            else:
                if pending_n < self.batch_size:
                    target = self.batch_size
                if (idle_timeout_s and not pending
                        and now - last_data >= idle_timeout_s):
                    break

            batch_old = (pending_since is not None and
                         (now - pending_since) * 1000 >= self.buffer_timeout_ms)
            if pending_n >= target or (pending and batch_old):
                dispatch()
            elif not full_read:
                # nothing due and no backlog: yield instead of busy-spinning
                time.sleep(0.001)

            if (now - last_flush) * 1000 >= self.flush_interval_ms:
                if self._checkpoint_due(now) and pending:
                    # the reader offset already covers polled but
                    # unprocessed lines: fold them first so a snapshot at
                    # that offset cannot skip them on resume
                    dispatch()
                self._flush(now)
                last_flush = now

        if self._drain_on_stop:
            # stopped by the CLI's SIGTERM: fold the backlog first
            stop_by = time.monotonic() + self.STOP_DRAIN_S
            while time.monotonic() < stop_by:
                if block_mode:
                    data = self.reader.poll_block(chunk_cap * est_bytes)
                    got = data.count(b"\n") if data else 0
                    if got:
                        pending.append(data)
                else:
                    lines = self.reader.poll(max_records=chunk_cap)
                    got = len(lines)
                    pending.extend(lines)
                if not got:
                    break
                pending_n += got
                dispatch()
        if pending:
            dispatch()
        self._finish_run()
        st.finished_ms = now_ms()
        self._collect_faults()
        return st

    def run_catchup(self, max_events: int | None = None) -> RunStats:
        """Drain the journal as fast as possible (catchup/throughput mode):
        scan-chunked batches, no buffer timeout, flush only on ring-span
        guard + once per second of wall clock."""
        try:
            return self._run_catchup(max_events)
        except BaseException as e:
            self._flight_crash(e)
            raise

    def _run_catchup(self, max_events: int | None) -> RunStats:
        if self._pipeline_on():
            return self._run_catchup_pipelined(max_events)
        st = self.stats
        st.started_ms = now_ms()
        last_flush = time.monotonic()
        chunk = self.batch_size * self.engine.scan_batches
        block_mode = self._block_mode()
        block_bytes = chunk * self.EST_EVENT_BYTES
        spans = self.spans
        while not self._stop:
            before = self.engine.events_processed
            t0_ns = time.perf_counter_ns() if spans is not None else 0
            if block_mode:
                data = self.reader.poll_block(block_bytes)
                if not data:
                    break
                if spans is not None:
                    self._read_span(t0_ns, None)
                self.engine.process_block(data)
            else:
                lines = self.reader.poll(max_records=chunk)
                if not lines:
                    break
                if spans is not None:
                    self._read_span(t0_ns, len(lines))
                self.engine.process_chunk(lines)
            st.events += self.engine.events_processed - before
            st.batches += 1
            self._chaos_point("batch")
            if max_events and st.events >= max_events:
                break
            now = time.monotonic()
            if (now - last_flush) * 1000 >= self.flush_interval_ms:
                self._flush(now)
                last_flush = now
        self._finish_run()
        st.finished_ms = now_ms()
        self._collect_faults()
        return st
