"""Streaming host loop: journal tail -> engine -> 1 Hz Redis flush.

The port of ``streambench_tpu/engine/runner.py``: the serial loops only
(``run`` and ``run_catchup``), in block mode where the engine and reader
support it, with the checkpoint cadence and ``resume``.  The operating
policies are the reference engines':

- **buffer timeout** — a partial batch is dispatched once it is
  ``buffer_timeout_ms`` old (Flink's ``setBufferTimeout(100)``,
  ``AdvertisingTopologyNative.java:77-79``).
- **1 Hz flusher** — dirty windows are written to Redis every
  ``flush_interval_ms`` (``CampaignProcessorCommon.java:41-54``).
- **pipelining** — CUDA launches are asynchronous: while the card folds
  batch N, the host is already tailing and encoding batch N+1.
- **checkpoints** — with a ``Checkpointer``, a snapshot of the engine at
  the reader's offset is saved after a flush once
  ``checkpoint_interval_ms`` has passed (0 = after every flush), and once
  more at the end of a run; ``resume()`` restores the newest one.

Not ported yet: the staged ingest pipeline, chaos points and the flight
recorder.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from streambench_tpu_torch.checkpoint import Checkpointer
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
                 checkpoint_interval_ms: int | None = None):
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

    def stop(self) -> None:
        self._stop = True

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
        self.stats.faults = f

    def _reader_position(self) -> int | list[int]:
        """Single-partition byte offset, or the per-partition offsets
        vector of a ``MultiReader`` (whose scalar ``.offset`` raises)."""
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
        self.checkpointer.save(self.engine.snapshot(self._reader_position()))
        self._last_ckpt = now

    def _checkpoint_due(self, now: float) -> bool:
        return (self.checkpointer is not None and
                (now - self._last_ckpt) * 1000 >= self.checkpoint_interval_ms)

    def _flush(self, now: float) -> None:
        """The periodic flush, its stall tick and the checkpoint cadence."""
        st = self.stats
        st.windows_written += self.engine.flush()
        st.flushes += 1
        self.stall_detector.tick(int(time.monotonic() * 1000))
        if self._checkpoint_due(now):
            self._checkpoint_now(now)

    def _finish_run(self) -> None:
        """Final flush + checkpoint shared by both loops' exit paths."""
        st = self.stats
        st.windows_written += self.engine.flush(final=True)
        st.flushes += 1
        if self.checkpointer is not None:
            self._checkpoint_now(time.monotonic())

    def run(self, duration_s: float | None = None,
            idle_timeout_s: float | None = None,
            max_events: int | None = None) -> RunStats:
        """Consume until stopped / duration / idle-timeout / max_events."""
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

        while not self._stop:
            now = time.monotonic()
            if deadline and now >= deadline:
                break
            if max_events and st.events >= max_events:
                break

            room = target - pending_n
            full_read = False
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
        st = self.stats
        st.started_ms = now_ms()
        last_flush = time.monotonic()
        chunk = self.batch_size * self.engine.scan_batches
        block_mode = self._block_mode()
        block_bytes = chunk * self.EST_EVENT_BYTES
        while not self._stop:
            before = self.engine.events_processed
            if block_mode:
                data = self.reader.poll_block(block_bytes)
                if not data:
                    break
                self.engine.process_block(data)
            else:
                lines = self.reader.poll(max_records=chunk)
                if not lines:
                    break
                self.engine.process_chunk(lines)
            st.events += self.engine.events_processed - before
            st.batches += 1
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
