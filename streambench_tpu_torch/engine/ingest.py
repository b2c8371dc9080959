"""Staged ingest pipeline: overlap journal read, encode, and device dispatch.

The port of ``streambench_tpu/engine/ingest.py``.  On the card the
catchup is bound by the host: the serial ``StreamRunner`` loop reads a
block, encodes it and folds it one after the other, so while the host
encodes nobody reads the journal and the card waits.  This module
overlaps the three:

- **stage 1, reader thread** — tails the journal into a bounded *block
  queue*: raw byte blocks when the engine supports block ingest, line
  lists otherwise.  In paced mode it owns the runner's batching policy
  (adaptive target under backlog, ``buffer_timeout_ms`` for partial
  groups); in catchup mode it reads chunk-sized blocks and emits
  :data:`EOF` at the first dry poll, exactly like the serial loop.
- **stage 2, encode thread** — carves/encodes each block into
  ``EncodedBatch`` groups (``engine.encode_raw_block`` /
  ``engine.encode_chunk_lines`` — the encode pool still parallelizes
  WITHIN a block) onto a bounded *batch queue*.  It is host-only: it
  touches neither torch nor the device.
- **stage 3, the host loop** — ``get()``s ready groups and does only
  device dispatch (``engine.fold_batches``) + flush.  Only this thread
  touches torch and CUDA.

Ordering is strict journal FIFO: one thread per stage, one consumer, so
folds happen in read order — the span guard and the dirty-row set
(noted at fold time) assume exactly that.  Backpressure comes from the
queue bounds (a slow device stalls encode, a slow encode stalls the
reader).

Checkpoint consistency: ``commit(item)`` (called by the host AFTER
folding) advances the *folded position* — the reader offset covering
exactly the blocks already folded.  ``quiesce()`` additionally parks
both stage threads at a work-item boundary (each stage does its real
work under a stage lock; queue waits happen outside it), so a snapshot
can serialize encoder state (base time) without racing the encode
thread.  In-flight prefetched blocks are simply replayable: their bytes
sit past the folded offset.
"""

from __future__ import annotations

import queue
import threading
import time

from streambench_tpu_torch.utils.ids import now_ms


class _Sentinel:
    def __init__(self, name: str) -> None:
        self._name = name

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return self._name


#: End-of-stream marker ``get()`` returns once: the reader hit a dry
#: poll in catchup mode, or ``finish()`` drained the paced stages.
EOF = _Sentinel("<ingest EOF>")


class IngestItem:
    """One journal read unit flowing through the stages.

    ``payload`` is the raw read (bytes in block mode, a line list
    otherwise) until the encode stage replaces it with ``batches``;
    ``end_pos`` is the reader position (scalar offset, or the offsets
    vector of a ``MultiReader``) immediately after the reads that formed
    this item — the value ``commit`` publishes as the folded position.
    ``read_ms`` is the wall stamp of the FIRST read that contributed
    (with read-ahead the gap between reading and encoding is real, so the
    stamp travels with the item).
    """

    __slots__ = ("payload", "records", "end_pos", "batches", "read_ms")

    def __init__(self, payload, records: int, end_pos,
                 read_ms: "int | None" = None) -> None:
        self.payload = payload
        self.records = records
        self.end_pos = end_pos
        self.batches: list = []
        self.read_ms = read_ms


class IngestPipeline:
    """Three overlapped ingest stages over one (engine, reader) pair.

    The host loop drives stage 3::

        pipe = IngestPipeline(engine, reader, ...)
        while ...:
            item = pipe.get(timeout_s=0.05)
            if item is ingest.EOF: break
            if item is None: continue          # stages still working
            engine.fold_batches(item.batches)
            pipe.commit(item)                  # folded position advances
        pipe.close()

    One pipeline drives one run attempt; build a fresh one per attempt.
    """

    def __init__(self, engine, reader, *,
                 batch_size: int,
                 chunk_records: int,
                 buffer_timeout_ms: int | None = None,
                 catchup: bool = False,
                 est_event_bytes: int = 256,
                 block_queue: int = 4,
                 batch_queue: int = 4,
                 poll_interval_s: float = 0.001,
                 flightrec=None, spans=None) -> None:
        self.engine = engine
        self.reader = reader
        # crash flight recorder (obs.flightrec or None): stage errors
        # and first-stall events land in the postmortem ring
        self.flightrec = flightrec
        # span tracer (obs.spans or None): non-empty reads and encode
        # stage work land as "ingest_read"/"ingest_encode" spans on
        # their own threads
        self.spans = spans
        self.batch_size = max(int(batch_size), 1)
        self.chunk_records = max(int(chunk_records), self.batch_size)
        self.buffer_timeout_ms = buffer_timeout_ms
        self.catchup = catchup
        self.est_event_bytes = max(int(est_event_bytes), 1)
        self.poll_interval_s = poll_interval_s
        self.block_mode = (getattr(engine, "supports_block_ingest", False)
                           and hasattr(reader, "poll_block"))
        self._block_q: queue.Queue = queue.Queue(maxsize=max(block_queue, 1))
        self._batch_q: queue.Queue = queue.Queue(maxsize=max(batch_queue, 1))
        self._stop = threading.Event()
        self._finish = threading.Event()
        # Stage locks: held only while a stage touches the reader or the
        # encoder (never across a queue wait), so quiesce() can park both
        # stages by acquiring them — bounded by one work item, and
        # deadlock-free because the host holds neither during get().
        self._reader_lock = threading.Lock()
        self._encode_lock = threading.Lock()
        self._error: BaseException | None = None
        # Stall/starvation accounting (telemetry): each counter has ONE
        # writer thread, so plain int += is safe under the GIL.
        self.reader_stalls = 0     # reader blocked on a full block queue
        self.encode_stalls = 0     # encode blocked on a full batch queue
        self.encode_starved = 0    # encode waited on an empty block queue
        self.dispatch_starved = 0  # host get() timed out (stages behind)
        self.records_read = 0
        self.records_folded = 0
        self.read_ms_total = 0.0
        self.encode_ms_total = 0.0
        self.last_data_ts = time.monotonic()
        self.closed = False
        self._folded_pos = self._position()
        self._reader_thread = threading.Thread(
            target=self._reader_main, daemon=True, name="ingest-reader")
        self._encode_thread = threading.Thread(
            target=self._encode_main, daemon=True, name="ingest-encode")
        self._reader_thread.start()
        self._encode_thread.start()

    # ------------------------------------------------------------------
    def _position(self):
        """Reader position: scalar byte offset, or a COPY of the
        per-partition offsets vector (``MultiReader``)."""
        try:
            return self.reader.offset
        except AttributeError:
            return list(self.reader.offsets)

    def _fail(self, err: BaseException) -> None:
        """Record a stage failure for the host to re-raise from get()."""
        if self._error is None:
            self._error = err
        if self.flightrec is not None:
            self.flightrec.record("ingest_error", error=repr(err),
                                  block_queue=self._block_q.qsize(),
                                  batch_queue=self._batch_q.qsize())
        self._stop.set()

    def _put(self, q: queue.Queue, item, counter: str | None) -> bool:
        """Bounded put that stays interruptible (close()) and counts the
        first time each item had to wait on a full queue."""
        stalled = False
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                if not stalled and counter is not None:
                    stalled = True
                    setattr(self, counter, getattr(self, counter) + 1)
                    if self.flightrec is not None:
                        self.flightrec.record(
                            "ingest_stall", stage=counter,
                            block_queue=self._block_q.qsize(),
                            batch_queue=self._batch_q.qsize())
        return False

    # -- stage 1: reader ----------------------------------------------
    def _reader_main(self) -> None:
        try:
            if self.catchup:
                self._reader_catchup()
            else:
                self._reader_paced()
        except BaseException as e:  # delivered to the host via get()
            self._fail(e)

    def _read_once(self, room: int) -> tuple[object, int, bool]:
        """One bounded journal read under the reader lock.  Returns
        (payload, records, full_read) with the SAME backlog judgment as
        the serial loop: in block mode a NON-EMPTY read that nearly
        filled its byte budget means more data is waiting (an empty read
        must never count as full, or a tiny budget at room == 1 would
        busy-spin on an idle stream)."""
        t0_ns = time.perf_counter_ns()
        with self._reader_lock:
            if self.block_mode:
                budget = room * self.est_event_bytes
                data = self.reader.poll_block(budget)
                got = data.count(b"\n") if data else 0
                full = (got > 0
                        and len(data) >= budget - self.est_event_bytes)
            else:
                data = self.reader.poll(max_records=room)
                got = len(data)
                full = got >= room
        dur_ns = time.perf_counter_ns() - t0_ns
        self.read_ms_total += dur_ns / 1e6
        if self.spans is not None and got:
            # only non-empty reads: at the 1 ms poll cadence, empty
            # polls would flood the bounded ring with nothing
            self.spans.add("ingest_read", t0_ns, dur_ns, cat="ingest",
                           args={"records": got})
        return data, got, full

    def _reader_catchup(self) -> None:
        """Chunk-sized reads, EOF at the first dry poll (the serial
        ``run_catchup`` contract: a prewritten journal is drained)."""
        while not self._stop.is_set():
            data, got, _full = self._read_once(self.chunk_records)
            if not got:
                self._put(self._block_q, EOF, None)
                return
            pos = self._position()
            self.records_read += got
            self.last_data_ts = time.monotonic()
            if not self._put(self._block_q,
                             IngestItem(data, got, pos, read_ms=now_ms()),
                             "reader_stalls"):
                return

    def _reader_paced(self) -> None:
        """The streaming loop's batching policy, moved into the reader:
        adaptive target growth under backlog (full reads double toward
        one scan chunk, short reads snap back to one batch) and the
        ``buffer_timeout_ms`` partial-group dispatch."""
        pending: list = []
        pending_n = 0
        pending_since: float | None = None
        pending_read_ms: int | None = None   # first-read wall stamp
        pending_end = self._folded_pos
        target = self.batch_size
        while not self._stop.is_set():
            finishing = self._finish.is_set()
            got = 0
            if not finishing:
                room = max(target - pending_n, 1)
                data, got, full = self._read_once(room)
                now = time.monotonic()
                if got:
                    pending_end = self._position()
                    self.records_read += got
                    self.last_data_ts = now
                    if pending_since is None:
                        pending_since = now
                        pending_read_ms = now_ms()
                    pending_n += got
                    if self.block_mode:
                        pending.append(data)
                    else:
                        pending.extend(data)
                    if full:            # backlog: scale the batch up
                        target = min(target * 2, self.chunk_records)
                    elif pending_n < self.batch_size:
                        target = self.batch_size
                elif pending_n < self.batch_size:
                    target = self.batch_size
            else:
                now = time.monotonic()
            timeout_old = (pending_since is not None
                           and self.buffer_timeout_ms is not None
                           and (now - pending_since) * 1000
                           >= self.buffer_timeout_ms)
            if pending and (pending_n >= target or timeout_old
                            or finishing):
                payload = (b"".join(pending) if self.block_mode
                           else pending)
                item = IngestItem(payload, pending_n, pending_end,
                                  read_ms=pending_read_ms)
                pending, pending_n, pending_since = [], 0, None
                pending_read_ms = None
                if not self._put(self._block_q, item, "reader_stalls"):
                    return
            elif finishing:
                self._put(self._block_q, EOF, None)
                return
            elif not got:
                time.sleep(self.poll_interval_s)

    # -- stage 2: encode ----------------------------------------------
    def _encode_main(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    item = self._block_q.get(timeout=0.05)
                except queue.Empty:
                    self.encode_starved += 1
                    continue
                if item is EOF:
                    self._put(self._batch_q, EOF, None)
                    return
                t0_ns = time.perf_counter_ns()
                with self._encode_lock:
                    if self.block_mode:
                        item.batches = self.engine.encode_raw_block(
                            item.payload)
                    else:
                        item.batches = self.engine.encode_chunk_lines(
                            item.payload)
                item.payload = None   # free the raw bytes early
                dur_ns = time.perf_counter_ns() - t0_ns
                self.encode_ms_total += dur_ns / 1e6
                if self.spans is not None:
                    self.spans.add("ingest_encode", t0_ns, dur_ns,
                                   cat="ingest",
                                   args={"records": item.records})
                if item.read_ms is not None and item.batches:
                    # attribution stamps (obs.lifecycle): the engine's
                    # encode halves default the read stamp to encode
                    # time; with read-ahead the TRUE read time is the
                    # item's — override so ingest_ms/encode_ms split at
                    # the real boundary
                    lc = self.engine._obs_lifecycle
                    if lc is not None:
                        for b in item.batches:
                            b._lc_read_ms = item.read_ms
                if not self._put(self._batch_q, item, "encode_stalls"):
                    return
        except BaseException as e:
            self._fail(e)

    # -- stage 3 surface (host loop) -----------------------------------
    def get(self, timeout_s: float = 0.05):
        """Next encoded :class:`IngestItem` in journal order, ``EOF`` at
        end-of-stream, or ``None`` when nothing is ready yet.  Re-raises
        a stage thread's failure here, on the host thread, preserving
        the original exception type (a caller must see the same errors
        the serial loop would have raised)."""
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        try:
            return self._batch_q.get(timeout=timeout_s)
        except queue.Empty:
            self.dispatch_starved += 1
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            return None

    def commit(self, item: IngestItem) -> None:
        """Publish ``item`` as folded: its end position becomes the
        checkpointable offset.  Call strictly AFTER ``fold_batches`` —
        committing first would let a crash-between skip the block."""
        self._folded_pos = item.end_pos
        self.records_folded += item.records

    def position(self):
        """Reader position covering exactly the folded blocks (scalar or
        per-partition vector) — the checkpoint/crash-offset unit."""
        return self._folded_pos

    def quiesce(self):
        """Park both stage threads at a work-item boundary and return the
        folded position.  While quiesced, nothing touches the reader or
        the encoder, so a snapshot can serialize encoder state safely;
        in-flight items keep sitting in the queues (their bytes are past
        the returned offset — replayable, never skippable).  Pair with
        :meth:`resume`."""
        self._reader_lock.acquire()
        self._encode_lock.acquire()
        return self._folded_pos

    def resume(self) -> None:
        self._encode_lock.release()
        self._reader_lock.release()

    def finish(self) -> None:
        """Ask the paced reader to emit its partial pending block and
        EOF (the serial loop's trailing ``if pending: dispatch()``)."""
        self._finish.set()

    def drained(self) -> bool:
        """True when every record the reader has seen was folded."""
        return self.records_folded >= self.records_read

    def idle_for(self) -> float:
        """Seconds since the reader last returned data (idle-timeout
        input; folds of already-read data don't reset it, but they keep
        ``drained()`` False, which the idle check also requires)."""
        return time.monotonic() - self.last_data_ts

    def close(self) -> None:
        """Stop both stages and join them.  Uncommitted in-flight items
        are discarded — their bytes are past the folded position, so a
        resume replays them (never loses them)."""
        self._stop.set()
        for t in (self._reader_thread, self._encode_thread):
            if t.is_alive():
                t.join(timeout=5)
        self.closed = True

    # ------------------------------------------------------------------
    def telemetry(self) -> dict:
        """Point-in-time stage health: queue depths, stall/starvation
        counters, per-stage busy time."""
        return {
            "block_queue_depth": self._block_q.qsize(),
            "batch_queue_depth": self._batch_q.qsize(),
            "reader_stalls": self.reader_stalls,
            "encode_stalls": self.encode_stalls,
            "encode_starved": self.encode_starved,
            "dispatch_starved": self.dispatch_starved,
            "records_read": self.records_read,
            "records_folded": self.records_folded,
            "read_ms_total": round(self.read_ms_total, 3),
            "encode_ms_total": round(self.encode_ms_total, 3),
        }
