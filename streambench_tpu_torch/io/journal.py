"""File-journal event broker: the hermetic Kafka stand-in.

The reference fork already abandoned live Kafka for its controlled
experiments and read events from a file (``FileBasedDataSource``,
``AdvertisingTopologyNative.java:144-165``, fed by ``events_path``); the
pristine generator likewise journals every event it sends to Kafka into
``kafka-json.txt`` (``core.clj:75,96-97``) so the oracle can replay it.  This
module makes that pattern first-class: a *topic* is an append-only
newline-delimited file in a broker directory, writers append, readers tail
from a byte offset.  Offsets are byte positions, so checkpoint/resume
semantics match Kafka's ``(topic, offset)`` pairs
(``setStartFromEarliest``, ``AdvertisingTopologyNative.java:92``).

The JAX package's ``streambench_tpu.io.kafka`` implements this same
contract against confluent-kafka; the port's CLI opens this file broker
directly.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Iterator


class JournalWriter:
    """Append-only writer for one topic file.  Thread-safe."""

    def __init__(self, path: str, sync_every: int = 0, append: bool = True):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "ab" if append else "wb", buffering=1024 * 1024)
        self._lock = threading.Lock()
        self._sync_every = sync_every
        self._since_sync = 0

    def append(self, line: "str | bytes | memoryview") -> None:
        data = line.encode("utf-8") if isinstance(line, str) else line
        with self._lock:
            self._f.write(data)
            if bytes(data[-1:]) != b"\n":
                self._f.write(b"\n")
            self._since_sync += 1
            if self._sync_every and self._since_sync >= self._sync_every:
                self._f.flush()
                self._since_sync = 0

    def append_many(self, lines: list[str] | list[bytes]) -> None:
        if not lines:
            return
        chunks = []
        for line in lines:
            data = line.encode("utf-8") if isinstance(line, str) else line
            chunks.append(data if data.endswith(b"\n") else data + b"\n")
        with self._lock:
            self._f.write(b"".join(chunks))
            self._since_sync += len(chunks)
            if self._sync_every and self._since_sync >= self._sync_every:
                self._f.flush()
                self._since_sync = 0

    def append_bytes(self, data: "bytes | memoryview") -> None:
        """Append a pre-rendered block of newline-terminated records in one
        write — the zero-copy sink for the native event formatter (the
        producer-side peer of the engine's block-mode ingest; memoryviews
        are written without materializing bytes).  A distinct method so
        sinks without block support fail the caller's ``hasattr``
        capability probe."""
        if data:
            self.append(data)

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.flush()
            self._f.close()

    def __enter__(self) -> "JournalWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class JournalReader:
    """Tailing reader over a topic file, starting at a byte ``offset``.

    ``poll`` returns up to ``max_records`` complete lines (partial trailing
    lines are left in the file until the writer finishes them) together with
    the next offset — the unit a checkpoint persists.
    """

    def __init__(self, path: str, offset: int = 0,
                 byte_budget: int = 4 * 1024 * 1024,
                 skip_corrupt: bool = False):
        self.path = path
        self.offset = offset          # consumed offset (the checkpoint unit)
        self._byte_budget = byte_budget
        self._fh = None
        self._readahead: deque[bytes] = deque()  # parsed but not delivered
        # Torn-tail recovery: a writer that crashed mid-append can leave a
        # NUL-padded partial page in the file (filesystems zero-fill the
        # torn region); once a restarted writer appends past it, the NULs
        # sit inside a "record" no parser can use.  ``skip_corrupt``
        # consumes such records (offset still advances — checkpoints stay
        # byte-exact) without delivering them, counting each in
        # ``corrupt_records``.  Off by default: silently eating records
        # is a policy the operator must opt into.
        self.skip_corrupt = skip_corrupt
        self.corrupt_records = 0

    def backlog_bytes(self) -> int:
        """Bytes appended to the topic but not yet delivered (telemetry:
        the consumer-lag gauge).  A stat + subtraction — safe to call
        from the sampler thread at any cadence."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return 0
        return max(size - self.offset, 0)

    def seek(self, offset: int) -> None:
        """Reposition to an absolute byte offset (checkpoint restore).

        Assigning ``offset`` directly is not enough once the reader has
        polled: the open file handle and the read-ahead buffer both hold
        the old position and would silently keep delivering from it.
        """
        self.offset = offset
        self._readahead.clear()
        if self._fh is not None:
            self._fh.seek(offset)

    def _ensure_open(self) -> bool:
        if self._fh is None:
            if not os.path.exists(self.path):
                return False
            self._fh = open(self.path, "rb")
            self._fh.seek(self.offset)
        return True

    def poll(self, max_records: int = 65536) -> list[bytes]:
        """Read up to ``max_records`` complete lines from the journal.

        Reads bounded chunks and keeps surplus parsed lines in a read-ahead
        buffer, so each journal byte is read and split exactly once no
        matter the poll granularity; ``offset`` only advances over
        *delivered* lines, preserving checkpoint/resume exactness.

        In ``skip_corrupt`` mode, records with embedded NUL bytes (a
        crashed writer's torn page) are consumed-but-not-delivered and
        counted; the poll may then return fewer lines than available,
        which every caller already tolerates.
        """
        out = self._poll_lines(max_records)
        if self.skip_corrupt and out:
            kept = [l for l in out if b"\x00" not in l]
            if len(kept) != len(out):
                self.corrupt_records += len(out) - len(kept)
                return kept
        return out

    def _poll_lines(self, max_records: int) -> list[bytes]:
        out: list[bytes] = []
        ra = self._readahead
        while ra and len(out) < max_records:
            line = ra.popleft()
            self.offset += len(line) + 1
            out.append(line)
        if len(out) >= max_records or not self._ensure_open():
            return out

        # Loop budget-sized reads until the request is satisfied or the
        # journal runs dry — a single bounded read would silently cap
        # every poll at ~budget/linesize records and leave scan chunks
        # (max_records = K*B) chronically underfilled.
        while len(out) < max_records:
            budget = self._byte_budget
            while True:
                data = self._fh.read(budget)
                if not data:
                    return out
                end = data.rfind(b"\n")
                if end >= 0:
                    break
                if len(data) < budget:
                    # partial trailing line, writer not done yet; rewind
                    self._fh.seek(self._fh.tell() - len(data))
                    return out
                budget *= 2  # one line longer than the budget: retry bigger
                self._fh.seek(self._fh.tell() - len(data))
            # return unread tail (an incomplete line) to the file position
            tail = len(data) - (end + 1)
            if tail:
                self._fh.seek(self._fh.tell() - tail)
            # split on \n only: splitlines() would also split on \r/\v/\f
            # etc. inside a record and corrupt the byte-offset accounting.
            lines = data[:end].split(b"\n")
            take = max_records - len(out)
            for line in lines[:take]:
                self.offset += len(line) + 1
            out.extend(lines[:take])
            ra.extend(lines[take:])
        return out

    def poll_blocking(self, max_records: int = 65536,
                      timeout_s: float = 1.0,
                      poll_interval_s: float = 0.001) -> list[bytes]:
        deadline = time.monotonic() + timeout_s
        while True:
            lines = self.poll(max_records)
            if lines or time.monotonic() >= deadline:
                return lines
            time.sleep(poll_interval_s)

    def poll_block(self, max_bytes: int | None = None) -> bytes:
        """Raw complete-line bytes for block-mode ingest (the native
        encoder scans record boundaries itself; no per-line objects).

        Returns up to ``max_bytes`` ending on a line boundary; ``offset``
        advances over exactly the returned bytes, so checkpoints stay
        record-exact.  Cannot be mixed with line-mode ``poll`` while its
        read-ahead holds parsed-but-undelivered lines.
        """
        if self._readahead:
            raise RuntimeError(
                "poll_block after line-mode poll left read-ahead lines; "
                "one reader must stick to one ingest mode")
        if not self._ensure_open():
            return b""
        budget = max_bytes or self._byte_budget
        while True:
            data = self._fh.read(budget)
            if not data:
                return b""
            end = data.rfind(b"\n")
            if end >= 0:
                break
            if len(data) < budget:
                # partial trailing line, writer not done yet; rewind
                self._fh.seek(self._fh.tell() - len(data))
                return b""
            budget *= 2  # one line longer than the budget: retry bigger
            self._fh.seek(self._fh.tell() - len(data))
        tail = len(data) - (end + 1)
        if tail:
            self._fh.seek(self._fh.tell() - tail)
            data = data[:end + 1]
        self.offset += len(data)
        if self.skip_corrupt and b"\x00" in data:
            # NUL records never reach the block parser: drop the torn
            # lines from the returned block (offset already covers the
            # full read, so checkpoints stay byte-exact).
            lines = data.split(b"\n")
            if lines and not lines[-1]:
                lines.pop()
            kept = [l for l in lines if b"\x00" not in l]
            self.corrupt_records += len(lines) - len(kept)
            data = b"".join(l + b"\n" for l in kept)
        return data

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JournalReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MultiReader:
    """Round-robin reader over all partitions of a topic.

    The streaming engine is one consumer of the WHOLE topic (the
    reference's engines likewise subscribe to every partition of
    ``ad-events``); partitioned topics exist so count-windowed map
    partitions can each own one (``map.partitions``).  ``poll`` drains
    partitions round-robin for rough arrival-order fairness.

    Checkpointing: a multi-partition position is a vector, not a byte
    offset — ``offsets``/``seek_offsets`` expose it; the scalar
    ``offset`` property exists only to fail loudly if something treats
    this reader as single-partition.
    """

    def __init__(self, readers: list[JournalReader]):
        if not readers:
            raise ValueError("MultiReader needs at least one reader")
        self._readers = readers
        self._next = 0

    @property
    def offsets(self) -> list[int]:
        return [r.offset for r in self._readers]

    def backlog_bytes(self) -> int:
        """Total undelivered bytes across all partitions (telemetry)."""
        return sum(r.backlog_bytes() for r in self._readers)

    def seek_offsets(self, offsets: list[int]) -> None:
        if len(offsets) != len(self._readers):
            raise ValueError(
                f"{len(offsets)} offsets for {len(self._readers)} partitions")
        for r, off in zip(self._readers, offsets):
            r.seek(off)

    @property
    def offset(self):
        raise AttributeError(
            "MultiReader spans partitions; use .offsets (checkpointing a "
            "multi-partition run needs the per-partition vector)")

    def poll(self, max_records: int = 65536) -> list[bytes]:
        """Drain partitions in bounded round-robin slices.

        Each partition contributes at most ``max_records // n`` per
        sweep, so consumption stays time-balanced across partitions.
        Letting one partition satisfy a whole request (the old behavior)
        skews inter-partition progress by the full request's event-time
        span — enough to push the lagging partitions past allowed
        lateness and silently drop their events once the watermark has
        advanced (Kafka consumers likewise interleave partition fetches).
        """
        out: list[bytes] = []
        n = len(self._readers)
        slice_cap = max(max_records // n, 1)
        empty_streak = 0
        while len(out) < max_records and empty_streak < n:
            r = self._readers[self._next]
            self._next = (self._next + 1) % n
            got = r.poll(max_records=min(slice_cap, max_records - len(out)))
            if got:
                out.extend(got)
                empty_streak = 0
            else:
                empty_streak += 1
        return out

    def close(self) -> None:
        for r in self._readers:
            r.close()

    def __enter__(self) -> "MultiReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class FileBroker:
    """Directory of topic files; the process-local 'Kafka cluster'.

    ``create_topic``/``writer``/``reader`` mirror the harness's topic
    lifecycle (``create_kafka_topic``, ``stream-bench.sh:107-115``).
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def topic_path(self, topic: str, partition: int = 0) -> str:
        return os.path.join(self.root, f"{topic}-{partition}.jsonl")

    def create_topic(self, topic: str, partitions: int = 1) -> None:
        for p in range(partitions):
            path = self.topic_path(topic, p)
            if not os.path.exists(path):
                open(path, "ab").close()

    def partitions(self, topic: str) -> list[int]:
        pre = f"{topic}-"
        out = []
        for name in os.listdir(self.root):
            if name.startswith(pre) and name.endswith(".jsonl"):
                try:
                    out.append(int(name[len(pre):-6]))
                except ValueError:
                    continue
        return sorted(out)

    def writer(self, topic: str, partition: int = 0,
               append: bool = True) -> JournalWriter:
        return JournalWriter(self.topic_path(topic, partition), append=append)

    def reader(self, topic: str, partition: int = 0,
               offset: int = 0, skip_corrupt: bool = False) -> JournalReader:
        return JournalReader(self.topic_path(topic, partition), offset,
                             skip_corrupt=skip_corrupt)

    def multi_reader(self, topic: str) -> MultiReader:
        """One consumer over every existing partition of ``topic``."""
        parts = self.partitions(topic) or [0]
        return MultiReader([self.reader(topic, p) for p in parts])

    def read_all(self, topic: str) -> Iterator[bytes]:
        """Replay a whole topic (all partitions, offset 0) — oracle use."""
        for p in self.partitions(topic):
            with self.reader(topic, p) as r:
                while True:
                    lines = r.poll()
                    if not lines:
                        break
                    yield from lines
