"""Fault-injecting wrappers for the sink, journal, crash and broker surfaces.

The port's copy of ``streambench_tpu/chaos/inject.py``.  One
:class:`FaultInjector` owns a :class:`~streambench_tpu_torch.chaos.plan.
FaultPlan` plus the *global* operation counters, and hands out wrappers:

- :meth:`FaultInjector.wrap_redis` -- a sink proxy injecting connection
  refusals, timeouts and transient RESP errors into the window writeback
  (raised *before* forwarding: a faulted op applies nothing);
- :meth:`FaultInjector.wrap_reader` -- a journal-reader wrapper injecting
  torn tails, truncated reads and corrupt records, in line mode
  (``poll``) and block mode (``poll_block``, which feeds the serial
  loop, the ingest pipeline and device decode), all transient: the
  damaged bytes are rewound and re-delivered intact on the next poll;
- :attr:`FaultInjector.scheduler` -- the crash scheduler a
  ``StreamRunner`` takes as ``crash_points``;
- :meth:`FaultInjector.net_fault` -- the per-message draw the
  :class:`~streambench_tpu_torch.chaos.netchaos.ChaosPubSub` proxy
  consumes (partition windows outrank the rolled kind);
- :meth:`FaultInjector.attach_ship_chaos` -- installs a
  ``ship_fault_hook`` on a ``DurableDimensionStore`` so
  ``put_reach_sketches`` appends are damaged per the plan's ship
  schedule (torn / corrupt / delayed), proving the replica tailer's
  skip-and-resync;
- :meth:`FaultInjector.kafka_fault` -- the per-op draw the fake Kafka
  cluster (``io.fakekafka.FakeCluster.attach_chaos``) consumes.

Operation indices are owned by the injector, NOT the wrappers, so a
supervised restart (which re-wraps fresh engine and reader objects)
continues the plan where the crashed attempt left it instead of replaying
the same faults forever.
"""

from __future__ import annotations

import threading

from streambench_tpu_torch.chaos.plan import CrashScheduler, FaultPlan
from streambench_tpu_torch.io.resp import RespError
from streambench_tpu_torch.metrics import FaultCounters

# The NUL zero-page a crashed writer's torn append leaves behind
# (filesystems zero-fill the unwritten tail of a dirtied page).
TORN_PAGE = b"\x00" * 64


class ChaosRedis:
    """RedisLike proxy that injects scheduled sink faults.

    Faults are atomic -- raised before the command is forwarded -- so a
    faulted write applies nothing.  One fault decision per ``execute`` /
    ``pipeline_execute`` call: the writeback submits whole flush batches,
    so per-call granularity is per-batch granularity.

    The one exception is the ``partial`` fault (exactly-once sweeps
    only): a timeout that forwards a PREFIX of the pipeline before
    raising, which only the epoch/seq fence survives.  On a single
    ``execute`` it applies the command fully and then raises (the
    response-loss flavour).

    Underscore attributes are deliberately NOT forwarded: the engine
    probes ``redis._store`` to pick its in-C bulk writeback, which would
    bypass this proxy entirely -- hiding it forces every flush through
    the faultable path.
    """

    def __init__(self, target, injector: "FaultInjector"):
        self._target = target
        self._injector = injector

    def _maybe_fault(self) -> str | None:
        """Raise the scheduled atomic fault, or return "partial" for the
        caller to enact (it needs the command list)."""
        kind = self._injector.sink_fault()
        if kind == "refused":
            raise ConnectionRefusedError("chaos: connection refused")
        if kind == "timeout":
            raise TimeoutError("chaos: sink operation timed out")
        if kind == "resp":
            raise RespError(
                "LOADING chaos: Redis is loading the dataset in memory")
        return kind

    def execute(self, *args):
        kind = self._maybe_fault()
        if kind == "partial":
            # single command: fully applied, response lost
            self._target.execute(*args)
            raise TimeoutError("chaos: sink timed out after apply")
        return self._target.execute(*args)

    def pipeline_execute(self, commands):
        kind = self._maybe_fault()
        if kind == "partial":
            cmds = list(commands)
            k = max(len(cmds) // 2, 1)
            self._target.pipeline_execute(cmds[:k])
            raise TimeoutError(
                f"chaos: sink timed out after partial pipeline apply "
                f"({k}/{len(cmds)} commands landed)")
        return self._target.pipeline_execute(commands)

    def reconnect(self) -> None:
        """Connection management, never faulted (a refused reconnect is
        modelled as the NEXT op faulting, which the plan already covers)."""
        reconnect = getattr(self._target, "reconnect", None)
        if reconnect is not None:
            reconnect()

    def close(self) -> None:
        self._target.close()

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._target, name)


class ChaosJournalReader:
    """JournalReader wrapper injecting transient read damage.

    Wraps a single-partition ``JournalReader`` (``MultiReader`` is
    refused: the rewind needs one byte offset).  Fault kinds:

    - ``truncated`` -- a short read: only a prefix (cut at a record
      boundary) is delivered, the rest rewound;
    - ``torn``      -- a prefix plus a NUL zero-page pseudo-record
      (``TORN_PAGE``), the real records rewound;
    - ``corrupt``   -- the record after the cut is delivered as a
      NUL-damaged copy and rewound for intact re-delivery.

    ``offset`` never covers damaged bytes, so checkpoints taken through
    this wrapper resume correctly.  Damaged pseudo-records always contain
    NULs and never parse as events: the host encoder rejects them, and
    device decode's layout probe rejects them before any row reaches the
    decode kernel (they go to the host encoder, which counts them), so
    injection shows up as ``bad_lines``, never as count drift.
    """

    def __init__(self, delegate, injector: "FaultInjector"):
        self._delegate = delegate
        self._injector = injector
        self.fault_counters = injector.counters

    # -- checkpoint surface (forwarded byte-exactly) -------------------
    @property
    def offset(self) -> int:
        return self._delegate.offset

    def seek(self, offset: int) -> None:
        self._delegate.seek(offset)

    def close(self) -> None:
        self._delegate.close()

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._delegate, name)

    # -- faulted reads -------------------------------------------------
    def poll(self, max_records: int = 65536) -> list[bytes]:
        before = self._delegate.offset
        lines = self._delegate.poll(max_records)
        if not lines:
            return lines
        kind = self._injector.journal_fault()
        if kind is None:
            return lines
        cut = len(lines) // 2
        keep = lines[:cut]
        self._delegate.seek(before + sum(len(l) + 1 for l in keep))
        if kind == "truncated":
            return keep
        if kind == "torn":
            return keep + [TORN_PAGE]
        victim = lines[cut]
        half = max(len(victim) // 2, 1)
        return keep + [victim[:half] + b"\x00" * (len(victim) - half)]

    def poll_block(self, max_bytes: int | None = None) -> bytes:
        before = self._delegate.offset
        data = self._delegate.poll_block(max_bytes)
        if not data:
            return data
        kind = self._injector.journal_fault()
        if kind is None:
            return data
        # cut at the record boundary nearest the middle of the block
        pos = data.rfind(b"\n", 0, max(len(data) // 2, 1)) + 1
        self._delegate.seek(before + pos)
        keep = data[:pos]
        if kind == "truncated":
            return keep
        if kind == "torn":
            return keep + TORN_PAGE + b"\n"
        end = data.find(b"\n", pos)
        victim = data[pos:end if end >= 0 else len(data)]
        half = max(len(victim) // 2, 1)
        return (keep + victim[:half]
                + b"\x00" * (len(victim) - half) + b"\n")


class ShipChaosFilter:
    """The ship-log append filter ``attach_ship_chaos`` installs.

    Called by ``DurableDimensionStore.put_reach_sketches`` with the
    serialized record line (newline included); returns ``(data,
    intact)`` where ``data`` is what actually hits the file and
    ``intact`` says whether the store may absorb the record into its
    in-memory index (a damaged append must not leave the writer's OWN
    view ahead of what it durably wrote).

    - ``torn``    — a prefix with NO newline: the next append
      concatenates into one undecodable garbage line (the tailer's
      ``_carry`` holds the stub until that newline lands, then the
      combined line fails to parse and is skipped);
    - ``corrupt`` — the line's tail is NUL-smashed, newline intact:
      one self-contained garbage line;
    - ``delayed`` — the record is held and prepended to the NEXT
      append: late and out of order, which the tailer's
      newest-decodable rule must absorb.
    """

    def __init__(self, injector: "FaultInjector"):
        self._injector = injector
        self._held = ""

    def __call__(self, data: str) -> tuple[str, bool]:
        kind = self._injector.ship_fault()
        held, self._held = self._held, ""
        if kind is None:
            return held + data, True
        if kind == "torn":
            return held + data[: max(len(data) // 2, 1)], False
        if kind == "corrupt":
            half = max(len(data) // 2, 1)
            return (held + data[:half]
                    + "\x00" * (len(data) - half - 1) + "\n"), False
        # delayed: hold the record for the next append (nothing written
        # now beyond any previously-held record)
        self._held = data
        return held, False


class FaultInjector:
    """The plan's executor: wraps surfaces, owns global fault indices.

    One injector per chaos run.  Wrap fresh engine and reader objects at
    every supervised restart; the injector's counters make the plan
    progress monotonically across attempts.
    """

    def __init__(self, plan: FaultPlan,
                 counters: FaultCounters | None = None):
        self.plan = plan
        self.counters = counters if counters is not None else FaultCounters()
        self.scheduler = CrashScheduler(plan.crashes, self.counters)
        self._lock = threading.Lock()
        self._sink_idx = 0
        self._journal_idx = 0
        self._net_idx = 0
        self._ship_idx = 0
        self._kafka_idx = 0

    def sink_fault(self) -> str | None:
        with self._lock:
            i = self._sink_idx
            self._sink_idx += 1
        kind = self.plan.sink_faults.get(i)
        if kind is not None:
            self.counters.inc("chaos_sink_faults")
        return kind

    def journal_fault(self) -> str | None:
        with self._lock:
            i = self._journal_idx
            self._journal_idx += 1
        kind = self.plan.journal_faults.get(i)
        if kind is not None:
            self.counters.inc("journal_faults")
        return kind

    # -- fleet surfaces ------------------------------------------------
    def net_fault(self) -> str | None:
        """One per-message draw for the ChaosPubSub proxy.  Partition
        windows outrank the rolled kind: a message inside one is
        dropped no matter what the rate draw said (a partition is not
        a probability)."""
        with self._lock:
            i = self._net_idx
            self._net_idx += 1
        for start, length in self.plan.partition_windows:
            if start <= i < start + length:
                self.counters.inc("net_faults")
                self.counters.inc("net_partition_drops")
                return "drop"
        kind = self.plan.net_faults.get(i)
        if kind is not None:
            self.counters.inc("net_faults")
            self.counters.inc(f"net_{kind}")
        return kind

    def ship_fault(self) -> str | None:
        with self._lock:
            i = self._ship_idx
            self._ship_idx += 1
        kind = self.plan.ship_faults.get(i)
        if kind is not None:
            self.counters.inc("ship_faults")
        return kind

    # -- broker surface ------------------------------------------------
    def kafka_fault(self) -> str | None:
        """One per-broker-op draw for the fake Kafka cluster.  Down
        windows outrank the rolled kind (an outage is not a
        probability)."""
        with self._lock:
            i = self._kafka_idx
            self._kafka_idx += 1
        for start, end in self.plan.kafka_down:
            if start <= i < end:
                self.counters.inc("chaos_kafka_faults")
                self.counters.inc("chaos_kafka_down")
                return "down"
        kind = self.plan.kafka_faults.get(i)
        if kind is not None:
            self.counters.inc("chaos_kafka_faults")
            self.counters.inc(f"chaos_kafka_{kind}")
        return kind

    @property
    def net_delay_s(self) -> float:
        return max(self.plan.net_delay_ms, 0) / 1000.0

    def wrap_redis(self, target) -> ChaosRedis:
        return ChaosRedis(target, self)

    def wrap_reader(self, delegate) -> ChaosJournalReader:
        if not hasattr(delegate, "offset") or not hasattr(delegate, "seek"):
            raise TypeError(
                "ChaosJournalReader wraps a single-partition "
                "JournalReader (MultiReader has no scalar offset)")
        return ChaosJournalReader(delegate, self)

    def attach_ship_chaos(self, store) -> ShipChaosFilter:
        """Install the ship-log append filter on ``store`` (a
        ``DurableDimensionStore``); returns the filter for tests."""
        filt = ShipChaosFilter(self)
        store.ship_fault_hook = filt
        return filt
