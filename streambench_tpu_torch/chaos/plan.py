"""Deterministic fault plans: the seeded script a chaos run executes.

The port's copy of ``streambench_tpu/chaos/plan.py``.  One seed and one
set of knobs give the same :class:`FaultPlan` in both packages, field by
field: ``generate`` keeps the reference's signature and its draw order
(sink, journal, crashes, then the fleet draws, then the broker draws, all
from one ``random.Random(seed)`` stream), so a plan that fails in one
engine replays bit-identically in the other.

Every injected fault is scheduled up front from that one seed:

- **sink** -- per store-operation index: ``refused`` (connection
  refused), ``timeout`` (socket timeout), ``resp`` (a transient RESP
  error such as ``LOADING``).  Raised *before* the command is forwarded,
  so a faulted operation applies nothing.  ``partial`` (the non-atomic
  timeout that lands a prefix of a pipeline) is drawn only where
  ``sink_partial_rate`` asks for it: only the exactly-once fence
  survives it.
- **journal** -- per reader-poll index: ``truncated`` (a short read),
  ``torn`` (a NUL zero-page tail), ``corrupt`` (a NUL-damaged copy of the
  next record).  All transient: the damaged bytes are re-delivered
  intact on the next poll, so injection never loses an event.
- **crash** -- ordered ``(boundary, count)`` points consumed one at a
  time by the :class:`CrashScheduler`; the boundaries are ``batch``,
  ``flush`` and ``checkpoint`` (the runner's crash points).
- **kafka** -- per broker-operation index (appends and fetches share one
  op counter): ``produce``, ``consume``, ``dr_fail``, ``conn_drop``, plus
  ``kafka_down`` windows that fail every op in an index range.  The fake
  broker (``io.fakekafka``) executes them.

The **net** and **ship** kinds (the pub/sub proxy and the reach ship log)
are drawn too, so plans stay field-equal to the reference's, but nothing
in the port reads them until the reach serving tier and its fleet are
ported.
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field

from streambench_tpu_torch.metrics import FaultCounters

SINK_KINDS = ("refused", "timeout", "resp")
# The non-atomic sink fault (a timeout that lands a PREFIX of the
# pipeline before raising).  Deliberately NOT in SINK_KINDS: the
# at-least-once bound assumes atomic sink failure (ROBUSTNESS.md), so
# plain sweeps never roll it — only exactly-once sweeps opt in via
# ``generate(..., sink_partial_rate=...)``.
SINK_PARTIAL = "partial"
JOURNAL_KINDS = ("truncated", "torn", "corrupt")
CRASH_KINDS = ("batch", "flush", "checkpoint")
# Fleet surfaces: pub/sub transport + ship-log append.
NET_KINDS = ("drop", "delay", "dup", "torn")
SHIP_FAULT_KINDS = ("torn", "corrupt", "delayed")
# Broker surface: the fake Kafka cluster's per-op faults.
# "down" is not drawn per-op — it comes from kafka_down windows.
KAFKA_KINDS = ("produce", "consume", "dr_fail", "conn_drop")


class EngineCrash(RuntimeError):
    """A simulated process crash raised at a runner boundary.

    Semantically the injected peer of ``kill -9``: the engine object is
    abandoned exactly where it stood (device state, parked drains,
    queued writebacks — all lost), and recovery must come entirely from
    the checkpoint + journal replay path, never from cleanup code."""


@dataclass(frozen=True)
class FaultPlan:
    """One immutable, fully-enumerated fault schedule.

    ``sink_faults``/``journal_faults`` map an operation index (counted by
    the injecting wrapper from its construction) to a fault kind;
    ``crashes`` is the ordered crash script.  An empty plan
    (:meth:`zeros`) injects nothing — wrappers built from it are exact
    pass-throughs, pinned by the byte-identical test.
    """

    seed: int = 0
    sink_faults: dict = field(default_factory=dict)      # op idx -> kind
    journal_faults: dict = field(default_factory=dict)   # poll idx -> kind
    crashes: tuple = ()                                  # ((kind, n), ...)
    # fleet surfaces; empty on every pre-fleet plan, so
    # old plans stay bit-identical under the same seed
    net_faults: dict = field(default_factory=dict)       # msg idx -> kind
    net_delay_ms: int = 0                                # "delay" hold time
    partition_windows: tuple = ()                        # ((start, len), ...)
    ship_faults: dict = field(default_factory=dict)      # ship idx -> kind
    # broker surface; empty on every pre-kafka plan, so old
    # plans stay bit-identical under the same seed
    kafka_faults: dict = field(default_factory=dict)     # op idx -> kind
    kafka_down: tuple = ()                               # ((start, end), ...)

    @classmethod
    def zeros(cls) -> "FaultPlan":
        """The no-fault plan (chaos layer present, adversity absent)."""
        return cls()

    @classmethod
    def generate(cls, seed: int, *,
                 sink_rate: float = 0.0,
                 sink_ops: int = 0,
                 sink_outage: tuple[int, int] | None = None,
                 sink_partial_rate: float = 0.0,
                 journal_rate: float = 0.0,
                 journal_polls: int = 0,
                 crashes: int = 0,
                 crash_span: int = 8,
                 net_drop_rate: float = 0.0,
                 net_delay_rate: float = 0.0,
                 net_delay_ms: int = 25,
                 net_dup_rate: float = 0.0,
                 net_torn_rate: float = 0.0,
                 net_msgs: int = 0,
                 partition_windows: tuple = (),
                 ship_rate: float = 0.0,
                 ship_ops: int = 0,
                 kafka_produce_rate: float = 0.0,
                 kafka_consume_rate: float = 0.0,
                 kafka_dr_fail_rate: float = 0.0,
                 kafka_conn_drop_rate: float = 0.0,
                 kafka_ops: int = 0,
                 kafka_down: tuple = ()) -> "FaultPlan":
        """Roll a deterministic plan from ``seed``.

        ``sink_rate``/``journal_rate`` are per-operation fault
        probabilities over the first ``sink_ops``/``journal_polls``
        operations (beyond those indices the surface runs clean, which
        guarantees retries eventually succeed).  ``sink_outage=(start,
        length)`` additionally fails every sink op in that index range —
        a hard outage window.  ``sink_partial_rate`` rolls the
        non-atomic ``partial`` fault on top (same index space, same
        single RNG draw, so plans with the rate at 0 are bit-identical
        to pre-partial plans under the same seed) — exactly-once sweeps
        only, see :data:`SINK_PARTIAL`.  ``crashes`` schedules that many
        crash points, each at a random boundary kind within the first
        ``crash_span`` boundaries of an attempt.

        Fleet surfaces (all default-off): the ``net_*_rate``
        knobs roll one fault decision per pub/sub message over the
        first ``net_msgs`` messages through a ``ChaosPubSub`` proxy
        (one RNG draw per index, cumulative thresholds — a rate at 0
        leaves the other kinds' schedule unchanged); ``net_delay_ms``
        is the hold a ``delay`` fault imposes.
        ``partition_windows=((start, length), ...)`` drops every
        message in those global-index windows outright.  ``ship_rate``
        rolls torn/corrupt/delayed append damage over the first
        ``ship_ops`` ship-log appends.  All fleet draws happen AFTER
        the legacy surfaces' draws, so plans with the fleet knobs at
        their defaults are bit-identical to pre-fleet plans under the
        same seed (the ``sink_partial_rate`` precedent).

        Broker surface (all default-off): the ``kafka_*_rate``
        knobs roll one fault decision per broker op over the first
        ``kafka_ops`` ops (cumulative thresholds, same guarantees as the
        net draws); ``kafka_down=((start, end), ...)`` fails every
        broker op whose index falls in a window.  Kafka draws happen
        LAST, after the fleet draws, so plans with the kafka knobs at
        their defaults are bit-identical to pre-kafka plans.
        """
        rng = random.Random(seed)
        sink: dict[int, str] = {}
        for i in range(sink_ops):
            roll = rng.random()
            if roll < sink_rate:
                sink[i] = rng.choice(SINK_KINDS)
            elif sink_partial_rate and roll < sink_rate + sink_partial_rate:
                sink[i] = SINK_PARTIAL
        if sink_outage is not None:
            start, length = sink_outage
            for i in range(start, start + length):
                sink[i] = "refused"
        journal: dict[int, str] = {}
        for i in range(journal_polls):
            if rng.random() < journal_rate:
                journal[i] = rng.choice(JOURNAL_KINDS)
        # Batch boundaries are plentiful; flush/checkpoint boundaries are
        # scarce in catchup mode (one final flush + one final checkpoint
        # per attempt, plus the 1 Hz periodic ones a fast drain may never
        # reach) — cap their scheduled ordinal at 2 so the armed head of
        # the script is always reachable and never wedges the whole plan.
        crash_script = []
        for _ in range(crashes):
            kind = rng.choice(CRASH_KINDS)
            hi = crash_span if kind == "batch" else min(crash_span, 2)
            crash_script.append((kind, rng.randrange(1, hi + 1)))
        crash_script = tuple(crash_script)
        # fleet draws LAST (bit-identity for pre-fleet plans): one roll
        # per message index, kinds picked by cumulative rate thresholds
        # so turning one kind on never reshuffles another kind's draws
        net: dict[int, str] = {}
        rates = (("drop", net_drop_rate), ("delay", net_delay_rate),
                 ("dup", net_dup_rate), ("torn", net_torn_rate))
        for i in range(net_msgs):
            roll = rng.random()
            lo = 0.0
            for kind, rate in rates:
                if rate and roll < lo + rate:
                    net[i] = kind
                    break
                lo += rate
        ship: dict[int, str] = {}
        for i in range(ship_ops):
            if rng.random() < ship_rate:
                ship[i] = rng.choice(SHIP_FAULT_KINDS)
        windows = tuple((int(s), int(n)) for s, n in partition_windows)
        # broker draws LAST (bit-identity for pre-kafka plans): same
        # cumulative-threshold scheme as the net draws
        kafka: dict[int, str] = {}
        krates = (("produce", kafka_produce_rate),
                  ("consume", kafka_consume_rate),
                  ("dr_fail", kafka_dr_fail_rate),
                  ("conn_drop", kafka_conn_drop_rate))
        for i in range(kafka_ops):
            roll = rng.random()
            lo = 0.0
            for kind, rate in krates:
                if rate and roll < lo + rate:
                    kafka[i] = kind
                    break
                lo += rate
        kdown = tuple((int(s), int(e)) for s, e in kafka_down)
        return cls(seed=seed, sink_faults=sink, journal_faults=journal,
                   crashes=crash_script, net_faults=net,
                   net_delay_ms=int(net_delay_ms),
                   partition_windows=windows, ship_faults=ship,
                   kafka_faults=kafka, kafka_down=kdown)

    @property
    def is_zero(self) -> bool:
        return not (self.sink_faults or self.journal_faults
                    or self.crashes or self.net_faults
                    or self.partition_windows or self.ship_faults
                    or self.kafka_faults or self.kafka_down)


class CrashScheduler:
    """Raises :class:`EngineCrash` at scripted runner boundaries.

    Holds the plan's ordered crash script; only the HEAD entry is armed.
    Boundary counts are per-attempt (``reset()`` at every supervised
    restart), so ``("flush", 3)`` means "the 3rd flush of the current
    attempt", which keeps crash points reachable no matter where the
    previous crash left the stream.  Exhausted schedulers never raise —
    the run is guaranteed to finish once the script is consumed.
    """

    def __init__(self, crashes, counters: FaultCounters | None = None):
        for kind, n in crashes:
            if kind not in CRASH_KINDS or n < 1:
                raise ValueError(f"bad crash point ({kind!r}, {n})")
        self._pending = deque(crashes)
        self.counters = counters if counters is not None else FaultCounters()
        self._counts: dict[str, int] = {}

    def reset(self) -> None:
        """New run attempt: boundary counts restart at zero."""
        self._counts = {}

    @property
    def exhausted(self) -> bool:
        return not self._pending

    @property
    def remaining(self) -> int:
        return len(self._pending)

    def point(self, kind: str) -> None:
        """One boundary of ``kind`` passed; crash here if scripted."""
        self._counts[kind] = c = self._counts.get(kind, 0) + 1
        if not self._pending:
            return
        want_kind, want_n = self._pending[0]
        if kind == want_kind and c >= want_n:
            self._pending.popleft()
            self.counters.inc("crashes_injected")
            raise EngineCrash(f"injected crash at {kind} #{c}")
