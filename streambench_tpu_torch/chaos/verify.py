"""Oracle-verified accounting: the executable recovery contract.

The port's copy of the single-engine checks of
``streambench_tpu/chaos/verify.py``.  For a supervised chaos run
(``chaos.supervisor``) over a journaled topic, every per-window Redis
count must satisfy::

    oracle(w)  <=  count(w)  <=  oracle(w) + bound(w)

where ``oracle`` is the golden model's exact view count
(``datagen.gen.dostats``, the peer of ``check-correct`` in
``core.clj:215-237``) and ``bound`` is the sum of the two legal
over-count sources the supervisor recorded:

- the *replay segments*: for each crash, the view events in the journal
  byte range ``[resume_offset, crash_offset)`` -- events that may have
  been flushed before the crash and re-folded after the resume;
- the *carried pending*: snapshot-carried deltas (reclaimed failed
  writes) that may already have landed before the crash and are
  re-flushed after restore.

A count below the oracle is lost data; a count above the bound is
double-counting the contract does not allow.  With
``jax.sink.exactly_once`` on, :func:`check_exactly_once` drops the bound:
the fence protocol reconciles both sources, so ``count(w) == oracle(w)``
must hold for every window.  :func:`check_kafka_edge` balances the
broker edge's delivery ledger (``consumed == delivered + redelivered``,
``delivered == sent``).

Fleet invariants: a fleet chaos run (network faults on the query plane,
ship-log faults on the replica feed, crash-faulted replicas behind the
router) must additionally satisfy, by :class:`FleetVerdict`:

- **shed-or-answer accounting**: every request id sent gets EXACTLY one
  terminal reply, an answer or an honest shed, so ``sent == answered +
  shed`` with no duplicates and no silent drops
  (:func:`check_fleet_accounting`);
- **staleness honesty**: every ANSWER's ``plane_epoch`` is at least the
  epoch that was durable in the ship log one staleness bound before the
  query was submitted (:func:`check_staleness_bound`, over the ship
  log's epoch timeline);
- **post-heal convergence**: once faults stop and a final forced ship
  lands, every surviving replica reaches the writer's final epoch, and
  the close-time reach record is bit-identical to the fault-free arm's
  (:func:`check_fleet_convergence`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.io.redis_schema import read_seen_counts


def segment_view_counts(topic_path: str, segments,
                        mapping: dict[str, str],
                        divisor_ms: int = 10_000) -> dict:
    """Per-window view counts over journal byte ranges.

    ``segments`` are ``(lo, hi)`` byte offsets into the topic file (the
    unit the supervisor records); multi-partition offset vectors are not
    supported (the chaos harness drives single-partition topics).
    Returns ``(campaign, abs_window_ts) -> count`` summed over segments;
    overlapping segments intentionally double-count (each crash is an
    independent replay opportunity).
    """
    out: dict[tuple[str, int], int] = {}
    with open(topic_path, "rb") as f:
        for lo, hi in segments:
            if isinstance(lo, list) or isinstance(hi, list):
                raise ValueError(
                    "segment offsets must be scalars (single-partition "
                    f"topics only): ({lo!r}, {hi!r})")
            if hi <= lo:
                continue
            f.seek(lo)
            blob = f.read(hi - lo)
            for line in blob.split(b"\n"):
                if not line.strip() or b"\x00" in line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # segment edge cut a record in half
                if ev.get("event_type") != "view":
                    continue
                campaign = mapping.get(ev.get("ad_id"))
                if campaign is None:
                    continue
                wts = (int(ev["event_time"]) // divisor_ms) * divisor_ms
                out[(campaign, wts)] = out.get((campaign, wts), 0) + 1
    return out


@dataclass
class ChaosVerdict:
    """The bound check's full report (``ok`` is the headline)."""

    ok: bool
    windows: int = 0
    exact: int = 0               # count == oracle
    within_bound: int = 0        # oracle < count <= oracle + bound
    undercounts: list = field(default_factory=list)
    overcounts: list = field(default_factory=list)
    max_overcount: int = 0
    # one-paste repro for a red run (see replay_note): appended to
    # summary() so every sweep assertion message carries it
    repro: str | None = None

    def summary(self) -> str:
        s = (f"chaos verdict: ok={self.ok} windows={self.windows} "
             f"exact={self.exact} within_bound={self.within_bound} "
             f"under={len(self.undercounts)} over={len(self.overcounts)} "
             f"max_overcount={self.max_overcount}")
        if self.repro:
            s += "\n" + self.repro
        return s


def replay_note(*, seed, topic_path: str,
                overrides: dict | None = None) -> str:
    """One-paste repro line for a failing seeded chaos run.

    Fault plans are fully determined by their seed, so a red sweep
    replays bit-identically from (test node, seed, config overrides,
    topic).  Inside pytest the exact node id comes from
    ``PYTEST_CURRENT_TEST``; the seed/topic/overrides ride along for
    harnesses that drive plans directly.
    """
    node = os.environ.get("PYTEST_CURRENT_TEST", "").split(" ")[0]
    cmd = (f"python -m pytest '{node}' -q" if node
           else "python -m pytest tests/ -q -m chaos")
    parts = [f"seed={seed}", f"topic={topic_path}"]
    if overrides:
        parts.append("overrides[" + " ".join(
            f"{k}={v}" for k, v in sorted(overrides.items())) + "]")
    return f"replay: {cmd}   # {' '.join(parts)}"


def _read_oracle(workdir: str, divisor_ms: int) -> dict:
    """(campaign, abs_window_ts) -> exact view count, from the golden
    model (``datagen.gen.dostats``, the peer of ``check-correct``)."""
    oracle_buckets = gen.dostats(workdir, time_divisor_ms=divisor_ms)
    return {(c, b * divisor_ms): n
            for c, per in oracle_buckets.items()
            for b, n in per.items()}


def _read_actual(redis) -> dict:
    actual_nested = read_seen_counts(redis)
    return {(c, ts): n
            for c, per in actual_nested.items()
            for ts, n in per.items()}


def check_exactly_once(redis, workdir: str,
                       divisor_ms: int = 10_000,
                       repro: str | None = None) -> ChaosVerdict:
    """Assert the exactly-once contract: for EVERY (campaign, window),
    ``redis_count(w) == oracle(w)`` — no bound, no slack.  The
    acceptance check for chaos runs with ``jax.sink.exactly_once`` on
    (ROBUSTNESS.md "Exactly-once"): replay segments and carried pending
    are reconciled by the fence protocol, so any deviation in either
    direction is a real bug.  ``repro`` (see :func:`replay_note`) is
    carried into the verdict so a red sweep's assertion message is one
    paste away from a bit-identical local replay."""
    oracle = _read_oracle(workdir, divisor_ms)
    actual = _read_actual(redis)
    v = ChaosVerdict(ok=True, repro=repro)
    for key in sorted(set(oracle) | set(actual)):
        want = oracle.get(key, 0)
        have = actual.get(key, 0)
        v.windows += 1
        if have == want:
            v.exact += 1
        elif have < want:
            v.ok = False
            v.undercounts.append((key, have, want))
        else:
            v.ok = False
            v.overcounts.append((key, have, want, 0))
            v.max_overcount = max(v.max_overcount, have - want)
    return v


def check_at_least_once(redis, workdir: str, topic_path: str,
                        replay_segments=(), carried=None,
                        divisor_ms: int = 10_000,
                        repro: str | None = None) -> ChaosVerdict:
    """Assert the at-least-once contract against a finished chaos run.

    ``redis`` holds the engine's writes; ``workdir`` holds the
    generator's ``kafka-json.txt`` + ad mapping (the oracle inputs);
    ``topic_path`` is the single-partition topic file whose byte offsets
    the supervisor's ``replay_segments`` index; ``carried`` is the
    supervisor's snapshot-carried pending map.  Violations are collected,
    not raised — tests assert on ``verdict.ok`` and print ``summary()``.
    """
    mapping = gen.load_ad_mapping_file(
        os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE))
    oracle = _read_oracle(workdir, divisor_ms)
    bound = segment_view_counts(topic_path, replay_segments, mapping,
                                divisor_ms)
    for key, n in (carried or {}).items():
        bound[key] = bound.get(key, 0) + n
    actual = _read_actual(redis)

    v = ChaosVerdict(ok=True, repro=repro)
    for key in sorted(set(oracle) | set(actual)):
        want = oracle.get(key, 0)
        have = actual.get(key, 0)
        slack = bound.get(key, 0)
        v.windows += 1
        if have == want:
            v.exact += 1
        elif want < have <= want + slack:
            v.within_bound += 1
            v.max_overcount = max(v.max_overcount, have - want)
        elif have < want:
            v.ok = False
            v.undercounts.append((key, have, want))
        else:
            v.ok = False
            v.overcounts.append((key, have, want, slack))
            v.max_overcount = max(v.max_overcount, have - want)
    return v


# ---------------------------------------------------------------------
# fleet invariants
# ---------------------------------------------------------------------

@dataclass
class FleetVerdict:
    """The fleet chaos run's full report (``ok`` is the headline)."""

    ok: bool
    sent: int = 0
    answered: int = 0
    shed: int = 0
    # accounting violations: ids answered/shed more than once, ids that
    # got no terminal reply at all, reply ids nobody sent
    duplicate_ids: list = field(default_factory=list)
    missing_ids: list = field(default_factory=list)
    unexpected_ids: list = field(default_factory=list)
    # staleness violations: (id, plane_epoch, floor_epoch, submit_ms)
    stale_violations: list = field(default_factory=list)
    # convergence: replicas that never reached the writer's final epoch
    # ((idx, replica_epoch, writer_epoch)); divergent = the close-time
    # reach record differs bit-for-bit from the fault-free arm's
    lagging_replicas: list = field(default_factory=list)
    divergent: bool = False
    writer_epoch: int | None = None
    repro: str | None = None

    def summary(self) -> str:
        s = (f"fleet verdict: ok={self.ok} sent={self.sent} "
             f"answered={self.answered} shed={self.shed} "
             f"dup={len(self.duplicate_ids)} "
             f"missing={len(self.missing_ids)} "
             f"unexpected={len(self.unexpected_ids)} "
             f"stale_violations={len(self.stale_violations)} "
             f"lagging={len(self.lagging_replicas)} "
             f"divergent={self.divergent}")
        if self.repro:
            s += "\n" + self.repro
        return s


def check_fleet_accounting(sent_ids, replies,
                           repro: str | None = None) -> FleetVerdict:
    """Assert ``sent == answered + shed`` EXACTLY, by request id.

    ``sent_ids`` is every id the client submitted; ``replies`` is every
    terminal reply payload it received (answers, sheds, error replies —
    an error IS an answer: the client heard back).  Each sent id must
    appear exactly once; a duplicate means the dedup/dup-fault machinery
    double-answered, a missing id means a query was silently dropped
    (the one thing the router contract forbids), an unexpected id means
    a stale retry leaked through the client's discard set.
    """
    v = FleetVerdict(ok=True, repro=repro)
    sent = list(sent_ids)
    v.sent = len(sent)
    sent_set = set(sent)
    seen: dict = {}
    for rep in replies:
        rid = rep.get("id")
        if rid not in sent_set:
            v.ok = False
            v.unexpected_ids.append(rid)
            continue
        if rid in seen:
            v.ok = False
            v.duplicate_ids.append(rid)
            continue
        seen[rid] = rep
        if rep.get("shed"):
            v.shed += 1
        else:
            v.answered += 1
    for rid in sent:
        if rid not in seen:
            v.ok = False
            v.missing_ids.append(rid)
    return v


def ship_epoch_timeline(ship_path: str) -> list:
    """``(stamp_ms, epoch)`` per decodable reach-sketch record in the
    ship log, append order.  The stamp is the writer's submit stamp
    (``sm``) falling back to the record stamp (``t``) — the moment the
    record became durable, which is what the staleness bound is
    measured against."""
    out = []
    try:
        f = open(ship_path, "rb")
    except OSError:
        return out
    with f:
        for line in f:
            line = line.strip()
            if not line or b'"reach_sketch"' not in line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn/corrupted by the chaos layer: not durable
            if rec.get("kind") != "reach_sketch":
                continue
            stamp = rec.get("sm", rec.get("t", 0))
            out.append((int(stamp), int(rec.get("epoch", 0))))
    return out


def durable_epoch_at(timeline, stamp_ms: int) -> int | None:
    """Newest epoch durable at ``stamp_ms`` (None: nothing was)."""
    epoch = None
    for t, e in timeline:
        if t <= stamp_ms:
            epoch = e if epoch is None else max(epoch, e)
    return epoch


def check_staleness_bound(queries, timeline, max_staleness_ms: int,
                          verdict: FleetVerdict | None = None,
                          slack_ms: int = 0) -> FleetVerdict:
    """Assert no answer served planes staler than the bound.

    ``queries`` is ``(submit_ms, reply)`` per request the client made
    (client-clock submit stamp; single-host runs share the clock with
    the ship log's stamps).  For every ANSWERED reply carrying a
    ``plane_epoch``, the epoch must be at least the newest epoch that
    was durable at ``submit_ms - max_staleness_ms`` — a reply below
    that floor means some replica silently served beyond-bound planes
    instead of shedding or being failed over.  Sheds and error replies
    are exempt (they are the honest path).  ``slack_ms`` absorbs stamp
    granularity at the window edge.
    """
    v = verdict if verdict is not None else FleetVerdict(ok=True)
    for submit_ms, rep in queries:
        if rep is None or rep.get("shed") or rep.get("error"):
            continue
        epoch = rep.get("plane_epoch", rep.get("epoch"))
        if epoch is None:
            continue
        floor = durable_epoch_at(
            timeline, int(submit_ms) - int(max_staleness_ms) - slack_ms)
        if floor is not None and int(epoch) < floor:
            v.ok = False
            v.stale_violations.append(
                (rep.get("id"), int(epoch), floor, int(submit_ms)))
    return v


def final_reach_record(ship_path: str) -> dict | None:
    """The last decodable reach-sketch record in a ship log, raw (the
    base64 plane fields uncompared-decoded — bit-identity is judged on
    the encoded bytes)."""
    newest = None
    try:
        f = open(ship_path, "rb")
    except OSError:
        return None
    with f:
        for line in f:
            line = line.strip()
            if not line or b'"reach_sketch"' not in line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("kind") == "reach_sketch" and "mins" in rec:
                newest = rec
    return newest


def check_fleet_convergence(ship_path: str, replica_epochs,
                            clean_ship_path: str | None = None,
                            verdict: FleetVerdict | None = None
                            ) -> FleetVerdict:
    """Assert post-heal convergence.

    ``replica_epochs`` is each surviving replica's final loaded
    ``plane_epoch`` (index order).  Every one must equal the writer's
    final shipped epoch — after faults stop, the forced close-time ship
    lands intact and one poll later the fleet agrees.  With
    ``clean_ship_path`` (the fault-free arm's ship log), the close-time
    reach record must match it bit-for-bit on the plane payloads —
    chaos may delay convergence, it must never change what is converged
    TO.
    """
    v = verdict if verdict is not None else FleetVerdict(ok=True)
    final = final_reach_record(ship_path)
    if final is None:
        v.ok = False
        v.divergent = True
        return v
    v.writer_epoch = int(final.get("epoch", 0))
    for idx, epoch in enumerate(replica_epochs):
        if epoch is None or int(epoch) != v.writer_epoch:
            v.ok = False
            v.lagging_replicas.append((idx, epoch, v.writer_epoch))
    if clean_ship_path is not None:
        clean = final_reach_record(clean_ship_path)
        same = (clean is not None and
                all(final.get(k) == clean.get(k)
                    for k in ("mins", "regs", "c", "k", "r", "epoch")))
        if not same:
            v.ok = False
            v.divergent = True
    return v


# ---------------------------------------------------------------------
# broker-edge invariants
# ---------------------------------------------------------------------

@dataclass
class KafkaEdgeVerdict:
    """The broker-edge delivery ledger, balanced or not.

    The accounting identity a faulted broker run must satisfy::

        consumed == delivered + redelivered      (no uncounted duplicate,
                                                  no silent drop at the
                                                  consumer)
        delivered == sent                        (every acked produce
                                                  reached the engine
                                                  exactly once)

    where ``sent`` is the producers' acked-record count
    (``kafka_produced``), ``consumed`` every record the broker handed
    up, ``delivered`` the unique records returned to the engine, and
    ``redelivered`` the reconnect duplicates the reader counted and
    filtered.  ``windows`` optionally folds in an oracle window-count
    verdict (:func:`check_at_least_once` / :func:`check_exactly_once`)
    so one ``ok`` covers socket-to-Redis.
    """

    ok: bool
    sent: int = 0
    delivered: int = 0
    redelivered: int = 0
    consumed: int = 0
    produce_retries: int = 0
    consume_retries: int = 0
    broker_down_ms: int = 0
    violations: list = field(default_factory=list)
    windows: "ChaosVerdict | None" = None
    repro: str | None = None

    def summary(self) -> str:
        s = (f"kafka edge verdict: ok={self.ok} sent={self.sent} "
             f"delivered={self.delivered} redelivered={self.redelivered} "
             f"consumed={self.consumed} "
             f"produce_retries={self.produce_retries} "
             f"consume_retries={self.consume_retries} "
             f"broker_down_ms={self.broker_down_ms} "
             f"violations={self.violations}")
        if self.windows is not None:
            s += "\n" + self.windows.summary()
        if self.repro:
            s += "\n" + self.repro
        return s


def check_kafka_edge(counters, *, sent: int | None = None,
                     require_redeliveries: bool = False,
                     windows: "ChaosVerdict | None" = None,
                     repro: str | None = None) -> KafkaEdgeVerdict:
    """Assert the broker edge's delivery accounting from one counter
    snapshot (the ``KafkaBroker``-shared :class:`~streambench_tpu_torch.
    metrics.FaultCounters`, or a plain snapshot dict).

    ``sent`` overrides the producer-acked count when the ground truth
    comes from elsewhere (the broker log length, the generator's event
    count); ``require_redeliveries`` makes a faulted sweep prove its
    conn-drop faults actually exercised the redelivery path.  Pass the
    run's oracle window verdict as ``windows`` to fold end-to-end count
    correctness into the same ``ok``.
    """
    snap = counters.snapshot() if hasattr(counters, "snapshot") \
        else dict(counters)
    v = KafkaEdgeVerdict(
        ok=True,
        sent=int(snap.get("kafka_produced", 0) if sent is None else sent),
        delivered=int(snap.get("kafka_delivered", 0)),
        redelivered=int(snap.get("kafka_redeliveries", 0)),
        consumed=int(snap.get("kafka_consumed", 0)),
        produce_retries=int(snap.get("kafka_produce_retries", 0)),
        consume_retries=int(snap.get("kafka_consume_retries", 0)),
        broker_down_ms=int(snap.get("kafka_broker_down_ms", 0)),
        windows=windows, repro=repro)
    if v.consumed != v.delivered + v.redelivered:
        v.ok = False
        v.violations.append(
            f"consumed({v.consumed}) != delivered({v.delivered}) "
            f"+ redelivered({v.redelivered})")
    if v.delivered != v.sent:
        v.ok = False
        v.violations.append(
            f"delivered({v.delivered}) != sent({v.sent})")
    if require_redeliveries and v.redelivered <= 0:
        v.ok = False
        v.violations.append(
            "redeliveries required but none observed (the conn-drop "
            "faults never exercised the redelivery path)")
    if windows is not None and not windows.ok:
        v.ok = False
        v.violations.append("oracle window-count check failed")
    return v
