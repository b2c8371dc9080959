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

Not ported yet: the fleet checks (``check_fleet_accounting``,
``check_staleness_bound``, ``check_fleet_convergence`` and the ship-log
epoch timeline), which need the reach serving tier and its fleet.
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
