"""Bounded, load-shedding reach-query server.

The port of ``streambench_tpu/reach/serve.py``: the same admission,
shedding, batching, cache and staleness rules, evaluated by the port's
``reach.query.batch_query`` on the planes' device.  Two things differ,
both because torch tensors are mutable and CUDA launches asynchronous:
the planes a push hands over are copies (below), and a batch's results
are read after one CUDA event on the stream the query ran on.

The serving contract mirrors the pub/sub layer's prime directive —
queries must never stall aggregation — extended with explicit admission
control:

- a **bounded queue** (``jax.reach.queue.depth``): a submit beyond the
  depth sheds the OLDEST pending query (freshest-first under overload —
  the newest queries are the ones whose answer is still wanted), the
  shed query is *answered* with ``{"shed": true}`` rather than dropped
  silently, and ``streambench_reach_shed_total`` counts it;
- **batched evaluation**: the worker drains everything queued (up to
  the batch cap) into ONE padded ``reach.query.batch_query`` dispatch,
  so thousands of concurrent queries amortize into a handful of device
  steps (``summary()['dispatches']`` is the bench's acceptance number);
- **per-query latency** (submit -> reply) lands in the
  ``streambench_reach_latency_ms`` histogram, which the
  ``jax.reach.slo.p99.ms`` objective (obs/slo.py) judges with the same
  two-window burn-rate machinery as the window-latency SLO;
- **epoch tagging**: every answer carries the epoch of the sketch
  state it was evaluated against.  The engine bumps the epoch on every
  restore, so a client can detect that an answer pre-dates a crash
  recovery — the chaos sweep asserts no post-resume answer carries a
  pre-resume epoch.

Query-path observability (all default-off):

- ``queryattr`` (a ``QueryLifecycle``, ``jax.obs.query``) stamps every
  query at admission / queue-exit / dispatch-submit / dispatch-complete
  / reply-write and decomposes the submit -> reply latency into
  queue/batch/dispatch/reply segments that sum to it; shed victims get a
  queue-only record reconciling exactly against
  ``streambench_reach_shed_total``; replies then carry a ``server``
  block so clients can split network-vs-server time.
- ``spans`` (``obs.spans.SpanTracer``) receives per-batch
  ``query_assembly``/``query_dispatch``/``query_reply`` spans under the
  ``"query"`` category — the worker thread is its own lane in
  the perfetto trace, interleaved with the engine's ingest folds on the
  shared clock, which is what the contention ratio is computed from.
- ``flightrec`` gets the serving black-box records: rate-limited shed
  events and queue high-water marks, so a crash dump explains the
  query backlog.

State arrives by push (``update_state``).  The engine's fold updates its
planes in place, so a server that kept references to them could read a
half-folded batch; the engine pushes copies instead
(``ReachSketchEngine._reach_push``: a device clone on the fold's stream,
ordered before the next fold), the replica loads a fresh tensor per
record, and the worker evaluates against a consistent snapshot while
folds continue.

Scale-out additions:

- **epoch + staleness stamps**: every push carries the host-ms stamp of
  when its planes were serialized (``shipped_ms``; defaults to push
  time for a writer-attached server), and every answer carries
  ``plane_epoch`` + ``staleness_ms`` so a client can bound how old the
  evidence behind an estimate is.  With ``max_staleness_ms`` set (read
  replicas), queries are SHED rather than answered against planes
  staler than the bound — including the not-yet-loaded-any-epoch case,
  where a replica must never block clients waiting for its first
  snapshot.
- **result cache** (``reach.cache.ReachQueryCache``): probes at
  admission under the live epoch, fills at evaluation, and is
  invalidated wholesale on every epoch bump.  Hits reply synchronously
  from the admission path — no queue, no dispatch — which is what the
  bench's cache-hit-p99 acceptance measures.

Fleet freshness ledger (``update_state(freshness=)``, a replica's
``--fleet`` mode): each push carries the writer's fold / ship-submit /
shipped stamps (mapped into the replica's clock by ``obs/clock.py``) and
the replica's own load stamp; every reply then carries the per-hop
decomposition of its evidence age (``freshness_hops``), observed into
``streambench_fleet_freshness_ms{hop=}``, and the staleness clock anchors
at the fold.

The evaluator is ``reach.query.batch_query`` unless an engine swaps in
its own through ``use_query_fn`` at attach time: the sharded reach
engine hands in its evaluation next to the shards
(``ShardedReachEngine.query_callable``, two collectives a dispatch).
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from streambench_tpu_torch.reach import query as rq
from streambench_tpu_torch.utils.ids import now_ms

#: shared instrument name — obs/slo.py's reach objective get-or-creates
#: the SAME histogram geometry, so both sides see one instrument
LATENCY_HIST = "streambench_reach_latency_ms"

#: The fleet freshness hops, in pipeline order.  A reply's
#: age decomposes into: ``fold_lag`` (last fold into the planes ->
#: ship submit — the shipping-cadence wait), ``ship_wait`` (ship
#: submit -> record appended durable), ``tail_lag`` (record durable ->
#: this replica loaded it — the tailer poll), and ``serve`` (loaded ->
#: this reply written — how long the planes have been serving).  The
#: four sum EXACTLY to the fold-anchored ``staleness_ms`` the same
#: reply carries; writer-clock stamps are mapped into the replica's
#: clock first (obs/clock.py) so cross-host deltas are honest.
FRESHNESS_HOPS = ("fold_lag", "ship_wait", "tail_lag", "serve")

#: histogram family the per-hop samples land in (label ``hop=``, plus
#: ``hop="total"`` for the summed evidence age — the regress key)
FRESHNESS_HIST = "streambench_fleet_freshness_ms"


def freshness_hops(fresh: dict, reply_ms: "float | None" = None) -> dict:
    """One freshness decomposition from the stamp dict a fleet-mode
    state push carries (``folded_ms``/``submit_ms``/``shipped_ms`` in
    the writer clock — already offset-corrected by the replica — and
    the replica-local ``loaded_ms``).

    The stamp chain is clamped monotone (fold <= submit <= shipped <=
    loaded <= reply) so every hop is >= 0 and the partition contract
    holds by construction: ``sum(hops) == total`` exactly, where total
    is the reply's fold-anchored staleness.  A clamp only ever fires on
    sub-millisecond races or an uncorrected skew — the clock block the
    reply carries says which."""
    now = float(now_ms() if reply_ms is None else reply_ms)
    fm = float(fresh.get("folded_ms") or fresh.get("submit_ms")
               or fresh.get("shipped_ms") or now)
    sm = max(float(fresh.get("submit_ms") or fm), fm)
    tm = max(float(fresh.get("shipped_ms") or sm), sm)
    lm = max(float(fresh.get("loaded_ms") or tm), tm)
    now = max(now, lm)
    return {
        "fold_lag": sm - fm,
        "ship_wait": tm - sm,
        "tail_lag": lm - tm,
        "serve": now - lm,
        "total": now - fm,
    }


class ReachQueryServer:
    def __init__(self, campaigns: list[str], *, depth: int = 512,
                 batch: int = rq.DEFAULT_BATCH, registry=None,
                 hold: bool = False, queryattr=None, spans=None,
                 flightrec=None, cache=None,
                 max_staleness_ms: int | None = None):
        self.campaigns = list(campaigns)
        self._index = {c: i for i, c in enumerate(self.campaigns)}
        self.depth = max(int(depth), 1)
        self.batch = max(int(batch), 1)
        self._q: deque = deque()
        self._cv = threading.Condition()
        # (mins, registers, k, R, epoch, shipped_ms, freshness) where
        # freshness is the fleet stamp dict (None off the fleet path)
        self._state = None
        self._hold = bool(hold)
        self._closed = False
        self.served = 0
        self.shed = 0
        self.shed_stale = 0      # subset of shed: staleness-bound sheds
        self.rejected = 0
        self.dispatches = 0
        # result cache, staleness bound (replicas)
        self._cache = cache
        self.max_staleness_ms = (None if max_staleness_ms is None
                                 else max(int(max_staleness_ms), 0))
        # the batch evaluator (an engine may swap it: use_query_fn)
        self._query_fn = rq.batch_query
        # serving observability — all None on the default
        # path: one attribute check per admission/batch, replies
        # byte-identical until jax.obs.query wires a QueryLifecycle
        self._queryattr = queryattr
        self._spans = spans
        self._flightrec = flightrec
        self.queue_high_water = 0
        self._fr_hw_recorded = 1     # next high-water worth a record
        self._fr_shed_last = 0.0     # monotonic stamp of last shed rec
        # fleet freshness: histograms are created lazily at the first
        # freshness-carrying reply so a fleet-off scrape surface is
        # unchanged; the flight-recorder high-water starts at 1/8 of the
        # staleness bound (unbounded servers: 1 s) and doubles per
        # record — a log2-bounded trail, as reach_queue_high_water does
        self._registry = registry
        self._fresh_hists = None
        self.freshness_high_water = 0.0
        self._fr_fresh_recorded = max(
            (self.max_staleness_ms or 0) / 8.0, 1000.0 / 8.0)
        self._warmed = False         # query run once (first push)
        self._lat_ring: deque = deque(maxlen=8192)  # ms, summary() only
        # raw (admit_ns, pop_ns) queue-wait intervals, monotonic clock:
        # CLOCK_MONOTONIC is system-wide on Linux, so a bench can
        # intersect a REPLICA's waits with the WRITER's ingest-busy
        # windows across process boundaries (the off-writer contention
        # measurement)
        self._wait_ring: deque = deque(maxlen=8192)
        self._served_t0: float | None = None
        self._served_t1: float | None = None
        self._c_shed = self._c_served = self._hist = None
        self._g_epoch = self._g_staleness = self._g_qps = None
        if registry is not None:
            self._c_shed = registry.counter(
                "streambench_reach_shed_total",
                "reach queries shed (oldest-first beyond queue depth, "
                "or past the staleness bound)")
            self._c_served = registry.counter(
                "streambench_reach_served_total",
                "reach queries answered with an estimate")
            self._hist = registry.histogram(
                LATENCY_HIST,
                "reach query latency, submit to reply (ms)")
            # replica-tier gauges: live on the writer too —
            # a writer-attached server is just a zero-staleness replica
            self._g_epoch = registry.gauge(
                "streambench_reach_replica_epoch",
                "epoch of the sketch planes this server answers against")
            self._g_staleness = registry.gauge(
                "streambench_reach_replica_staleness_ms",
                "age of the served planes: now minus their shipped "
                "stamp (bounded by the shipping cadence when healthy)")
            self._g_qps = registry.gauge(
                "streambench_reach_replica_qps",
                "served queries per second over the serving span")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="reach-query")
        self._thread.start()

    # -- state push ----------------------------------------------------
    def update_state(self, mins, registers, epoch: int,
                     shipped_ms: int | None = None,
                     freshness: dict | None = None) -> None:
        """Engine-side push of the current sketch planes: tensors no fold
        touches again (the engine clones its planes for the push; the
        handoff is atomic under the GIL).  The FIRST push runs the
        padded query once on the caller's thread — the engine-warmup
        rule ("run every device program before announcing readiness")
        applied to the serving tier: the first push happens at attach
        time, before traffic.

        ``shipped_ms``: host-ms stamp of when these planes were
        serialized — the replica staleness clock.  Writer-attached
        pushes omit it: their replies carry ``plane_epoch`` only
        (stamping a wall-clock staleness there would make replies
        nondeterministic for zero information — the planes ARE the
        writer's live state).

        ``freshness`` (fleet mode): the stamp dict
        (``folded_ms``/``submit_ms``/``shipped_ms`` writer-clock —
        offset-corrected by the replica — plus the local ``loaded_ms``,
        stamped once the planes are on the device, and a ``clock``
        estimate block).  When present, replies carry the per-hop
        decomposition and the staleness clock anchors at the FOLD
        watermark (the age of the evidence, which the hops sum to
        exactly) instead of the ship stamp."""
        if not self._warmed:
            self._warm(mins, registers)
        epoch = int(epoch)
        if self._cache is not None:
            # wholesale invalidation BEFORE the swap: a concurrent probe
            # may briefly miss under the new epoch, never hit stale
            self._cache.note_epoch(epoch)
        with self._cv:
            self._state = (mins, registers,
                           int(mins.shape[1]), int(registers.shape[1]),
                           epoch,
                           int(shipped_ms) if shipped_ms is not None
                           else None,
                           dict(freshness) if freshness else None)
            self._cv.notify()
        if self._g_epoch is not None:
            self._g_epoch.set(epoch)

    def _warm(self, mins, registers) -> None:
        try:
            C = len(self.campaigns)
            self._query_fn(
                mins, registers, np.zeros((self.batch, C), bool),
                np.zeros(self.batch, bool))[0].cpu()
            self._warmed = True
        except Exception:
            pass   # a failed warmup must not block serving; the first
            #        real batch runs the query cold instead

    # -- staleness (replica serving bound) -----------------------------
    @staticmethod
    def _anchor(st) -> "float | None":
        """The stamp a state's age is measured from: the fleet fold
        watermark when the push carried freshness stamps (the hops sum
        to that age), else the shipped stamp, else None (live state)."""
        if st is None:
            return None
        fresh = st[6]
        if fresh is not None:
            anchor = (fresh.get("folded_ms") or fresh.get("submit_ms")
                      or fresh.get("shipped_ms"))
            if anchor is not None:
                return float(anchor)
        return float(st[5]) if st[5] is not None else None

    def staleness_ms(self, st=None) -> float | None:
        """Age of the served planes (vs their freshness anchor), or
        None when no push carried one (writer-attached: live state)."""
        st = st if st is not None else self._state
        anchor = self._anchor(st)
        if anchor is None:
            return None
        return float(max(now_ms() - anchor, 0))

    def _stale(self, st) -> bool:
        """True when answering against ``st`` would violate the
        staleness bound.  No bound configured -> never stale.  With a
        bound: no state yet, OR no stamp to prove freshness by, OR a
        stamp older than the bound -> stale (shed, don't block)."""
        if self.max_staleness_ms is None:
            return False
        anchor = self._anchor(st)
        return (anchor is None
                or (now_ms() - anchor) > self.max_staleness_ms)

    def use_query_fn(self, fn) -> None:
        """The engine's evaluator (``attach_reach``): the sharded engine
        routes evaluation through its shards.  Call it before the first
        push, so the warmup runs the evaluator that will serve."""
        self._query_fn = fn

    @property
    def epoch(self) -> int | None:
        st = self._state
        return st[4] if st is not None else None

    # -- fleet freshness ledger ------------------------------------
    def _freshness_block(self, st, reply_ms: "float | None" = None,
                         observe: bool = False) -> "dict | None":
        """The per-reply freshness decomposition, or None off the fleet
        path.  ``observe=True`` additionally lands one sample per hop
        (plus the total) in the ``streambench_fleet_freshness_ms``
        histograms and feeds the flight-recorder high-water trail —
        called once per SERVED reply so hop counts match the served
        count exactly."""
        fresh = st[6] if st is not None else None
        if fresh is None:
            return None
        hops = freshness_hops(fresh, reply_ms=reply_ms)
        block = {f"{hop}_ms": round(hops[hop], 1)
                 for hop in FRESHNESS_HOPS}
        # staleness == the hop sum BY CONSTRUCTION (same clamped chain,
        # same reply stamp) — the partition contract replies are pinned
        # against; rounding is per-hop, so the sum check carries
        # +-(len(hops) * 0.05) ms of slack at most
        block["staleness_ms"] = round(hops["total"], 1)
        clock = fresh.get("clock")
        if clock is not None:
            block["clock"] = {
                "offset_ms": clock.get("offset_ms"),
                "uncertainty_ms": clock.get("uncertainty_ms"),
                "applied": bool(clock.get("applied")),
            }
        if observe:
            self._observe_freshness(hops)
        return block

    def _observe_freshness(self, hops: dict) -> None:
        if self._registry is not None:
            if self._fresh_hists is None:
                self._fresh_hists = {
                    hop: self._registry.histogram(
                        FRESHNESS_HIST,
                        "end-to-end reply freshness by hop: the age of "
                        "the evidence behind a reach answer, decomposed "
                        "(ms)", lo=0.1, hi=1e8, growth=2 ** 0.125,
                        labels={"hop": hop})
                    for hop in FRESHNESS_HOPS + ("total",)}
            for hop, h in self._fresh_hists.items():
                h.observe(hops[hop])
        total = hops["total"]
        if total > self.freshness_high_water:
            self.freshness_high_water = total
        if (self._flightrec is not None
                and total >= 2 * self._fr_fresh_recorded):
            # doubling high-water: a staleness-shed storm leaves a
            # log2-bounded trail naming which hop grew (the crash-dump
            # reader's first question), without flooding the ring
            self._fr_fresh_recorded = total
            self._flightrec.record(
                "fleet_freshness_high_water",
                staleness_ms=round(total, 1),
                **{f"{hop}_ms": round(hops[hop], 1)
                   for hop in FRESHNESS_HOPS},
                max_staleness_ms=self.max_staleness_ms,
                shed_stale=self.shed_stale, served=self.served)

    # -- admission -----------------------------------------------------
    def handle(self, msg: dict, reply) -> None:
        """The pub/sub query-verb hook: parse, admit (shedding the
        oldest beyond depth), never raise.  ``trace``/``sent_ms`` are
        the client-side trace id and send stamp the lifecycle records
        propagate (ignored when query obs is off)."""
        self.submit(msg.get("campaigns"), msg.get("op", "union"), reply,
                    query_id=msg.get("id"), trace=msg.get("trace"),
                    client_ms=msg.get("sent_ms"))

    def submit(self, campaigns, op, reply, query_id=None, trace=None,
               client_ms=None) -> bool:
        """Admit one query.  Returns False when it was rejected outright
        (malformed); shedding affects the *oldest* queued query, never
        the one being admitted.  A cache hit under the live epoch
        replies synchronously from THIS path — no queue, no dispatch."""
        t0_ns = time.perf_counter_ns()
        if op not in ("union", "overlap") or not isinstance(
                campaigns, (list, tuple)) or not campaigns:
            self.rejected += 1
            self._safe_reply(reply, {"error": "bad_request", "op": op,
                                     "id": query_id})
            return False
        idx = []
        for c in campaigns:
            i = self._index.get(c)
            if i is None:
                self.rejected += 1
                self._safe_reply(reply, {"error": "unknown_campaign",
                                         "campaign": c, "id": query_id})
                return False
            idx.append(i)
        if self._cache is not None:
            st = self._state
            if st is not None and not self._stale(st):
                entry = self._cache.get(st[4], idx, op)
                if entry is not None:
                    self._reply_cached(entry, st, reply, query_id,
                                       trace, client_ms, t0_ns)
                    return True
        rec = None
        if self._queryattr is not None:
            rec = self._queryattr.admit(trace=trace, qid=query_id,
                                        client_ms=client_ms)
        item = (idx, op == "overlap", reply, query_id,
                time.monotonic(), rec)
        victims = []
        with self._cv:
            self._q.append(item)
            pending = len(self._q)
            if pending > self.queue_high_water:
                self.queue_high_water = pending
            while len(self._q) > self.depth:
                victims.append(self._q.popleft())
                self.shed += 1
                if self._c_shed is not None:
                    self._c_shed.inc()
            self._cv.notify()
        if (self._flightrec is not None
                and self.queue_high_water >= 2 * self._fr_hw_recorded):
            # high-water doubled since the last record: log2(depth)
            # records max, so the bounded flight ring keeps room for
            # the feeders that matter at crash time
            self._fr_hw_recorded = self.queue_high_water
            self._flightrec.record(
                "reach_queue_high_water",
                high_water=self.queue_high_water, depth=self.depth,
                shed=self.shed, served=self.served)
        for old in victims:   # replies outside the lock: a slow socket
            self._reply_shed(old)
        if victims and self._flightrec is not None:
            now = time.monotonic()
            if now - self._fr_shed_last >= 1.0:
                # rate-limited (1 Hz): a sustained overload leaves a
                # trail without flooding the ring one record per victim
                self._fr_shed_last = now
                self._flightrec.record(
                    "reach_shed", shed_total=self.shed,
                    pending=self.pending(), depth=self.depth,
                    served=self.served)
        return True

    def _reply_cached(self, entry: dict, st, reply, query_id, trace,
                      client_ms, t0_ns: int) -> None:
        """One cache-hit reply, written synchronously from the admission
        path.  Leaves exactly one served lifecycle record (queryattr
        reconciliation holds) and lands in BOTH latency histograms —
        the main serving one and the cache-hit one the A/B reads."""
        payload = dict(entry)
        payload["id"] = query_id
        payload["cached"] = True
        # age evidence is REPLY-time state (cache.CACHEABLE_KEYS): a
        # hit carries the cached PLANE's current freshness, recomputed
        # now — never the fill-time hops frozen into the entry
        fresh_block = self._freshness_block(st, observe=True)
        if fresh_block is not None:
            payload["freshness"] = fresh_block
            payload["staleness_ms"] = fresh_block["staleness_ms"]
        else:
            stale = self.staleness_ms(st)
            if stale is not None:
                payload["staleness_ms"] = round(stale, 1)
        rec = None
        ql = self._queryattr
        if ql is not None:
            rec = ql.admit(trace=trace, qid=query_id,
                           client_ms=client_ms)
            now = time.perf_counter_ns()
            rec.t_exit = now
            payload["server"] = ql.server_block(rec, now, now)
        self._safe_reply(reply, payload)
        if rec is not None:
            now = time.perf_counter_ns()
            ql.note_reply(rec, now, now)
        lat_ms = (time.perf_counter_ns() - t0_ns) / 1e6
        self._lat_ring.append(lat_ms)
        if self._hist is not None:
            self._hist.observe(lat_ms)
        hh = getattr(self._cache, "hit_hist", None)
        if hh is not None:
            hh.observe(lat_ms)
        self.served += 1
        if self._c_served is not None:
            self._c_served.inc()
        now_m = time.monotonic()
        if self._served_t0 is None:
            self._served_t0 = now_m
        self._served_t1 = now_m

    def _reply_shed(self, item, reason: str | None = None,
                    st=None) -> None:
        """Answer one shed victim ``{"shed": true}``; with query obs on
        the reply also carries the queue-only server block (shed
        queries stamp too — the record count reconciles against the
        shed counter exactly).  Staleness sheds name their reason and
        the epoch/staleness evidence."""
        payload = {"shed": True, "id": item[3]}
        if reason is not None:
            payload["reason"] = reason
            payload["plane_epoch"] = st[4] if st is not None else None
            stale = self.staleness_ms(st) if st is not None else None
            if stale is not None:
                payload["staleness_ms"] = round(stale, 1)
        rec = item[5]
        if rec is not None:
            queue_ms = self._queryattr.note_shed(rec)
            block = {"queue_ms": round(queue_ms, 3)}
            if rec.trace is not None:
                block["trace"] = rec.trace
            payload["server"] = block
        self._safe_reply(item[2], payload)

    # -- resume a held server (bench storms: queue while held, then drain
    # in ceil(pending/batch) dispatches) --------------------------------
    def resume(self) -> None:
        with self._cv:
            self._hold = False
            self._cv.notify()

    def pending(self) -> int:
        with self._cv:
            return len(self._q)

    # -- worker --------------------------------------------------------
    def _shed_items(self, items: list, reason: str, st) -> None:
        """Shed a popped batch (staleness bound): counted exactly like
        depth sheds — shed + served == sent stays an invariant."""
        for it in items:
            self.shed += 1
            self.shed_stale += 1
            if self._c_shed is not None:
                self._c_shed.inc()
            self._reply_shed(it, reason=reason, st=st)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._closed and (
                        self._hold or not self._q
                        or (self._state is None
                            and self.max_staleness_ms is None)):
                    # a staleness-bounded replica with no loaded epoch
                    # does NOT wait for one: it falls through and sheds
                    # (clients must never block on a replica's first
                    # snapshot load)
                    self._cv.wait(timeout=0.5)
                if self._closed and (not self._q
                                     or self._state is None):
                    # drain-at-close only works with state to evaluate
                    # against; without one, answer the stragglers as
                    # shed rather than spin
                    leftovers = list(self._q)
                    self._q.clear()
                    self.shed += len(leftovers)
                    if self._c_shed is not None:
                        # keep streambench_reach_shed_total == shed:
                        # close-time stragglers are sheds like any other
                        # (the lifecycle reconciliation depends on it)
                        for _ in leftovers:
                            self._c_shed.inc()
                else:
                    leftovers = None
                if leftovers is None and (
                        self._hold
                        or (self._state is None
                            and self.max_staleness_ms is None)):
                    continue
                items = state = None
                if leftovers is None:
                    items = [self._q.popleft()
                             for _ in range(min(len(self._q),
                                                self.batch))]
                    state = self._state
            if leftovers is not None:
                for it in leftovers:
                    self._reply_shed(it)
                return
            if self._stale(state):
                # staleness bound violated (or no epoch loaded yet):
                # shed rather than answer evidence older than the bound
                self._shed_items(items, reason="stale", st=state)
                continue
            try:
                self._evaluate(items, state)
            except Exception as e:   # a bad batch must not kill serving
                for it in items:
                    self._safe_reply(it[2], {"error": repr(e),
                                             "id": it[3]})

    def wait_intervals(self) -> list:
        """Raw [admit_ns, pop_ns] queue-wait intervals of evaluated
        queries (monotonic clock, bounded ring).  ``tuple()`` copies the
        ring in one C call, atomic under the GIL: the worker appends to
        it while a reader (the multi-tenant host's ``drain_waits``)
        walks it."""
        return [list(t) for t in tuple(self._wait_ring)]

    def _evaluate(self, items: list, state) -> None:
        ql = self._queryattr
        t_exit = time.perf_counter_ns()
        m_exit = time.monotonic_ns()
        for it in items:
            self._wait_ring.append((int(it[4] * 1e9), m_exit))
        recs = []
        if ql is not None:
            recs = [it[5] for it in items if it[5] is not None]
            for r in recs:
                r.t_exit = t_exit
        mins, registers, k, R, epoch, shipped_ms, fresh = state
        C = len(self.campaigns)
        mask = np.zeros((self.batch, C), bool)
        overlap = np.zeros(self.batch, bool)
        for row, (idx, is_overlap, _, _, _, _) in enumerate(items):
            mask[row, idx] = True
            overlap[row] = is_overlap
        t_submit = time.perf_counter_ns()
        est, union, jacc, _ = self._query_fn(
            mins, registers, mask, overlap)
        self.dispatches += 1
        # Resolve the dispatch first, then copy: one CUDA event recorded
        # on the stream the query ran on, waited for by this thread alone
        # (the fold thread's later launches do not extend the wait), as
        # the reference blocks on its results before converting them.
        t_bd = time.perf_counter_ns()
        if est.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(est.device))
            done.synchronize()
        if ql is not None and ql.device_sample_due(self.dispatches):
            # dispatch-to-completion device time, 1-in-N sampled (the
            # OccupancySampler's cadence rule); off-sample batches pay
            # only the wait they needed anyway
            ql.note_device_sample(
                (time.perf_counter_ns() - t_bd) / 1e6)
        est = est.cpu().numpy()
        union = union.cpu().numpy()
        jacc = jacc.cpu().numpy()
        t_done = time.perf_counter_ns()
        if ql is not None and recs:
            # contention accounting AFTER the block: any ingest fold
            # that overlapped these queue waits has completed by now,
            # so its measured busy window is already on record
            ql.note_queue_exit(recs)
        ub = rq.union_bound(R)
        ob = rq.overlap_bound(k, R)
        now = time.monotonic()
        # one wall stamp for the whole reply loop: every reply in the
        # batch carries the same age evidence, and the freshness hops
        # sum to the same staleness the reply states (fleet mode)
        now_wall = now_ms()
        fresh_block = fresh_hops_raw = None
        if fresh is not None:
            fresh_hops_raw = freshness_hops(fresh, reply_ms=now_wall)
            fresh_block = self._freshness_block(state, reply_ms=now_wall)
        if fresh_block is not None:
            staleness = fresh_block["staleness_ms"]
        else:
            staleness = (round(max(now_wall - shipped_ms, 0), 1)
                         if shipped_ms is not None else None)
        if self._served_t0 is None:
            self._served_t0 = now
        for row, (idx, is_overlap, reply, qid, t0, rec) in enumerate(
                items):
            lat_ms = (now - t0) * 1000.0
            self._lat_ring.append(lat_ms)
            if self._hist is not None:
                self._hist.observe(lat_ms)
            self.served += 1
            if self._c_served is not None:
                self._c_served.inc()
            op_name = "overlap" if is_overlap else "union"
            payload = {
                "op": op_name,
                "estimate": round(float(est[row]), 2),
                "union": round(float(union[row]), 2),
                "jaccard": round(float(jacc[row]), 5),
                # relative error bound: union is relative to the
                # estimate; overlap is relative to the UNION size (the
                # Jaccard estimator's natural scale)
                "bound": round(ob if is_overlap else ub, 5),
                "epoch": epoch,
                # explicit scale-out stamp: which planes
                # answered; replicas add how old their evidence was
                "plane_epoch": epoch,
                "id": qid,
            }
            if staleness is not None:
                payload["staleness_ms"] = staleness
            if fresh_block is not None:
                # fleet freshness ledger: one hop decomposition per
                # reply, observed into the {hop=} histograms so served
                # count == per-hop sample count exactly
                payload["freshness"] = fresh_block
                self._observe_freshness(fresh_hops_raw)
            if self._cache is not None:
                # cache the epoch-scoped answer (everything but the
                # per-query id and the reply-time age evidence —
                # cache.CACHEABLE_KEYS; put() is a no-op if the epoch
                # already moved)
                from streambench_tpu_torch.reach.cache import CACHEABLE_KEYS

                self._cache.put(epoch, idx, op_name, {
                    key: payload[key] for key in CACHEABLE_KEYS})
            if rec is not None:
                # server-side decomposition (up to reply-write start):
                # the client splits round-trip into network-vs-server
                payload["server"] = ql.server_block(rec, t_submit,
                                                    t_done)
            self._safe_reply(reply, payload)
            if rec is not None:
                ql.note_reply(rec, t_submit, t_done)
        self._served_t1 = time.monotonic()
        if self._spans is not None:
            # the query lane: batch-level spans on THIS worker thread,
            # interleaved with the engine's ingest folds on the shared
            # perf_counter clock in one perfetto trace
            t_end = time.perf_counter_ns()
            n = len(items)
            self._spans.add("query_assembly", t_exit,
                            t_submit - t_exit, cat="query",
                            args={"queries": n})
            self._spans.add("query_dispatch", t_submit,
                            t_done - t_submit, cat="query",
                            args={"queries": n, "epoch": epoch})
            self._spans.add("query_reply", t_done, t_end - t_done,
                            cat="query", args={"queries": n})

    @staticmethod
    def _safe_reply(reply, data: dict) -> None:
        try:
            reply(data)
        except Exception:
            pass   # a dead subscriber must not kill the worker

    # -- reporting -----------------------------------------------------
    def summary(self) -> dict:
        lats = sorted(self._lat_ring)
        st = self._state
        out = {
            "served": self.served,
            "shed": self.shed,
            "rejected": self.rejected,
            "dispatches": self.dispatches,
            "batch": self.batch,
            "queue_depth": self.depth,
            "queue_high_water": self.queue_high_water,
        }
        if self.shed_stale:
            out["shed_stale"] = self.shed_stale
        if self.max_staleness_ms is not None:
            out["max_staleness_ms"] = self.max_staleness_ms
        if st is not None:
            out["plane_epoch"] = st[4]
            stale = self.staleness_ms(st)
            if stale is not None:
                out["staleness_ms"] = round(stale, 1)
        if self._cache is not None:
            out["cache"] = self._cache.summary()
        if self._queryattr is not None:
            out["query_obs"] = self._queryattr.summary()
        if lats:
            out["p50_ms"] = round(lats[len(lats) // 2], 2)
            out["p99_ms"] = round(lats[min(len(lats) - 1,
                                           int(len(lats) * 0.99))], 2)
        if (self._served_t0 is not None and self._served_t1 is not None
                and self._served_t1 > self._served_t0 and self.served):
            out["qps"] = round(
                self.served / (self._served_t1 - self._served_t0), 1)
        # live replica gauges (scraped between summary calls they hold
        # the last reading; the sampler collector calls summary per tick)
        if self._g_staleness is not None and "staleness_ms" in out:
            self._g_staleness.set(out["staleness_ms"])
        if self._g_qps is not None and "qps" in out:
            self._g_qps.set(out["qps"])
        if self._fresh_hists is not None:
            # fleet freshness ledger: per-hop distributions over every
            # served reply + the doubling high-water; the clock block is
            # the LIVE state's offset evidence
            fr = {"hops": {hop: h.summary()
                           for hop, h in self._fresh_hists.items()},
                  "high_water_ms": round(self.freshness_high_water, 1)}
            clock = (st[6] or {}).get("clock") if st is not None else None
            if clock is not None:
                fr["clock"] = dict(clock)
            out["freshness"] = fr
        return out

    def drop_state(self) -> None:
        """Let go of the served planes (a closed replica's tensors are
        freed here, not whenever its last reference dies)."""
        with self._cv:
            self._state = None

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._hold = False
            self._cv.notify()
        self._thread.join(timeout=10.0)
