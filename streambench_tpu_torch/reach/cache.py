"""Reach query-result cache keyed by (epoch, canonical campaign-set,
kind).

Reach answers are pure functions of the sketch planes, and the planes
are versioned by the serving epoch: two queries over the same campaign
set against the same epoch MUST produce identical answers.  That makes
an exact result cache sound with one rule — an epoch bump invalidates
everything, wholesale (``note_epoch``), because entries keyed under an
older epoch can never be served again and would only hold memory.

The key canonicalizes the campaign selection (sorted index tuple), so
``{A, B}`` and ``{B, A}`` share an entry, and carries the query kind
(union vs overlap).  Eviction is plain LRU under a bounded capacity.

Instrumented for the serving tier's A/B:
``streambench_reach_cache_{hits,misses,evictions}_total`` counters plus
a hit-latency histogram (``streambench_reach_cache_hit_ms``: admission
-> reply of answers served straight from the cache, never touching the
queue or the device) — the bench's "cache-hit p99 >= 10x below the
cache-miss p99" acceptance reads these.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

#: shared instrument name — the serve layer observes hit latencies here
HIT_LATENCY_HIST = "streambench_reach_cache_hit_ms"

#: The reply keys that are pure functions of (epoch, campaign-set,
#: kind) and therefore sound to cache.  Everything else is REPLY-TIME
#: state and must be recomputed on every hit: the per-query ``id``, and
#: the age evidence — ``staleness_ms`` and the fleet ``freshness`` hop
#: decomposition.  A hit served with the FILL-time freshness
#: block would claim the answer is as fresh as it was minutes ago; the
#: serve layer recomputes both against the live plane stamps instead.
CACHEABLE_KEYS = ("op", "estimate", "union", "jaccard", "bound",
                  "epoch", "plane_epoch")


class ReachQueryCache:
    """Bounded LRU of reach answers, epoch-scoped.

    Thread-safe: admission threads probe (``get``) while the worker
    thread fills (``put``) and the state-push path invalidates
    (``note_epoch``).
    """

    def __init__(self, capacity: int = 4096, registry=None):
        self.capacity = max(int(capacity), 1)
        self._od: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self._epoch: int | None = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self._c_hits = self._c_misses = self._c_evict = None
        self.hit_hist = None
        if registry is not None:
            self._c_hits = registry.counter(
                "streambench_reach_cache_hits_total",
                "reach queries answered from the (epoch, campaign-set) "
                "result cache")
            self._c_misses = registry.counter(
                "streambench_reach_cache_misses_total",
                "reach cache probes that fell through to a device "
                "dispatch")
            self._c_evict = registry.counter(
                "streambench_reach_cache_evictions_total",
                "reach cache LRU evictions (capacity pressure; epoch "
                "invalidations are counted separately)")
            self.hit_hist = registry.histogram(
                HIT_LATENCY_HIST,
                "admission -> reply latency of cache-hit reach answers "
                "(ms)", lo=0.001, hi=1e5)

    @staticmethod
    def key(idx, op: str) -> tuple:
        """Canonical campaign-set key: sorted index tuple + kind."""
        return (tuple(sorted(int(i) for i in idx)), str(op))

    # ------------------------------------------------------------------
    def note_epoch(self, epoch: int) -> None:
        """The serving epoch moved: drop EVERY entry.  Old-epoch answers
        can never be served again (lookups carry the live epoch), so
        wholesale invalidation is both the correctness story the tests
        pin and the memory bound."""
        epoch = int(epoch)
        with self._lock:
            if self._epoch == epoch:
                return
            if self._od:
                self.invalidations += 1
            self._epoch = epoch
            self._od.clear()

    def get(self, epoch: int, idx, op: str) -> dict | None:
        """Probe for a cached answer under the CURRENT epoch; counts the
        hit/miss either way.  Returns the stored payload dict (shared,
        treat as immutable) or None."""
        k = self.key(idx, op)
        with self._lock:
            hit = None
            if self._epoch == int(epoch):
                hit = self._od.get(k)
                if hit is not None:
                    self._od.move_to_end(k)
            if hit is None:
                self.misses += 1
            else:
                self.hits += 1
        if hit is None:
            if self._c_misses is not None:
                self._c_misses.inc()
        elif self._c_hits is not None:
            self._c_hits.inc()
        return hit

    def put(self, epoch: int, idx, op: str, payload: dict) -> None:
        """Store one answer computed against ``epoch``; ignored when the
        cache has already moved past it (a worker racing an epoch bump
        must never resurrect stale results — the invalidation test)."""
        k = self.key(idx, op)
        evicted = 0
        with self._lock:
            if self._epoch != int(epoch):
                return
            self._od[k] = payload
            self._od.move_to_end(k)
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
                self.evictions += 1
                evicted += 1
        if evicted and self._c_evict is not None:
            self._c_evict.inc(evicted)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def summary(self) -> dict:
        with self._lock:
            hits, misses = self.hits, self.misses
            out = {
                "capacity": self.capacity,
                "entries": len(self._od),
                "hits": hits,
                "misses": misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "epoch": self._epoch,
            }
        probes = hits + misses
        out["hit_ratio"] = round(hits / probes, 4) if probes else 0.0
        return out
