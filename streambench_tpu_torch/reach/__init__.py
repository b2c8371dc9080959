"""Live reach-query serving: the MinHash ∪ HLL audience-overlap engine.

The port of ``streambench_tpu/reach/``:

- ``ops/minhash.py`` — the cumulative per-campaign sketch state
  (signature + paired HLL plane), folded by ``ReachSketchEngine``;
- ``reach.query`` — ``batch_query`` evaluates a *batch* of union /
  overlap queries in one dispatch (campaign sets as a ``[Q, C]``
  membership mask);
- ``reach.serve`` — the bounded, load-shedding query server behind the
  ``dimensions.pubsub`` "reach" verb, with per-query latency histograms
  feeding the ``jax.reach.slo.p99.ms`` objective (obs/slo.py);
- ``reach.cache`` — the (epoch, campaign set) result cache;
- ``reach.replica`` / ``reach.deltaship`` — read replicas fed by
  shipped snapshots and dirty-row deltas (``--fleet``: clock offsets
  and per-reply freshness hops);
- ``reach.router`` — the freshness-aware failover router fronting a
  replica fleet: sticky by campaign set, failover in freshness order,
  honest shed;
- ``reach.oracle`` — exact set-arithmetic ground truth and a numpy
  mirror of the sketch algebra for bit-exact checks.
"""

from streambench_tpu_torch.reach.query import (
    batch_query,
    overlap_bound,
    query_chunks,
    union_bound,
)
from streambench_tpu_torch.reach.router import (
    ReachRouter,
    ReplicaHandle,
    campaign_shard,
)
from streambench_tpu_torch.reach.serve import ReachQueryServer

__all__ = [
    "ReachQueryServer",
    "ReachRouter",
    "ReplicaHandle",
    "campaign_shard",
    "batch_query",
    "overlap_bound",
    "query_chunks",
    "union_bound",
]
