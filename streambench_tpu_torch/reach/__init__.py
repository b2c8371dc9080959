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
  shipped snapshots and dirty-row deltas;
- ``reach.oracle`` — exact set-arithmetic ground truth and a numpy
  mirror of the sketch algebra for bit-exact checks.

The replica fleet's router (``reach/router.py``) is not ported yet.
"""

from streambench_tpu_torch.reach.query import (
    batch_query,
    overlap_bound,
    query_chunks,
    union_bound,
)
from streambench_tpu_torch.reach.serve import ReachQueryServer

__all__ = [
    "ReachQueryServer",
    "batch_query",
    "overlap_bound",
    "query_chunks",
    "union_bound",
]
