"""The dimension-computation application: source -> convert -> cube ->
durable store -> pub/sub.

The port of ``streambench_tpu/dimensions/app.py``; the cube folds on the
``device`` the app is given (``cuda`` unless the caller asks for
``cpu``).  Peer of the Apex dimensional app family:

- ``ApplicationDimensionComputation`` (generator -> dimensions -> HDHT
  store, optional WebSocket query, ``:92-147``);
- ``ApplicationWithGenerator`` (in-process JSON generator source,
  ``ApplicationWithGenerator.java:22-58``);
- ``ApplicationWithDCWithoutDeserializer`` whose hermeticity flags
  ``includeRedisJoin`` / ``includeQuery`` make it runnable without Redis
  or a gateway (``:26,56-66``) — the missing join is backfilled with the
  sentinel campaign id (``DimensionTuple.java:27-34``).

The converter keeps the reference's validity semantics
(``TupleToDimensionTupleConverter``): tuples that cannot produce a
dimension row are counted, not crashed on.  Values per the schema:
``clicks`` defaults to 1 per event (``Tuple.clicks == null -> 1``,
``DimensionTuple.java:50``) and ``latency`` is ``now − event_time`` at
conversion (``getLatency``, ``:66-69``), computed vectorized per batch.
"""

from __future__ import annotations

import numpy as np
import torch

from streambench_tpu_torch.dimensions.compute import DimensionsComputation
from streambench_tpu_torch.dimensions.pubsub import PubSubServer
from streambench_tpu_torch.dimensions.schema import (DimensionalSchema,
                                                     parse_schema)
from streambench_tpu_torch.dimensions.store import DurableDimensionStore
from streambench_tpu_torch.encode.native_encoder import make_encoder
from streambench_tpu_torch.utils.ids import now_ms

# the reference's test-fallback campaign id (DimensionTuple.java:32)
SENTINEL_CAMPAIGN = "1111111111111111111"

DEFAULT_SCHEMA = {
    "keys": [{"name": "campaignId", "type": "string"}],
    "timeBuckets": ["10s"],
    "values": [
        {"name": "clicks", "type": "long", "aggregators": ["SUM"]},
        {"name": "latency", "type": "long", "aggregators": ["MAX"]},
    ],
    "dimensions": [{"combination": ["campaignId"]}],
}


class DimensionApp:
    def __init__(self, schema: DimensionalSchema | dict | None,
                 ad_to_campaign: dict[str, str],
                 store_dir: str,
                 campaigns: list[str] | None = None,
                 include_join: bool = True,
                 filter_views: bool = True,
                 pubsub: PubSubServer | None = None,
                 pubsub_topic: str = "dimensions",
                 window_slots: int = 16,
                 lateness_ms: int = 60_000,
                 batch_size: int = 8192,
                 use_native_encoder: bool = True,
                 device: torch.device | str | None = None):
        if schema is None:
            schema = DEFAULT_SCHEMA
        if isinstance(schema, dict):
            schema = parse_schema(schema)
        self.schema = schema
        self.include_join = include_join
        # FilterTuples sits upstream of the converter in the DC DAG
        # (event_type == "view" only, FilterTuples.java:47-52)
        self.filter_views = filter_views
        self.pubsub = pubsub
        self.pubsub_topic = pubsub_topic
        self.batch_size = batch_size
        self.encoder = make_encoder(ad_to_campaign, campaigns,
                                    divisor_ms=schema.time_bucket_ms,
                                    lateness_ms=lateness_ms,
                                    use_native=use_native_encoder)
        # key space: campaigns (+ sentinel as the last index)
        self.key_names = list(self.encoder.campaigns) + [SENTINEL_CAMPAIGN]
        self.sentinel_idx = len(self.key_names) - 1
        self.compute = DimensionsComputation(
            schema, num_keys=len(self.key_names),
            window_slots=window_slots, lateness_ms=lateness_ms,
            device=device)
        self.state = self.compute.init_state()
        self.store = DurableDimensionStore(
            store_dir, bucket_ms=schema.time_bucket_ms)
        self.invalid_tuples = 0   # TupleToDimensionTupleConverter role
        self.events = 0

    # ------------------------------------------------------------------
    def process_lines(self, lines: list[bytes]) -> int:
        for off in range(0, len(lines), self.batch_size):
            chunk = lines[off:off + self.batch_size]
            if chunk:
                self._process_batch(chunk)
        return len(lines)

    def _process_batch(self, chunk: list[bytes]) -> None:
        batch = self.encoder.encode(chunk, self.batch_size)
        self.invalid_tuples += len(chunk) - batch.n
        if batch.n == 0:
            return
        base = batch.base_time_ms
        if self.include_join:
            key_idx = self.encoder.join_table[batch.ad_idx]
            # unjoinable ads -> sentinel campaign, NOT dropped
            # (DimensionTuple.fromTuple backfills, DimensionTuple.java:27-34)
            key_idx = np.where(key_idx < 0, self.sentinel_idx, key_idx)
        else:
            key_idx = np.full(batch.batch_size, self.sentinel_idx, np.int32)
        valid = batch.valid
        if self.filter_views:
            valid = valid & (batch.event_type == 0)  # "view" index
        # getLatency: now - event_time, vectorized in relative ms.  The
        # reference computes it in 64-bit; device arrays are int32, so
        # replayed historical events (latency = years) clamp at int32 max
        # rather than overflow — live-stream latencies are unaffected.
        now_rel = np.int64(now_ms()) - base
        latency = np.clip(now_rel - batch.event_time.astype(np.int64),
                          0, 2**31 - 2).astype(np.int32)
        clicks = np.ones(batch.batch_size, np.int32)  # clicks null -> 1
        self.state = self.compute.step(
            self.state, key_idx.astype(np.int32), batch.event_time,
            valid, {"clicks": clicks, "latency": latency})
        self.events += batch.n

    # ------------------------------------------------------------------
    def flush(self, drain: bool = False) -> int:
        rows, self.state = self.compute.flush_closed(self.state,
                                                     drain=drain)
        if not rows:
            return 0
        base = self.encoder.base_time_ms or 0
        named = [(self.key_names[k],
                  base + wid * self.schema.time_bucket_ms, aggs)
                 for k, wid, aggs in rows]
        written = self.store.put_rows(named)
        if self.pubsub is not None:
            self.pubsub.publish(self.pubsub_topic, [
                {"campaignId": key, "bucket": bucket, **aggs}
                for key, bucket, aggs in named])
        return written

    def close(self) -> str:
        """Final drain + store close; returns the latency decile report
        (the ProcessTimeAwareStore ``logFinalLatencies`` role)."""
        self.flush(drain=True)
        report = self.store.latency.report()
        self.store.close()
        return report

    @property
    def dropped(self) -> int:
        return int(self.state.dropped)
