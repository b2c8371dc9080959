"""Synthetic dimension-tuple source: the hardcoded-dimensions path.

The port of ``streambench_tpu/dimensions/synthetic.py``.  Peer of the
reference's synthetic generators (``DimensionTupleGenerator.java`` /
``DimensionTupleGenerateOperator.java`` — 1M random campaign ids by
default, ``:16``): emits (campaignId, eventTime, clicks) batches straight
into the dimension fold, bypassing
JSON entirely.  Because the campaign universe is huge and unknown up
front, keys go through ``KeyInterner`` — overflow beyond the configured
capacity maps to -1 and the fold counts those events as dropped.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from streambench_tpu_torch.dimensions.compute import (
    DimensionsComputation,
    KeyInterner,
)
from streambench_tpu_torch.dimensions.schema import (DimensionalSchema,
                                                     parse_schema)

SYNTH_SCHEMA = {
    "keys": [{"name": "campaignId", "type": "string"}],
    "timeBuckets": ["10s"],
    "values": [{"name": "clicks", "type": "long", "aggregators": ["SUM"]}],
    "dimensions": [{"combination": ["campaignId"]}],
}


class SyntheticDimensionSource:
    """Random (campaignId, eventTime, clicks) batches."""

    def __init__(self, num_campaigns: int = 1_000_000,
                 start_ms: int = 0, rate_per_s: int = 100_000,
                 rng: random.Random | None = None):
        self.rng = rng or random.Random(0)
        self.num_campaigns = num_campaigns
        self._t = start_ms
        self._step_us = max(1_000_000 // rate_per_s, 1)

    def next_batch(self, n: int) -> tuple[list[str], np.ndarray, np.ndarray]:
        keys = [f"campaign-{self.rng.randrange(self.num_campaigns):07d}"
                for _ in range(n)]
        times = (self._t + (np.arange(n, dtype=np.int64) * self._step_us)
                 // 1000).astype(np.int64)
        self._t = int(times[-1]) + 1
        clicks = np.ones(n, np.int32)
        return keys, times, clicks


def run_synthetic(n_events: int = 100_000, batch: int = 8192,
                  num_campaigns: int = 1_000_000,
                  key_capacity: int = 1 << 16,
                  window_slots: int = 16, lateness_ms: int = 0,
                  schema: DimensionalSchema | dict | None = None,
                  rng: random.Random | None = None,
                  device: torch.device | str | None = None):
    """Drive the fold from the synthetic source, on ``device`` (``cuda``
    unless the caller asks for ``cpu``).

    Returns ``(rows, interner, dropped)``: final aggregate rows (with
    resolved key names), the interner, and the count of events lost to
    key-capacity overflow (+ lateness, if any).
    """
    if schema is None:
        schema = SYNTH_SCHEMA
    if isinstance(schema, dict):
        schema = parse_schema(schema)
    src = SyntheticDimensionSource(num_campaigns=num_campaigns, rng=rng)
    interner = KeyInterner(key_capacity)
    dc = DimensionsComputation(schema, num_keys=key_capacity,
                               window_slots=window_slots,
                               lateness_ms=lateness_ms, device=device)
    state = dc.init_state()
    value_names = {v.name for v in schema.values}
    done = 0
    while done < n_events:
        n = min(batch, n_events - done)
        keys, times, clicks = src.next_batch(n)
        key_idx = interner.intern_many(keys)
        # source times start at start_ms (default 0) and stay well within
        # int32 ms for any realistic synthetic run (< ~24 days)
        rel_t = times.astype(np.int32)
        values = {}
        if "clicks" in value_names:
            values["clicks"] = clicks
        state = dc.step(state, key_idx, rel_t, np.ones(n, bool), values)
        done += n
    rows, state = dc.flush_closed(state, drain=True)
    names = interner.names()
    named = [(names[k], wid, aggs) for k, wid, aggs in rows]
    return named, interner, int(state.dropped)
