"""The dimension-computation fold: schema-driven keyed window aggregates.

The port of ``streambench_tpu/dimensions/compute.py``.  The Apex
reference computes its dimensional cube with a reflective POJO aggregator
(``DimensionsComputationFlexibleSingleSchemaPOJO``, keys campaignId+time,
aggregates SUM(clicks)/MAX(latency),
``ApplicationDimensionComputation.java:96-116``) partitioned by campaign
hash with a unifier merge (``:120,152-199``).  Here the cube is dense
tensors: each (value, aggregator) pair of the schema is one ``[K, W]``
int32 plane over (key index, window-ring slot), and a batch folds in as a
masked scatter (add / max / min / count) — the keyed shuffle is an index,
the unifier is elementwise add/max/min.

Ring/watermark semantics are shared with the exact-count engine
(``ops.windowcount.assign_windows``): buckets close when the event-time
watermark passes their end plus allowed lateness; closed buckets are
emitted with their **final** aggregate values and their slots reset to
the aggregator's identity.

Differences from the JAX functions, all deliberate:

- The presence plane and every COUNT plane are counted by the kernel K1
  (``ops.count.count_cells``) on ``[K, W]``; SUM is ``index_add_`` and
  MAX/MIN ``scatter_reduce_("amax"/"amin")``.  Each plane is the head of
  a ``[K·W + 1]`` buffer whose last element is the pad cell that rows
  which do not count scatter into (torch has no scatter ``mode="drop"``).
  Sums stay int32 and wrap as JAX's do.
- ``step`` and ``flush_closed`` update the planes IN PLACE (K1 adds in
  place) and return a state holding the same tensors: the input state
  must not be reused.  ``flush_closed`` gathers only the closed slots'
  columns on the device before the copy to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from streambench_tpu_torch.dimensions.schema import (AGGREGATORS,
                                                     DimensionalSchema)
from streambench_tpu_torch.ops.count import count_cells
from streambench_tpu_torch.ops.windowcount import assign_windows
from streambench_tpu_torch.utils.device import resolve_device

# int32 identities (the schema layer's int64 identities clamp to int32)
_IDENT32 = {"add": 0, "count": 0, "max": -(2**31) + 1, "min": 2**31 - 1}


@dataclass
class DimensionState:
    """Device state for ONE key combination (all int32 tensors)."""

    aggs: tuple[torch.Tensor, ...]   # one [K, W] per (value, aggregator)
    presence: torch.Tensor           # [K, W] events aggregated per cell
    window_ids: torch.Tensor         # [W], -1 = free slot
    watermark: torch.Tensor          # [] (relative ms)
    dropped: torch.Tensor            # []
    # the [K*W + 1] buffers whose heads are ``aggs`` (last element: the
    # pad cell of the scatters)
    padded: tuple[torch.Tensor, ...] = ()


def _padded_plane(K: int, W: int, fill: int, device) -> torch.Tensor:
    return torch.full((K * W + 1,), fill, dtype=torch.int32, device=device)


def _head(buf: torch.Tensor, K: int, W: int) -> torch.Tensor:
    return buf[:K * W].view(K, W)


class KeyInterner:
    """Host-side key -> dense index with fixed device capacity.

    The synthetic generator defaults to 1M campaigns
    (``DimensionTupleGenerateOperator.java:16``); capacity is explicit so
    device arrays stay statically shaped.  Overflow keys map to -1; the
    fold counts such rows in ``dropped`` (valid events the fixed key
    space lost)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.index: dict[str, int] = {}
        self.overflow = 0

    def intern_many(self, keys: list[str]) -> np.ndarray:
        out = np.empty(len(keys), np.int32)
        idx = self.index
        for i, k in enumerate(keys):
            v = idx.get(k)
            if v is None:
                if len(idx) >= self.capacity:
                    self.overflow += 1
                    v = -1
                else:
                    v = len(idx)
                    idx[k] = v
            out[i] = v
        return out

    def names(self) -> list[str]:
        return list(self.index)


def _fold(state: DimensionState, key_idx: torch.Tensor,
          event_time: torch.Tensor, valid: torch.Tensor, value_cols,
          *, kinds: tuple[str, ...], divisor_ms: int,
          lateness_ms: int) -> DimensionState:
    """Fold one batch into ``state``'s planes, in place."""
    K, W = state.presence.shape
    wid = torch.div(event_time, divisor_ms, rounding_mode="floor")
    wanted = valid & (key_idx >= 0)

    slot, mask, new_ids, new_wm = assign_windows(
        state.window_ids, state.watermark, wid, wanted, valid, event_time,
        divisor_ms=divisor_ms, lateness_ms=lateness_ms)
    slot = slot.to(torch.int32)

    # exact participation counter: flush emits a (key, bucket) row iff
    # presence > 0, so identity-valued aggregates (a SUM of zeros) are
    # still reported
    count_cells(state.presence, key_idx, slot, mask)
    keep = mask & (key_idx < K)
    flat = torch.where(keep, key_idx.to(torch.int64) * W + slot, K * W)
    for buf, agg, col, kind in zip(state.padded, state.aggs, value_cols,
                                   kinds):
        if kind == "add":
            buf.index_add_(0, flat, torch.where(keep, col, 0))
        elif kind == "count":
            count_cells(agg, key_idx, slot, mask)
        elif kind == "max":
            buf.scatter_reduce_(0, flat, col, "amax", include_self=True)
        elif kind == "min":
            buf.scatter_reduce_(0, flat, col, "amin", include_self=True)
        else:
            raise ValueError(f"unknown aggregator kind {kind!r}")

    # lost events: ring/lateness casualties + valid rows whose key fell
    # outside the fixed key space (KeyInterner overflow maps them to -1)
    dropped = state.dropped + (wanted.sum(dtype=torch.int32)
                               - mask.sum(dtype=torch.int32)
                               + (valid & (key_idx < 0)).sum(
                                   dtype=torch.int32))
    return DimensionState(state.aggs, state.presence, new_ids, new_wm,
                          dropped, state.padded)


def _flush_closed(window_ids: torch.Tensor, watermark: torch.Tensor, *,
                  divisor_ms: int, lateness_ms: int,
                  drain: bool = False) -> torch.Tensor:
    """``[W]`` bool: the slots to emit and free."""
    if drain:  # job close: every occupied slot is final now
        return window_ids >= 0
    return ((window_ids >= 0) &
            ((window_ids + 1) * divisor_ms + lateness_ms <= watermark))


class DimensionsComputation:
    """Schema-driven aggregation over one key combination, on ``device``
    (``cuda`` unless the caller asks for ``cpu``)."""

    def __init__(self, schema: DimensionalSchema, num_keys: int,
                 window_slots: int = 16, lateness_ms: int = 60_000,
                 combination: tuple[str, ...] | None = None,
                 device: torch.device | str | None = None):
        schema.validate()
        self.device = resolve_device(device)
        self.schema = schema
        self.combination = combination or schema.combinations[0]
        self.divisor_ms = schema.time_bucket_ms
        self.lateness_ms = lateness_ms
        self.K = num_keys
        self.W = window_slots
        self.slots = schema.aggregate_slots()   # [(value, agg)]
        self.kinds = tuple(AGGREGATORS[a][0] for _, a in self.slots)
        # value column order the fold expects (one per slot; a value
        # aggregated two ways is passed twice)
        self.value_order = [v for v, _ in self.slots]

    def init_state(self) -> DimensionState:
        K, W, dev = self.K, self.W, self.device
        padded = tuple(_padded_plane(K, W, _IDENT32[k], dev)
                       for k in self.kinds)
        return DimensionState(
            aggs=tuple(_head(b, K, W) for b in padded),
            presence=torch.zeros((K, W), dtype=torch.int32, device=dev),
            window_ids=torch.full((W,), -1, dtype=torch.int32, device=dev),
            watermark=torch.zeros((), dtype=torch.int32, device=dev),
            dropped=torch.zeros((), dtype=torch.int32, device=dev),
            padded=padded,
        )

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    def step(self, state: DimensionState, key_idx, event_time, valid,
             values: dict[str, np.ndarray]) -> DimensionState:
        """Fold one batch, in place.  ``values`` maps value-field name ->
        [B] int32 column (relative ms for time-like fields)."""
        cols = {name: self._on_device(np.asarray(values[name], np.int32))
                for name in set(self.value_order)}
        return _fold(
            state, self._on_device(np.asarray(key_idx, np.int32)),
            self._on_device(np.asarray(event_time, np.int32)),
            self._on_device(np.asarray(valid, bool)),
            [cols[name] for name in self.value_order],
            kinds=self.kinds, divisor_ms=self.divisor_ms,
            lateness_ms=self.lateness_ms)

    def flush_closed(self, state: DimensionState, drain: bool = False
                     ) -> tuple[list[tuple[int, int, dict[str, int]]],
                                DimensionState]:
        """Emit final aggregates of closed buckets and free their slots.

        Returns ``(rows, new_state)`` where each row is
        ``(key_index, window_id, {"<value>:<AGG>": final})`` for every key
        that actually aggregated something in that bucket, in the
        reference's order (slot, then key).  ``drain=True`` (job close)
        emits every occupied slot, open or not.  The closed slots'
        columns are gathered on the device and copied to the host; then
        the slots are reset in place.
        """
        closed_dev = _flush_closed(
            state.window_ids, state.watermark, divisor_ms=self.divisor_ms,
            lateness_ms=self.lateness_ms, drain=drain)
        closed = closed_dev.cpu().numpy()
        if not closed.any():
            return [], state
        slots = np.flatnonzero(closed)
        cols = torch.from_numpy(slots).to(self.device)
        old_ids = state.window_ids.cpu().numpy()
        touched = (state.presence.index_select(1, cols) > 0).cpu().numpy()
        olds = [a.index_select(1, cols).cpu().numpy() for a in state.aggs]
        # free the slots: presence 0, each plane its identity
        state.presence.masked_fill_(closed_dev[None, :], 0)
        for agg, kind in zip(state.aggs, self.kinds):
            agg.masked_fill_(closed_dev[None, :], _IDENT32[kind])
        new_state = DimensionState(
            state.aggs, state.presence,
            torch.where(closed_dev, -1, state.window_ids),
            state.watermark, state.dropped, state.padded)
        # exact participation: a (key, bucket) row exists iff any event
        # aggregated into it — identity-valued results (SUM of zeros)
        # still emit
        rows: list[tuple[int, int, dict[str, int]]] = []
        names = [f"{v}:{a}" for v, a in self.slots]
        for j, s in enumerate(slots.tolist()):
            wid = int(old_ids[s])
            for k in np.flatnonzero(touched[:, j]).tolist():
                rows.append((k, wid, {n: int(olds[i][k, j])
                                      for i, n in enumerate(names)}))
        return rows, new_state

    @staticmethod
    def merge(a: DimensionState, b: DimensionState,
              kinds: tuple[str, ...]) -> DimensionState:
        """Unifier merge of two partials (the
        ``DimensionsComputationUnifierImpl`` role): elementwise add/max/min
        into new planes — associative, so it is also what a cross-device
        sum or max would compute.

        Merge is only sound when both partials' ring slots hold the SAME
        windows — i.e. the partials were folded over the same batch
        cadence (as the unifier's upstream partitions are).  With divergent
        watermark progress, a slot could hold window ids w1 != w2 and the
        elementwise add would silently sum two different windows'
        aggregates under ``max(w1, w2)``.  That is checked here (one tiny
        host copy): empty slots (-1) merge freely with anything.
        """
        ia = a.window_ids.cpu().numpy()
        ib = b.window_ids.cpu().numpy()
        conflict = (ia >= 0) & (ib >= 0) & (ia != ib)
        if conflict.any():
            s = int(np.flatnonzero(conflict)[0])
            raise ValueError(
                f"cannot merge partials with divergent ring contents: slot "
                f"{s} holds window {int(ia[s])} in one partial and "
                f"{int(ib[s])} in the other; merge partials only across "
                "the same batch cadence (or flush both first)")
        K, W = a.presence.shape
        padded = []
        for x, y, kind in zip(a.aggs, b.aggs, kinds):
            buf = _padded_plane(K, W, _IDENT32[kind], x.device)
            head = _head(buf, K, W)
            if kind in ("add", "count"):
                torch.add(x, y, out=head)
            elif kind == "max":
                torch.maximum(x, y, out=head)
            else:
                torch.minimum(x, y, out=head)
            padded.append(buf)
        return DimensionState(
            aggs=tuple(_head(buf, K, W) for buf in padded),
            presence=a.presence + b.presence,
            window_ids=torch.maximum(a.window_ids, b.window_ids),
            watermark=torch.maximum(a.watermark, b.watermark),
            dropped=a.dropped + b.dropped,
            padded=tuple(padded),
        )
