"""The exact-count fold on device: per-(campaign, window) view counting.

The port of ``streambench_tpu/ops/windowcount.py``: the fold, the dense
drain, and the large-key-space drains (touched rows and on-device
compaction of the nonzero cells).  Per micro-batch, in tensor terms::

    campaign = join_table[ad_idx]            # the Redis-join, as a gather
    wid      = event_time // divisor         # 10 s tumbling window id
    mask     = valid & (event_type == VIEW) & (campaign >= 0) & not-too-late
    counts[campaign, wid % W] += mask        # keyed count (K1)

State is a ring of W open windows (``window_ids[slot]`` tags the absolute
window in each slot; newer windows claim slots from older ones by a
masked scatter-max).  Counts are deltas since the last flush.  Everything
is int32, as in the JAX package, so states compare bit for bit.

Differences from the JAX functions, all deliberate:

- ``step`` and its callers update ``state.counts`` IN PLACE (the count
  kernel adds into it) and return a state holding the same counts tensor;
  the input state must not be reused.  ``flush_deltas`` therefore hands
  back the old counts tensor and puts a NEW zeroed one in the state, so a
  parked drain never sees later steps or a zeroing.
- The scan is a Python loop of steps: PyTorch runs eagerly and has no
  ``lax.scan``.
- Gathers are kept in range explicitly (``gather_rows``: a negative
  index wraps by the table's length, then every index is clamped into
  it, which is what JAX's gather does), because a CUDA gather out of
  range faults instead of clamping.
- ``apply_count`` has four methods: ``"scatter"``, the plain PyTorch
  version; ``"kernel"``, the hand-written CUDA kernel (``ops.count``; on
  a CPU tensor it runs the plain version); and the reference's
  ``"onehot"`` and ``"matmul"`` arms as torch ops, which
  ``ops.methodbench`` measures beside the other two.  The engine's
  method on the card stays ``"kernel"``: the table reports and does not
  switch the engine.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from streambench_tpu_torch.ops.count import count_cells, count_cells_plain

# "minus infinity" for int32 maxes, as in the JAX package.
NEG = -2_000_000_000

METHODS = ("scatter", "kernel", "onehot", "matmul")


class WindowState(NamedTuple):
    """Device-resident window state (all int32 tensors).

    counts:     [C, W] view-count deltas since last flush
    window_ids: [W]    relative window id per ring slot; -1 empty
    watermark:  []     max valid event_time seen (relative ms)
    dropped:    []     events lost to lateness / ring eviction
    """

    counts: torch.Tensor
    window_ids: torch.Tensor
    watermark: torch.Tensor
    dropped: torch.Tensor


def init_state(num_campaigns: int, window_slots: int,
               device: torch.device | str = "cpu") -> WindowState:
    return WindowState(
        counts=torch.zeros((num_campaigns, window_slots), dtype=torch.int32,
                           device=device),
        window_ids=torch.full((window_slots,), -1, dtype=torch.int32,
                              device=device),
        watermark=torch.zeros((), dtype=torch.int32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


def state_from_numpy(arrays, device: torch.device | str = "cpu"
                     ) -> WindowState:
    """Build a state from four host arrays ``(counts, window_ids,
    watermark, dropped)`` — e.g. a JAX ``WindowState`` pulled to numpy —
    so both implementations can continue from the same mid-stream ring."""
    counts, window_ids, watermark, dropped = (
        np.asarray(a, np.int32) for a in arrays)
    return WindowState(*(torch.from_numpy(np.array(a)).to(device)
                         for a in (counts, window_ids, watermark, dropped)))


def state_to_numpy(state: WindowState) -> WindowState:
    """The state's four fields as numpy int32 arrays (same field names)."""
    return WindowState(*(t.detach().cpu().numpy() for t in state))


def assign_windows(window_ids: torch.Tensor, watermark: torch.Tensor,
                   wid: torch.Tensor, wanted: torch.Tensor,
                   valid: torch.Tensor, event_time: torch.Tensor, *,
                   divisor_ms: int, lateness_ms: int):
    """Lateness mask, ring-slot claim, ownership.  Returns
    ``(slot, count_mask, new_window_ids, new_watermark)``."""
    W = window_ids.shape[0]
    batch_max = torch.where(valid, event_time, NEG).max()
    new_watermark = torch.maximum(watermark, batch_max)

    # Lateness against the watermark AS OF BATCH START; floor division
    # (toward -inf), as JAX's // on int32: min_wid starts at -6.
    min_wid = torch.div(watermark - lateness_ms, divisor_ms,
                        rounding_mode="floor")
    mask = wanted & (wid >= min_wid) & (wid >= 0)

    # Python-style modulo (never fmod): masked rows with wid < 0 still
    # index new_window_ids[slot] below, so slot must stay in [0, W).
    slot = torch.remainder(wid, W)
    slot_or_pad = torch.where(mask, slot, W).to(torch.int64)
    padded_ids = torch.cat([window_ids, window_ids.new_full((1,), -1)])
    padded_ids.scatter_reduce_(0, slot_or_pad, wid, "amax",
                               include_self=True)
    new_window_ids = padded_ids[:W]

    owns = new_window_ids[slot] == wid
    count_mask = mask & owns
    return slot, count_mask, new_window_ids, new_watermark


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` as JAX's gather reads it: a negative index counts
    from the end (``idx + n``), then every index is clamped into
    ``[0, n)``.  The one copy of that rule for every gather-join of the
    port: a CUDA gather out of range faults instead of clamping."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


def apply_count(counts: torch.Tensor, campaign: torch.Tensor,
                slot: torch.Tensor, count_mask: torch.Tensor,
                method: str) -> torch.Tensor:
    """``counts[campaign, slot] += 1`` for masked rows, in place.

    The four arms are bit-identical (tested against the JAX package's
    ``apply_count``).  ``onehot`` and ``matmul`` are the reference's
    arms as torch ops: their operands grow with ``B * C * W`` and
    ``B * C``, so ``ops.methodbench`` skips them where they would not
    fit."""
    if method == "scatter":
        return count_cells_plain(counts, campaign, slot, count_mask)
    if method == "kernel":
        return count_cells(counts, campaign, slot, count_mask)
    C, W = counts.shape
    if method == "onehot":
        flat = torch.where(count_mask, campaign * W + slot, C * W)
        onehot = flat[:, None] == torch.arange(
            C * W, dtype=flat.dtype, device=flat.device)[None, :]
        # a float32 sum of ones is exact up to 2^24 rows
        delta = onehot.to(torch.float32).sum(0).to(torch.int32)
        return counts.add_(delta.view(C, W))
    if method == "matmul":
        # Rows that do not count get an all-zero campaign one-hot row,
        # which zeroes their whole outer product.  A float32 product is
        # exact only while every count stays below 2^24 and only in full
        # float32: torch.backends.cuda.matmul.allow_tf32 stays False
        # (PyTorch's default), since TF32 keeps 10 bits of mantissa.
        if counts.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise ValueError("apply_count(method='matmul') needs "
                             "torch.backends.cuda.matmul.allow_tf32 False")
        camp_oh = ((campaign[:, None] == torch.arange(
            C, dtype=campaign.dtype, device=campaign.device)[None, :])
            & count_mask[:, None]).to(torch.float32)            # [B, C]
        slot_oh = (slot[:, None] == torch.arange(
            W, dtype=slot.dtype, device=slot.device)[None, :]
            ).to(torch.float32)                                  # [B, W]
        return counts.add_((camp_oh.T @ slot_oh).to(torch.int32))
    raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")


def step(state: WindowState, join_table: torch.Tensor,
         ad_idx: torch.Tensor, event_type: torch.Tensor,
         event_time: torch.Tensor, valid: torch.Tensor, *,
         divisor_ms: int = 10_000, lateness_ms: int = 60_000,
         view_type: int = 0, method: str = "scatter") -> WindowState:
    """Fold one micro-batch into the window state (counts in place)."""
    campaign = gather_rows(join_table, ad_idx)
    wid = torch.div(event_time, divisor_ms, rounding_mode="floor")
    wanted = valid & (event_type == view_type) & (campaign >= 0)

    slot, count_mask, window_ids, watermark = assign_windows(
        state.window_ids, state.watermark, wid, wanted, valid, event_time,
        divisor_ms=divisor_ms, lateness_ms=lateness_ms)

    counts = apply_count(state.counts, campaign, slot, count_mask, method)

    dropped = state.dropped + (wanted.sum(dtype=torch.int32)
                               - count_mask.sum(dtype=torch.int32))
    return WindowState(counts, window_ids, watermark, dropped)


def _still_open(window_ids: torch.Tensor, watermark: torch.Tensor,
                divisor_ms: int, lateness_ms: int) -> torch.Tensor:
    """Free ring slots of closed windows (watermark passed end+lateness)."""
    closed = (window_ids + 1) * divisor_ms + lateness_ms <= watermark
    return torch.where(closed | (window_ids < 0), -1, window_ids)


def flush_deltas(state: WindowState, *, divisor_ms: int = 10_000,
                 lateness_ms: int = 60_000
                 ) -> tuple[torch.Tensor, torch.Tensor, WindowState]:
    """Drain count deltas for the host flusher.

    Returns ``(delta_counts [C,W], window_ids [W], new_state)``.  The
    deltas ARE the old counts tensor; the new state gets a fresh zeroed
    one (never ``zero_()`` in place: a parked drain still reads the old
    tensor) and frees the ring slots of closed windows."""
    new_state = WindowState(
        counts=torch.zeros_like(state.counts),
        window_ids=_still_open(state.window_ids, state.watermark,
                               divisor_ms, lateness_ms),
        watermark=state.watermark,
        dropped=state.dropped,
    )
    return state.counts, state.window_ids, new_state


# ----------------------------------------------------------------------
# Large-key-space drains.  At C = 1e6, W = 64 the [C, W] block is 256 MB
# and almost all zeros, so these drains hand the host only the nonzero
# cells as (flat_idx, count) pairs, at most ``cap`` of them.  Every op
# below is dispatched without a host synchronisation: shapes are fixed by
# the inputs and ``cap``, and ``nnz`` stays a device tensor.

def _nonzero_capped(flat: torch.Tensor, cap: int):
    """``(idx [cap] int32, vals [cap], nnz int32 [])``: the first ``cap``
    indices of ``flat > 0`` in ascending order, zero-padded, their values,
    and how many there are in all: ``jnp.nonzero(flat > 0, size=cap,
    fill_value=0)`` and ``jnp.count_nonzero(flat)`` for counts, which are
    never negative.

    Never ``torch.nonzero``, whose output shape makes it wait for the
    device.  Each counted cell writes its flat index to its rank among
    the counted cells; cells ranked past ``cap`` and uncounted cells all
    write to one extra slot that is thrown away."""
    n = flat.shape[0]
    mask = flat > 0
    counted = torch.cumsum(mask, 0, dtype=torch.int32) - mask.int()
    dest = torch.where(mask & (counted < cap), counted, cap)
    slots = torch.zeros(cap + 1, dtype=torch.int32, device=flat.device)
    slots.index_put_((dest,), torch.arange(n, dtype=torch.int32,
                                           device=flat.device))
    idx = slots[:cap]
    # the cells at idx (padding reads cell 0, as the JAX op's does)
    vals = flat[idx] if n else flat.new_zeros(cap)
    return idx, vals, mask.sum(dtype=torch.int32)


def flush_deltas_compact(state: WindowState, *, cap: int,
                         divisor_ms: int = 10_000,
                         lateness_ms: int = 60_000):
    """``flush_deltas`` with the nonzero cells compacted on the device.

    Returns ``(flat_idx [cap], counts [cap], nnz, dense, window_ids,
    new_state)`` with ``flat_idx = campaign * W + slot``; entries past
    ``nnz`` are padding.  When ``nnz > cap`` the pairs are incomplete and
    the caller reads ``dense``: the counts tensor as it was before the
    drain (the new state holds a fresh zeroed one, as in
    ``flush_deltas``)."""
    flat = state.counts.reshape(-1)
    idx, vals, nnz = _nonzero_capped(flat, cap)
    dense, wids, new_state = flush_deltas(
        state, divisor_ms=divisor_ms, lateness_ms=lateness_ms)
    return idx, vals, nnz, dense, wids, new_state


def flush_deltas_rows_compact(state: WindowState, rows: torch.Tensor,
                              nrow, *, cap: int, divisor_ms: int = 10_000,
                              lateness_ms: int = 60_000):
    """Touched-rows drain with the nonzero cells compacted on the device.

    Gathers ``sub = counts[rows]`` (a copy), compacts its cells and zeroes
    the touched rows of the live counts in place; the drain reads only
    ``sub``, so no parked drain ever sees the zeroing.  ``flat_idx``
    indexes the gathered block: ``campaign = rows[flat_idx // W]``,
    ``slot = flat_idx % W``.  Rows at or past ``nrow`` (a host int) are
    padding (the JAX op pads ``rows`` with zeros to one fixed size);
    their cells are masked out so they do not count campaign 0 again.
    The engine passes exactly ``nrow`` rows, so it skips the mask.
    ``nnz > cap`` means
    the pairs are incomplete and the caller reads ``sub``.  Returns
    ``(idx [cap], vals [cap], nnz, sub [R, W], window_ids, new_state)``."""
    sub = state.counts[rows]
    flat = sub.reshape(-1)
    if nrow < rows.shape[0]:
        keep = (torch.arange(rows.shape[0], device=rows.device)
                < nrow)[:, None]
        flat = torch.where(keep, sub, 0).reshape(-1)
    idx, vals, nnz = _nonzero_capped(flat, cap)
    _, wids, new_state = _zero_rows(state, rows, divisor_ms, lateness_ms)
    return idx, vals, nnz, sub, wids, new_state


def _zero_rows(state: WindowState, rows: torch.Tensor,
               divisor_ms: int, lateness_ms: int):
    """Zero ``rows`` of the counts in place and free closed slots."""
    new_state = WindowState(
        counts=state.counts.index_fill_(0, rows, 0),
        window_ids=_still_open(state.window_ids, state.watermark,
                               divisor_ms, lateness_ms),
        watermark=state.watermark,
        dropped=state.dropped,
    )
    return None, state.window_ids, new_state


def flush_free_slots(state: WindowState, *, divisor_ms: int = 10_000,
                     lateness_ms: int = 60_000) -> WindowState:
    """Slot-free-only drain: nothing was counted since the last drain, so
    the counts pass through untouched and only closed ring slots are
    freed."""
    return WindowState(state.counts,
                       _still_open(state.window_ids, state.watermark,
                                   divisor_ms, lateness_ms),
                       state.watermark, state.dropped)


def flush_rows_zero(state: WindowState, rows: torch.Tensor, *,
                    divisor_ms: int = 10_000, lateness_ms: int = 60_000):
    """The zero-and-free half of a touched-rows drain, for callers that
    already copied the touched rows out (the CPU engine reads them
    through a numpy view).  Returns ``(window_ids, new_state)``."""
    _, wids, new_state = _zero_rows(state, rows, divisor_ms, lateness_ms)
    return wids, new_state


# ----------------------------------------------------------------------
# Packed transfer format: (ad_idx, event_type, valid) travel as ONE int32
# word per event.  Layout: bits 0..27 ad_idx (< 2^28 ads), bits 28..29
# event_type + 1 (domain {-1, 0, 1, 2}), bit 30 valid.
PACK_AD_BITS = 28
PACK_AD_MAX = 1 << PACK_AD_BITS


def pack_columns(ad_idx: np.ndarray, event_type: np.ndarray,
                 valid: np.ndarray) -> np.ndarray:
    """Host-side (numpy) packing; inverse of ``unpack_columns``.

    Domain-checked: an ``ad_idx`` outside [0, PACK_AD_MAX) or an
    ``event_type`` outside {-1..2} would bleed into the neighboring bit
    fields, so it raises instead."""
    if ad_idx.size:
        if int(ad_idx.min()) < 0 or int(ad_idx.max()) >= PACK_AD_MAX:
            raise ValueError(
                f"pack_columns: ad_idx outside [0, {PACK_AD_MAX}): "
                f"[{int(ad_idx.min())}, {int(ad_idx.max())}]")
        if int(event_type.min()) < -1 or int(event_type.max()) > 2:
            raise ValueError(
                "pack_columns: event_type outside [-1, 2]: "
                f"[{int(event_type.min())}, {int(event_type.max())}]")
    return (ad_idx.astype(np.int32)
            | ((event_type.astype(np.int32) + 1) << PACK_AD_BITS)
            | (valid.astype(np.int32) << (PACK_AD_BITS + 2)))


def unpack_columns(packed: torch.Tensor):
    """``(ad_idx, event_type, valid)`` bit-identical to what
    ``pack_columns`` consumed (given the documented domains)."""
    ad = packed & (PACK_AD_MAX - 1)
    etype = ((packed >> PACK_AD_BITS) & 3) - 1
    valid = ((packed >> (PACK_AD_BITS + 2)) & 1).bool()
    return ad, etype, valid


def step_packed(state: WindowState, join_table: torch.Tensor,
                packed: torch.Tensor, event_time: torch.Tensor, *,
                divisor_ms: int = 10_000, lateness_ms: int = 60_000,
                view_type: int = 0, method: str = "scatter") -> WindowState:
    """``step`` consuming the packed wire word (see ``pack_columns``)."""
    ad_idx, event_type, valid = unpack_columns(packed)
    return step(state, join_table, ad_idx, event_type, event_time, valid,
                divisor_ms=divisor_ms, lateness_ms=lateness_ms,
                view_type=view_type, method=method)


def scan_steps_packed(state: WindowState, join_table: torch.Tensor,
                      packed: torch.Tensor, event_time: torch.Tensor, *,
                      divisor_ms: int = 10_000, lateness_ms: int = 60_000,
                      view_type: int = 0,
                      method: str = "scatter") -> WindowState:
    """``step_packed`` over each row of ``[N, B]`` packed words + times."""
    for k in range(packed.shape[0]):
        state = step_packed(state, join_table, packed[k], event_time[k],
                            divisor_ms=divisor_ms, lateness_ms=lateness_ms,
                            view_type=view_type, method=method)
    return state


def scan_steps(state: WindowState, join_table: torch.Tensor,
               ad_idx: torch.Tensor, event_type: torch.Tensor,
               event_time: torch.Tensor, valid: torch.Tensor, *,
               divisor_ms: int = 10_000, lateness_ms: int = 60_000,
               view_type: int = 0, method: str = "scatter") -> WindowState:
    """Fold ``[N, B]`` stacked micro-batches, one ``step`` per row."""
    for k in range(ad_idx.shape[0]):
        state = step(state, join_table, ad_idx[k], event_type[k],
                     event_time[k], valid[k], divisor_ms=divisor_ms,
                     lateness_ms=lateness_ms, view_type=view_type,
                     method=method)
    return state
