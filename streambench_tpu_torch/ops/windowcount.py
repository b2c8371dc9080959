"""The exact-count fold on device: per-(campaign, window) view counting.

The port of ``streambench_tpu/ops/windowcount.py`` for the functions the
dense main path runs.  Per micro-batch, in tensor terms::

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
- Gathers are kept in range explicitly (``ad_idx`` is clamped into the
  join table, which is what JAX's gather does with an out-of-range index),
  because a CUDA gather out of range faults instead of clamping.
- ``apply_count`` has two methods: ``"scatter"``, the plain PyTorch
  version, and ``"kernel"``, the hand-written CUDA kernel (``ops.count``;
  on a CPU tensor it runs the plain version).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from streambench_tpu_torch.ops.count import count_cells, count_cells_plain

# "minus infinity" for int32 maxes, as in the JAX package.
NEG = -2_000_000_000

METHODS = ("scatter", "kernel")


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


def apply_count(counts: torch.Tensor, campaign: torch.Tensor,
                slot: torch.Tensor, count_mask: torch.Tensor,
                method: str) -> torch.Tensor:
    """``counts[campaign, slot] += 1`` for masked rows, in place."""
    if method == "scatter":
        return count_cells_plain(counts, campaign, slot, count_mask)
    if method == "kernel":
        return count_cells(counts, campaign, slot, count_mask)
    raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")


def step(state: WindowState, join_table: torch.Tensor,
         ad_idx: torch.Tensor, event_type: torch.Tensor,
         event_time: torch.Tensor, valid: torch.Tensor, *,
         divisor_ms: int = 10_000, lateness_ms: int = 60_000,
         view_type: int = 0, method: str = "scatter") -> WindowState:
    """Fold one micro-batch into the window state (counts in place)."""
    campaign = join_table[ad_idx.clamp(0, join_table.shape[0] - 1)]
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
