"""Sliding (hopping) windows: size S x slide, as S tumbling memberships.

The port of ``streambench_tpu/ops/sliding.py`` (BASELINE config #3's
windowing, 10 s windows sliding by 1 s).  An event at t belongs to the
S = size/slide windows whose ids end at floor(t/slide); the ring is
claimed with ``divisor = slide`` and an *effective lateness* of
``lateness + size - slide``, so a window closes exactly when the
watermark passes ``start + size + lateness``.

Two folds, with bit-identical window rows:

- ``step``: S ring claims per batch (``assign_windows`` once per
  membership).  ``method="scatter"`` counts each membership with the
  plain ``apply_count``; every other method sums the S masked slot
  one-hots into one ``[B, W]`` membership matrix and lands all S in one
  ``[B, C]^T @ [B, W]`` float32 product (exact below 2^24; TF32 must be
  off on the card).  The reference routes its Pallas method there too:
  the count kernel consumes (campaign, slot) pairs, not membership rows.
- ``step_sliced`` + ``flush_sliced``: per-slide *buckets* with ONE ring
  claim and ONE ``apply_count`` per batch into a ``[C, S, W]`` plane
  whose middle axis is the event's lateness class ``d`` (the event counts
  for its newest ``d + 1`` windows).  ``apply_count`` sees the plane as
  ``[C*S, W]`` with row ``campaign*S + d``, so on the card the count
  kernel K1 (``ops.count``) does the one scatter.  The drain sums each
  window's S buckets (a reversed cumulative sum over the class axis, then
  one gather per window offset) into the ``flush_deltas`` contract.

``dropped`` counts lost memberships (an event has S of them); the sliced
fold converts its event-granular drops exactly (``S * wanted - sum of
d + 1 over counted events``).  As in ``windowcount``, the count plane is
updated in place by the steps and each drain hands back the old tensor
with a fresh zeroed one in the new state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from streambench_tpu_torch.ops.windowcount import (
    NEG,
    WindowState,
    _still_open,
    apply_count,
    assign_windows,
    gather_rows,
)


def effective_lateness(size_ms: int, slide_ms: int, lateness_ms: int) -> int:
    return lateness_ms + size_ms - slide_ms


def ring_slots(num_campaigns: int, size_ms: int = 10_000,
               slide_ms: int = 1_000, lateness_ms: int = 60_000) -> int:
    """The sliding engine's ring, as the reference engine sizes it: the
    floor is lateness + size in slides plus two windows' worth, raised to
    2048 slots while C x W stays within 2^27 cells, so a catchup chunk's
    span fits the ring and the fused scan runs."""
    late_eff = effective_lateness(size_ms, slide_ms, lateness_ms)
    return max(late_eff // slide_ms + 3 * (size_ms // slide_ms),
               min(2048, (1 << 27) // max(num_campaigns, 1)))


def step(state: WindowState, join_table: torch.Tensor,
         ad_idx: torch.Tensor, event_type: torch.Tensor,
         event_time: torch.Tensor, valid: torch.Tensor, *,
         size_ms: int = 10_000, slide_ms: int = 1_000,
         lateness_ms: int = 60_000, view_type: int = 0,
         method: str = "scatter") -> WindowState:
    """Fold one micro-batch with S ring claims (the unsliced fold)."""
    if size_ms % slide_ms:
        raise ValueError("size_ms must be a multiple of slide_ms")
    S = size_ms // slide_ms
    late_eff = effective_lateness(size_ms, slide_ms, lateness_ms)
    C, W = state.counts.shape
    if S > W:
        raise ValueError(f"ring too small: {W} slots < {S} memberships")
    factored = method != "scatter"
    if (factored and state.counts.is_cuda
            and torch.backends.cuda.matmul.allow_tf32):
        raise ValueError("sliding.step's factored product needs "
                         "torch.backends.cuda.matmul.allow_tf32 False")

    campaign = gather_rows(join_table, ad_idx)
    base_wid = torch.div(event_time, slide_ms, rounding_mode="floor")
    wanted = valid & (event_type == view_type) & (campaign >= 0)
    n_wanted = wanted.sum(dtype=torch.int32)

    counts = state.counts
    ids = state.window_ids
    dropped = state.dropped
    watermark = state.watermark
    membership = None
    slots = (torch.arange(W, dtype=torch.int32, device=counts.device)
             if factored else None)
    for k in range(S):
        slot, count_mask, ids, watermark = assign_windows(
            ids, state.watermark, base_wid - k, wanted, valid, event_time,
            divisor_ms=slide_ms, lateness_ms=late_eff)
        if factored:
            oh = (slot[:, None] == slots) & count_mask[:, None]   # [B, W]
            membership = oh if membership is None else membership | oh
        else:
            counts = apply_count(counts, campaign, slot, count_mask,
                                 "scatter")
        dropped = dropped + (n_wanted - count_mask.sum(dtype=torch.int32))
    if factored:
        # masked rows have campaign -1: an all-zero one-hot row
        camp_oh = (campaign[:, None] == torch.arange(
            C, dtype=campaign.dtype, device=campaign.device)
        ).to(torch.float32)                                       # [B, C]
        delta = camp_oh.T @ membership.to(torch.float32)          # [C, W]
        counts = counts.add_(delta.to(torch.int32))
    return WindowState(counts, ids, watermark, dropped)


# ----------------------------------------------------------------------
# Sliced fold: one claim + one count per batch, window sums at the drain.

class SlicedWindowState(NamedTuple):
    """Sliced sliding state (all int32).

    counts:     [C, S, W] per-slide bucket deltas since the last drain,
                split by lateness class d (countable for the newest d+1
                windows; on-time events land in class S-1)
    window_ids: [W]  relative BUCKET id per ring slot; -1 empty
    watermark:  []   max valid event_time seen (relative ms)
    dropped:    []   lost memberships (the unsliced fold's convention)
    """

    counts: torch.Tensor
    window_ids: torch.Tensor
    watermark: torch.Tensor
    dropped: torch.Tensor


def init_sliced(num_campaigns: int, window_slots: int, memberships: int,
                device: torch.device | str = "cpu") -> SlicedWindowState:
    return SlicedWindowState(
        counts=torch.zeros((num_campaigns, memberships, window_slots),
                           dtype=torch.int32, device=device),
        window_ids=torch.full((window_slots,), -1, dtype=torch.int32,
                              device=device),
        watermark=torch.zeros((), dtype=torch.int32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


def _sliced_geometry(state: SlicedWindowState, size_ms: int,
                     slide_ms: int) -> tuple[int, int, int]:
    if size_ms % slide_ms:
        raise ValueError("size_ms must be a multiple of slide_ms")
    S = size_ms // slide_ms
    C, Sp, W = state.counts.shape
    if Sp != S:
        raise ValueError(
            f"sliced plane carries {Sp} lateness classes, geometry "
            f"needs S={S}")
    if S > W:
        raise ValueError(f"ring too small: {W} slots < {S} memberships")
    return C, S, W


def step_sliced_core(state: SlicedWindowState, join_table: torch.Tensor,
                     ad_idx: torch.Tensor, event_type: torch.Tensor,
                     event_time: torch.Tensor, valid: torch.Tensor, *,
                     size_ms: int, slide_ms: int, lateness_ms: int,
                     view_type: int = 0,
                     method: str = "scatter") -> SlicedWindowState:
    """ONE ring claim on per-slide buckets and ONE ``apply_count`` into
    the ``[C*S, W]`` view of the class plane (K1 with
    ``method="kernel"``); rows that do not count carry row
    ``campaign*S + d`` < 0 for campaign -1 and count nowhere."""
    C, S, W = _sliced_geometry(state, size_ms, slide_ms)
    late_eff = effective_lateness(size_ms, slide_ms, lateness_ms)

    campaign = gather_rows(join_table, ad_idx)
    bid = torch.div(event_time, slide_ms, rounding_mode="floor")
    wanted = valid & (event_type == view_type) & (campaign >= 0)

    slot, count_mask, ids, watermark = assign_windows(
        state.window_ids, state.watermark, bid, wanted, valid, event_time,
        divisor_ms=slide_ms, lateness_ms=late_eff)

    # lateness class against the batch-start watermark, as the unsliced
    # fold's per-membership masks judge it
    min_open = torch.clamp(torch.div(state.watermark - late_eff, slide_ms,
                                     rounding_mode="floor"), min=0)
    d = torch.clamp(bid - min_open, 0, S - 1)

    row = campaign * S + d
    counts = apply_count(state.counts.view(C * S, W), row, slot,
                         count_mask, method).view(C, S, W)

    counted = torch.where(count_mask, d + 1, 0).sum(dtype=torch.int32)
    dropped = state.dropped + (S * wanted.sum(dtype=torch.int32) - counted)
    return SlicedWindowState(counts, ids, watermark, dropped)


def step_sliced(state: SlicedWindowState, join_table: torch.Tensor,
                ad_idx: torch.Tensor, event_type: torch.Tensor,
                event_time: torch.Tensor, valid: torch.Tensor, *,
                size_ms: int = 10_000, slide_ms: int = 1_000,
                lateness_ms: int = 60_000, view_type: int = 0,
                method: str = "scatter") -> SlicedWindowState:
    """Fold one micro-batch into the sliced bucket plane."""
    return step_sliced_core(state, join_table, ad_idx, event_type,
                            event_time, valid, size_ms=size_ms,
                            slide_ms=slide_ms, lateness_ms=lateness_ms,
                            view_type=view_type, method=method)


def flush_sliced_core(state: SlicedWindowState, *, size_ms: int,
                      slide_ms: int, lateness_ms: int):
    """Windowed prefix sum over the ring: the window anchored at slot
    ``s`` takes, at each offset ``k``, the class ``>= k`` counts of the
    bucket in slot ``(s + k) % W``; its id is the largest consistent
    candidate ``bucket_id[(s + k) % W] - k``, and buckets outside the
    window (evicted or wrapped slots) are masked out.  The reference's
    two loops over k are one ``[S, W]`` gather here (integer sums, so
    the result is the same bit for bit)."""
    C, S, W = _sliced_geometry(state, size_ms, slide_ms)
    late_eff = effective_lateness(size_ms, slide_ms, lateness_ms)
    ids = state.window_ids
    dev = ids.device

    # rcum[:, k, :] = counts of lateness class >= k
    rcum = torch.cumsum(state.counts.flip(1), 1,
                        dtype=torch.int32).flip(1)

    k = torch.arange(S, dtype=torch.int32, device=dev)[:, None]     # [S, 1]
    idx = (torch.arange(W, dtype=torch.int32, device=dev)[None, :]
           + k) % W                                                 # [S, W]
    bk = ids[idx.to(torch.int64)]
    best = torch.where(bk >= 0, bk - k, NEG).amax(0)
    wid = torch.where(best >= 0, best, -1)
    take = (bk >= 0) & (bk - k == wid[None, :]) & (wid >= 0)[None, :]
    gathered = rcum[:, k.to(torch.int64), idx.to(torch.int64)]      # [C,S,W]
    win = torch.where(take[None], gathered, 0).sum(1, dtype=torch.int32)

    new_state = SlicedWindowState(
        counts=torch.zeros_like(state.counts),
        window_ids=_still_open(ids, state.watermark, slide_ms, late_eff),
        watermark=state.watermark,
        dropped=state.dropped,
    )
    return win, wid, new_state


def flush_sliced(state: SlicedWindowState, *, size_ms: int = 10_000,
                 slide_ms: int = 1_000, lateness_ms: int = 60_000):
    """Drain window deltas from the sliced plane: ``(delta_counts [C, W],
    window_ids [W], new_state)`` in ``flush_deltas``' contract (window id
    per output slot, closed bucket slots freed, a fresh zeroed plane)."""
    return flush_sliced_core(state, size_ms=size_ms, slide_ms=slide_ms,
                             lateness_ms=lateness_ms)
