"""Session windows (gap-based) with carried user state: BASELINE config #4.

The port of ``streambench_tpu/ops/session.py``.  Per micro-batch:

1. sort the batch by (user, time): two stable argsorts;
2. a session boundary is a user change or an intra-user gap > ``gap_ms``
   (measured from the carried last activity where the carry merges);
   segment ids come from a cumsum over the boundary flags;
3. per-segment start, end and clicks by scatters into ``[B]`` buffers;
4. each user's last segment becomes the carried state
   ``(last_time, sess_start, clicks)[user]``; earlier segments close and
   come out as fixed-shape ``[B]`` rows with a validity mask, as does a
   carried session whose user reappears after the gap.

``flush`` closes every carried session the watermark has passed by
``gap + lateness`` (or all of them, ``force``).  Events whose user index
falls outside the ``capacity`` users, and late events, are dropped and
counted.

Differences from the JAX functions, all deliberate: torch has no scatter
``mode="drop"``, so each scatter that drops rows writes into a buffer
one element longer than the result, the dropped rows aimed at the pad
element past the end; JAX's ``cumsum`` and ``sum`` of int32 stay int32,
torch's are cast back (``sum(dtype=torch.int32)``).  The ``.set``
scatters rely on unique indices among the rows they keep (one boundary
row a segment, one open segment a user): the tests assert that, the hot
path does not.  Nothing here syncs with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from streambench_tpu_torch.ops.windowcount import NEG

I32_MAX = 2**31 - 1


class SessionState(NamedTuple):
    last_time: torch.Tensor   # [U] int32; -1 = no open session
    sess_start: torch.Tensor  # [U] int32
    clicks: torch.Tensor      # [U] int32
    watermark: torch.Tensor   # [] int32
    dropped: torch.Tensor     # [] int32


class ClosedSessions(NamedTuple):
    """Fixed-shape emission: one row per (potential) closed session."""

    user: torch.Tensor    # [N] int32
    start: torch.Tensor   # [N] int32
    end: torch.Tensor     # [N] int32
    clicks: torch.Tensor  # [N] int32
    valid: torch.Tensor   # [N] bool


def init_state(capacity: int,
               device: torch.device | str = "cpu") -> SessionState:
    i32 = dict(dtype=torch.int32, device=device)
    return SessionState(
        last_time=torch.full((capacity,), -1, **i32),
        sess_start=torch.zeros((capacity,), **i32),
        clicks=torch.zeros((capacity,), **i32),
        watermark=torch.zeros((), **i32),
        dropped=torch.zeros((), **i32),
    )


def _scatter(n: int, fill: int, dtype, index: torch.Tensor,
             src: torch.Tensor, reduce: str | None) -> torch.Tensor:
    """A ``[n]`` buffer of ``fill`` with ``src`` scattered at ``index``;
    rows whose index is ``n`` land on the pad element and are dropped.
    ``reduce`` is ``"sum"``, ``"amin"``, ``"amax"`` or None (set)."""
    buf = torch.full((n + 1,), fill, dtype=dtype, device=src.device)
    index = index.to(torch.int64)
    if reduce is None:
        buf.scatter_(0, index, src.to(dtype))
    elif reduce == "sum":
        buf.index_add_(0, index, src.to(dtype))
    else:
        buf.scatter_reduce_(0, index, src.to(dtype), reduce,
                            include_self=True)
    return buf[:n]


def step(state: SessionState, user_idx: torch.Tensor,
         event_type: torch.Tensor, event_time: torch.Tensor,
         valid: torch.Tensor, *, gap_ms: int = 30_000,
         lateness_ms: int = 60_000, click_type: int = 1
         ) -> tuple[SessionState, ClosedSessions, ClosedSessions]:
    """Fold one micro-batch; returns (state, closed_in_batch,
    closed_carry).  The input state's tensors are not modified."""
    U = state.last_time.shape[0]
    B = user_idx.shape[0]

    # lateness against the watermark as of batch start, and capacity
    min_t = state.watermark - lateness_ms
    mask = valid & (event_time >= min_t) & (user_idx >= 0) & (user_idx < U)
    batch_max = torch.where(valid, event_time, NEG).max()
    new_wm = torch.maximum(state.watermark, batch_max)
    dropped = state.dropped + (valid.sum(dtype=torch.int32)
                               - mask.sum(dtype=torch.int32))

    # sort by (user, time); masked rows sort to the end under user key U
    ukey = torch.where(mask, user_idx, U)
    order = torch.argsort(event_time, stable=True)
    order = order[torch.argsort(ukey[order], stable=True)]
    su = user_idx[order]
    st = event_time[order]
    sm = mask[order]
    sclick = (event_type[order] == click_type) & sm

    prev_su = torch.cat([su.new_full((1,), -1), su[:-1]])
    prev_st = torch.cat([st.new_zeros(1), st[:-1]])
    prev_sm = torch.cat([sm.new_zeros(1), sm[:-1]])
    same_user = sm & prev_sm & (su == prev_su)
    first_of_user = sm & ~same_user

    # the carry merges into a user's FIRST in-batch segment iff its first
    # event lies within gap_ms of the carried span on either side
    cu = torch.clamp(su, 0, U - 1).to(torch.int64)
    user_first_t = _scatter(U, I32_MAX, torch.int32,
                            torch.where(first_of_user, su, U), st, "amin")
    carry_last = state.last_time[cu]
    carry_start = state.sess_start[cu]
    first_t = user_first_t[cu]
    ucont = ((carry_last >= 0) & (first_t - carry_last <= gap_ms)
             & (carry_start - first_t <= gap_ms))          # ucont[cu]
    carry_open = first_of_user & (carry_last >= 0)
    cont_carry = first_of_user & ucont

    # the gap test measures from the carried last activity where the
    # carry merges (a late event can sort before it)
    eff_prev = torch.maximum(prev_st, torch.where(ucont, carry_last, NEG))
    boundary = first_of_user | (same_user & (st - eff_prev > gap_ms))
    seg = torch.cumsum(boundary.to(torch.int32), 0).to(torch.int32) - 1
    seg = torch.where(sm, seg, B)                       # masked -> pad

    seg_clicks = _scatter(B, 0, torch.int32, seg, sclick, "sum")
    seg_start = _scatter(B, I32_MAX, torch.int32, seg,
                         torch.where(sm, st, I32_MAX), "amin")
    seg_end = _scatter(B, NEG, torch.int32, seg, torch.where(sm, st, NEG),
                       "amax")
    # per-segment metadata from its boundary row (one a segment)
    bseg = torch.where(boundary, seg, B)
    seg_user = _scatter(B, -1, torch.int32, bseg, su, None)
    seg_cont = _scatter(B, 0, torch.bool, bseg, cont_carry, None)
    seg_exists = _scatter(B, 0, torch.bool, bseg,
                          torch.ones_like(boundary), None)

    # merge the carried session into each user's first segment; the end
    # never regresses below the carried last activity
    cseg_user = torch.clamp(seg_user, 0, U - 1).to(torch.int64)
    seg_start = torch.where(
        seg_cont, torch.minimum(seg_start, state.sess_start[cseg_user]),
        seg_start)
    seg_end = torch.where(
        seg_cont, torch.maximum(seg_end, state.last_time[cseg_user]),
        seg_end)
    seg_clicks = seg_clicks + torch.where(
        seg_cont, state.clicks[cseg_user], 0)

    # a segment closes if a later segment of the same user exists
    next_boundary_same = _scatter(
        B, 0, torch.bool, torch.where(boundary & same_user, seg - 1, B),
        torch.ones_like(boundary), None)
    seg_closed = seg_exists & next_boundary_same

    closed_in_batch = ClosedSessions(
        user=seg_user, start=seg_start, end=seg_end, clicks=seg_clicks,
        valid=seg_closed)
    # carried sessions whose user reappeared after the gap close now
    closed_carry = ClosedSessions(
        user=su, start=carry_start, end=carry_last,
        clicks=state.clicks[cu], valid=carry_open & ~cont_carry)

    # the carry becomes each user's LAST (open) segment
    seg_open = seg_exists & ~seg_closed
    open_user = torch.where(seg_open, seg_user, U).to(torch.int64)

    def carry(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        buf = torch.cat([old, old.new_zeros(1)])
        buf.scatter_(0, open_user, new)
        return buf[:U]

    new_state = SessionState(
        carry(state.last_time, seg_end), carry(state.sess_start, seg_start),
        carry(state.clicks, seg_clicks), new_wm, dropped)
    return new_state, closed_in_batch, closed_carry


def flush(state: SessionState, *, gap_ms: int = 30_000,
          lateness_ms: int = 60_000,
          force: bool = False) -> tuple[SessionState, ClosedSessions]:
    """Close sessions the watermark has passed (or all, when ``force``)."""
    U = state.last_time.shape[0]
    open_ = state.last_time >= 0
    if force:
        expired = open_
    else:
        expired = open_ & (state.watermark
                           > state.last_time + (gap_ms + lateness_ms))
    closed = ClosedSessions(
        user=torch.arange(U, dtype=torch.int32,
                          device=state.last_time.device),
        start=state.sess_start, end=state.last_time, clicks=state.clicks,
        valid=expired)
    last_time = torch.where(expired, -1, state.last_time)
    return SessionState(last_time, state.sess_start, state.clicks,
                        state.watermark, state.dropped), closed
