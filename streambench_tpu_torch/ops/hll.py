"""HyperLogLog distinct counting per (campaign, window): BASELINE config #2.

The port of ``streambench_tpu/ops/hll.py``.  Per event the update is a
scatter-max of the hash's rank (1 + its leading-zero count) into a
register plane, keyed like the exact count's cells and sharing its ring
(``windowcount.assign_windows``) and watermark.  Registers are uint8
``[C, W, R]`` (R a power of two): a rank is at most ``33 - log2(R)``, so
a byte holds it.  The hash is splitmix32 over the user id column (the
encoder's stateless crc32 ids); the estimate is the alpha_m
bias-corrected harmonic mean with linear counting at the small end.

Differences from the JAX functions, all deliberate:

- uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` after every add
  and multiply (torch has no uint32 arithmetic on every device); a
  negative int32 id wraps as JAX's ``astype(uint32)`` does.
- The register update is ``scatter_reduce_(..., "amax")`` in place on
  the plane, as the exact fold counts in place (the reference's is an
  XLA scatter, not a Pallas kernel).  torch has no scatter
  ``mode="drop"``: a row that does not count scatters rank 0 into a real
  register, which a max with a register (never below 0) leaves as it
  was.  Such rows go to register ``j`` of cell (0, 0), spread over R
  addresses so that the card's atomics do not queue on one.
- ``scan_steps*`` are Python loops of steps (eager torch has no
  ``lax.scan``).

Registers are absolute, not deltas: ``flush`` returns estimates for every
slot and zeroes only *closed* slots, and the writeback overwrites (HSET).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from streambench_tpu_torch.ops.windowcount import (
    assign_windows,
    gather_rows,
    unpack_columns,
)

_U32 = 0xFFFFFFFF


class HLLState(NamedTuple):
    """registers: ``[C, W, R]`` uint8; ring metadata as in
    ``windowcount.WindowState`` (int32)."""

    registers: torch.Tensor
    window_ids: torch.Tensor
    watermark: torch.Tensor
    dropped: torch.Tensor


def init_state(num_campaigns: int, window_slots: int,
               num_registers: int = 256,
               device: torch.device | str = "cpu") -> HLLState:
    if num_registers & (num_registers - 1):
        raise ValueError("num_registers must be a power of two")
    return HLLState(
        registers=torch.zeros((num_campaigns, window_slots, num_registers),
                              dtype=torch.uint8, device=device),
        window_ids=torch.full((window_slots,), -1, dtype=torch.int32,
                              device=device),
        watermark=torch.zeros((), dtype=torch.int32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit splitmix finalizer; the uint32 result as int64 in
    ``[0, 2^32)``.  Every product of a value below 2^32 and a constant
    below 2^31 fits int64 before its mask."""
    x = x.to(torch.int64) & _U32
    x = (x + 0x9E3779B9) & _U32
    x = ((x ^ (x >> 16)) * 0x21F0AAAD) & _U32
    x = ((x ^ (x >> 15)) * 0x735A2D97) & _U32
    return x ^ (x >> 15)


def _rank(h: torch.Tensor, p: int) -> torch.Tensor:
    """1 + leading-zero count of the top ``32 - p`` hash bits, as the
    reference computes it: the bit length through ``frexp`` of
    ``float32(w)``.  For ``p < 8`` a ``w`` past 2^24 rounds in float32
    (``2^25 - 1`` reads as bit length 26), and the port keeps that
    rounding so its registers equal the reference's."""
    w = (h >> p).to(torch.int32)
    _, exp = torch.frexp(w.to(torch.float32))
    bitlen = torch.where(w > 0, exp, 0)
    return (32 - p - bitlen + 1).to(torch.int32)


def step(state: HLLState, join_table: torch.Tensor,
         ad_idx: torch.Tensor, user_idx: torch.Tensor,
         event_type: torch.Tensor, event_time: torch.Tensor,
         valid: torch.Tensor, *, divisor_ms: int = 10_000,
         lateness_ms: int = 60_000, view_type: int = 0) -> HLLState:
    """Fold one micro-batch: ``registers[campaign, slot, j] =
    max(., rank)``, in place."""
    C, W, R = state.registers.shape
    p = R.bit_length() - 1

    campaign = gather_rows(join_table, ad_idx)
    wid = torch.div(event_time, divisor_ms, rounding_mode="floor")
    wanted = valid & (event_type == view_type) & (campaign >= 0)

    slot, count_mask, window_ids, watermark = assign_windows(
        state.window_ids, state.watermark, wid, wanted, valid, event_time,
        divisor_ms=divisor_ms, lateness_ms=lateness_ms)

    h = splitmix32(user_idx)
    j = h & (R - 1)
    rank = _rank(h, p)

    flat = torch.where(
        count_mask, (campaign.to(torch.int64) * W + slot) * R + j, j)
    value = torch.where(count_mask, rank, 0).to(state.registers.dtype)
    state.registers.view(-1).scatter_reduce_(0, flat, value, "amax",
                                             include_self=True)

    dropped = state.dropped + (wanted.sum(dtype=torch.int32)
                               - count_mask.sum(dtype=torch.int32))
    return HLLState(state.registers, window_ids, watermark, dropped)


def estimate(registers: torch.Tensor) -> torch.Tensor:
    """Distinct-count estimates over the last axis (float32).

    ``alpha_m * R^2 / sum(2^-M)``, with linear counting below ``2.5 R``
    while empty registers remain (Flajolet et al. 2007)."""
    R = registers.shape[-1]
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(
        R, 0.7213 / (1 + 1.079 / R))
    inv = torch.exp2(-registers.to(torch.float32)).sum(-1)
    # a Python scalar over a tensor is reciprocal-then-multiply in torch
    # (two roundings); a float32 0-dim numerator divides as JAX does
    raw = inv.new_tensor(alpha * R * R) / inv
    zeros = (registers == 0).to(torch.float32).sum(-1)
    linear = R * torch.log(torch.where(
        zeros > 0, inv.new_tensor(R) / torch.clamp(zeros, min=1.0), 1.0))
    return torch.where((raw <= 2.5 * R) & (zeros > 0), linear, raw)


def merge(a: HLLState, b: HLLState) -> HLLState:
    """Union of two partial states over one ring assignment: the
    elementwise register max (slot ids are taken from ``a``)."""
    if (a.registers.shape != b.registers.shape
            or a.registers.dtype != b.registers.dtype):
        raise ValueError(
            f"hll.merge: geometry mismatch — a.registers "
            f"{tuple(a.registers.shape)}/{a.registers.dtype} vs "
            f"b.registers {tuple(b.registers.shape)}/{b.registers.dtype}")
    if a.window_ids.shape != b.window_ids.shape:
        raise ValueError(
            f"hll.merge: window-ring mismatch — a.window_ids "
            f"{tuple(a.window_ids.shape)} vs b.window_ids "
            f"{tuple(b.window_ids.shape)}")
    return HLLState(
        registers=torch.maximum(a.registers, b.registers),
        window_ids=a.window_ids,
        watermark=torch.maximum(a.watermark, b.watermark),
        dropped=a.dropped + b.dropped)


def flush(state: HLLState, *, divisor_ms: int = 10_000,
          lateness_ms: int = 60_000):
    """``(estimates [C, W], window_ids [W], new_state)``: estimates of
    every slot; registers of *closed* slots (watermark past end +
    lateness) zeroed and their slots freed.  Open slots keep their
    registers: estimates are absolute, not deltas."""
    est = estimate(state.registers)
    closed = ((state.window_ids + 1) * divisor_ms + lateness_ms
              <= state.watermark)
    freed = closed | (state.window_ids < 0)
    new_ids = torch.where(freed, -1, state.window_ids)
    regs = torch.where(freed[None, :, None], 0, state.registers).to(
        state.registers.dtype)
    return est, state.window_ids, HLLState(
        regs, new_ids, state.watermark, state.dropped)


def scan_steps(state: HLLState, join_table: torch.Tensor,
               ad_idx: torch.Tensor, user_idx: torch.Tensor,
               event_type: torch.Tensor, event_time: torch.Tensor,
               valid: torch.Tensor, *, divisor_ms: int = 10_000,
               lateness_ms: int = 60_000, view_type: int = 0) -> HLLState:
    """Fold ``[N, B]`` stacked micro-batches, one ``step`` per row."""
    for k in range(ad_idx.shape[0]):
        state = step(state, join_table, ad_idx[k], user_idx[k],
                     event_type[k], event_time[k], valid[k],
                     divisor_ms=divisor_ms, lateness_ms=lateness_ms,
                     view_type=view_type)
    return state


def scan_steps_packed(state: HLLState, join_table: torch.Tensor,
                      packed: torch.Tensor, user_idx: torch.Tensor,
                      event_time: torch.Tensor, *,
                      divisor_ms: int = 10_000, lateness_ms: int = 60_000,
                      view_type: int = 0) -> HLLState:
    """``scan_steps`` over the packed wire word
    (``windowcount.pack_columns``) plus the user ids: 12 B an event."""
    for k in range(packed.shape[0]):
        a, e, v = unpack_columns(packed[k])
        state = step(state, join_table, a, user_idx[k], e, event_time[k],
                     v, divisor_ms=divisor_ms, lateness_ms=lateness_ms,
                     view_type=view_type)
    return state
