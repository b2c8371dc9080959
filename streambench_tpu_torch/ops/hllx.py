"""HLL "hyper extended": frequency statistics mined from register planes.

The port of ``streambench_tpu/ops/hllx.py`` (Cohen, "HyperLogLog Hyper
Extended: Sketches for Concave Sublinear Frequency Statistics",
arXiv:1607.06517).  A plain distinct-count HLL plane answers one
question; hashing, per arrival, the pair ``(key, token mod T)`` instead of
the bare key makes the distinct count of that derived stream

    D_T  =  sum over keys x of  T * (1 - (1 - 1/T)^c_x)

a smooth cap of each key's count ``c_x`` at scale ``T``.  One register
plane per rung of the ladder ``T_g = 2^g`` turns one scatter-max a batch
into the distinct count (g = 0: the token is constant, so the plane IS the
plain user HLL, bit-identical to ``ops/hll.py``'s hash), the soft-capped
counts at every ``T_g``, and the log-count moment ``sum_x log2(1 + c_x) ~
sum_g D_g / T_g`` less a calibrated per-key bias.  F1 (total views) rides
along exactly in an int32 counter.

State is cumulative per campaign: ``[C, G, R]`` registers, no window
ring.  The per-arrival token is mixed from the event time, so an exact
duplicate (same user, same ms) adds no token: at-least-once replay is
idempotent for the registers (only F1 counts a replay twice).

Differences from the JAX functions, all deliberate:

- uint32 arithmetic runs in int64 masked to 32 bits (``hll.splitmix32``);
  a negative int32 id or time wraps as JAX's ``astype(uint32)`` does.
- The fold updates the register plane (``scatter_reduce_(..., "amax")``)
  and the totals (``index_add_``) in place.  torch has no scatter
  ``mode="drop"``: a row that does not count scatters rank 0 into cell
  ``(0, g, j)``, which a max with a register (never below 0) leaves as it
  was, and adds 0 to campaign 0's total.
- The join goes through ``windowcount.gather_rows`` (wrap, then clamp).
- ``_rank`` is ``ops/hll.py``'s, which keeps the reference's float32
  rounding below p = 8 (``w = 2^25 - 1`` reads as rank 0); the engine's
  default R = 128 is p = 7, so the port keeps that fault bit for bit.
- ``scan_steps*`` are Python loops of steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from streambench_tpu_torch.ops import hll
from streambench_tpu_torch.ops.hll import _rank, splitmix32
from streambench_tpu_torch.ops.windowcount import (
    NEG,
    gather_rows,
    unpack_columns,
)

#: the salt stream's constant for the per-rung hashes (the golden-ratio
#: increment, ``minhash.salts``'s)
_SALT_GAMMA = 0x9E3779B9

_U32 = 0xFFFFFFFF

#: per-key additive bias of the octave telescope sum_g (1-(1-1/T_g)^c)
#: over log2(1+c), averaged over c in [1, 2^(G-1)]; ``moments`` subtracts
#: BIAS * distinct
LOG_MOMENT_BIAS = 1.07


class HLLXState(NamedTuple):
    """registers: ``[C, G, R]`` uint8 (rung g caps at ``T_g = 2^g``; a
    legacy int32 plane from an old snapshot still folds, the scatter
    casts to the plane's dtype); totals: ``[C]`` int32 exact wanted-event
    counts (F1); watermark: the largest valid event time folded; dropped:
    always 0 (cumulative: nothing drops)."""

    registers: torch.Tensor
    totals: torch.Tensor
    watermark: torch.Tensor
    dropped: torch.Tensor


def caps(groups: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """The cap ladder ``[G]`` int32: ``T_g = 2^g``."""
    return torch.tensor([1 << g for g in range(groups)], dtype=torch.int32,
                        device=device)


def salts(groups: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Per-rung hash salts (int64 holding uint32).  Rung 0's is unused:
    its hash is the bare user mix, so the distinct plane matches
    ``ops/hll.py`` bit for bit."""
    return splitmix32((torch.arange(1, groups + 1, dtype=torch.int64,
                                    device=device) * _SALT_GAMMA) & _U32)


def init_state(num_campaigns: int, groups: int = 8,
               num_registers: int = 128,
               device: torch.device | str = "cpu") -> HLLXState:
    if groups < 1 or groups > 24:
        raise ValueError("groups must be in [1, 24]")
    if num_registers & (num_registers - 1) or num_registers < 16:
        raise ValueError("num_registers must be a power of two >= 16")
    if num_campaigns * groups * num_registers >= 2**31:
        raise ValueError("C*G*R must fit int32 flat indices")
    return HLLXState(
        registers=torch.zeros((num_campaigns, groups, num_registers),
                              dtype=torch.uint8, device=device),
        totals=torch.zeros((num_campaigns,), dtype=torch.int32,
                           device=device),
        watermark=torch.tensor(NEG, dtype=torch.int32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device))


def step(state: HLLXState, join_table: torch.Tensor,
         ad_idx: torch.Tensor, user_idx: torch.Tensor,
         event_type: torch.Tensor, event_time: torch.Tensor,
         valid: torch.Tensor, *, view_type: int = 0) -> HLLXState:
    """Fold one micro-batch into every rung, in place: one ``[B, G]``
    hash block and one flat scatter-max, the dispatch shape of a plain
    HLL step."""
    C, G, R = state.registers.shape
    p = R.bit_length() - 1
    dev = state.registers.device

    campaign = gather_rows(join_table, ad_idx).to(torch.int64)
    wanted = valid & (event_type == view_type) & (campaign >= 0)

    hu = splitmix32(user_idx)                                   # [B]
    he = splitmix32(hu ^ splitmix32(event_time))                # [B]
    tg = he[:, None] & (caps(G, dev).to(torch.int64) - 1)[None, :]
    hg = splitmix32(hu[:, None] ^ salts(G, dev)[None, :] ^ tg)  # [B, G]
    # rung 0 is the bare key: bit-identical to the ops/hll.py hash
    h = torch.cat([hu[:, None], hg[:, 1:]], dim=1)

    j = h & (R - 1)
    rank = _rank(h, p)
    g = torch.arange(G, dtype=torch.int64, device=dev)[None, :]
    # rows that do not count raise cell (0, g, j) by 0: a no-op
    flat = torch.where(wanted[:, None], (campaign[:, None] * G + g) * R + j,
                       g * R + j)
    value = torch.where(wanted[:, None], rank, 0).to(state.registers.dtype)
    state.registers.view(-1).scatter_reduce_(
        0, flat.reshape(-1), value.reshape(-1), "amax", include_self=True)

    state.totals.index_add_(0, torch.where(wanted, campaign, 0),
                            wanted.to(torch.int32))
    watermark = torch.maximum(
        state.watermark,
        torch.where(valid, event_time, NEG).max().to(torch.int32))
    return HLLXState(state.registers, state.totals, watermark,
                     state.dropped)


def scan_steps(state: HLLXState, join_table: torch.Tensor,
               ad_idx: torch.Tensor, user_idx: torch.Tensor,
               event_type: torch.Tensor, event_time: torch.Tensor,
               valid: torch.Tensor, *, view_type: int = 0) -> HLLXState:
    """Fold ``[N, B]`` stacked micro-batches, one ``step`` per row."""
    for i in range(ad_idx.shape[0]):
        state = step(state, join_table, ad_idx[i], user_idx[i],
                     event_type[i], event_time[i], valid[i],
                     view_type=view_type)
    return state


def scan_steps_packed(state: HLLXState, join_table: torch.Tensor,
                      packed: torch.Tensor, user_idx: torch.Tensor,
                      event_time: torch.Tensor, *,
                      view_type: int = 0) -> HLLXState:
    """``scan_steps`` over the packed wire word plus the user ids: the
    12 B an event of the HLL and reach packed scans."""
    for i in range(packed.shape[0]):
        a, e, v = unpack_columns(packed[i])
        state = step(state, join_table, a, user_idx[i], e, event_time[i],
                     v, view_type=view_type)
    return state


def merge(a: HLLXState, b: HLLXState) -> HLLXState:
    """Shard or partial union into new tensors: the register max and the
    exact counter add.  The geometry is checked first; a mismatch names
    both shapes."""
    if (a.registers.shape != b.registers.shape
            or a.registers.dtype != b.registers.dtype):
        raise ValueError(
            f"hllx.merge: geometry mismatch — a.registers "
            f"{tuple(a.registers.shape)}/{a.registers.dtype} vs b.registers "
            f"{tuple(b.registers.shape)}/{b.registers.dtype}")
    return HLLXState(
        registers=torch.maximum(a.registers, b.registers),
        totals=a.totals + b.totals,
        watermark=torch.maximum(a.watermark, b.watermark),
        dropped=a.dropped + b.dropped)


def moments(state: HLLXState) -> dict:
    """Every answer the ladder holds:

    - ``distinct [C]``: the rung-0 estimate (the plain HLL number);
    - ``softcap [C, G]``: ``sum_x T_g(1-(1-1/T_g)^c_x)`` per rung;
    - ``log_moment [C]``: ``sum_x log2(1+c_x)`` from the octave telescope
      ``sum_g D_g/T_g - LOG_MOMENT_BIAS * D_0`` (counts above the ladder
      truncate toward ``G * distinct``: size G to the count range);
    - ``totals [C]``: exact F1 (wanted events).

    The floats go through the port's ``hll.estimate`` and may differ from
    JAX's in the last place."""
    G = state.registers.shape[1]
    d = hll.estimate(state.registers)                          # [C, G]
    inv_t = 1.0 / caps(G, d.device).to(torch.float32)
    log_raw = (d * inv_t[None, :]).sum(dim=1)
    return {
        "distinct": d[:, 0],
        "softcap": d,
        "log_moment": torch.clamp(log_raw - LOG_MOMENT_BIAS * d[:, 0],
                                  min=0.0),
        "totals": state.totals,
    }
