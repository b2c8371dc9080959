"""MinHash ∪ HyperLogLog reach sketches as one cumulative device state.

The port of ``streambench_tpu/ops/minhash.py``.  Per campaign two
sketches answer any union/intersection/overlap query over campaign sets:

- a k-slot MinHash signature ``mins[C, k]``: slot ``j`` of campaign ``c``
  holds the minimum over its devices of ``h_j(device)``.  A batch folds in
  with one scatter-min; ``merge`` is the elementwise min (commutative,
  associative, idempotent);
- a paired HLL register plane ``registers[C, R]`` (int32): the scatter-max
  of ``ops/hll.py`` with no window axis, since reach is cumulative.

Device identity arrives as the encoder's stateless crc32 id column
(``HASHED_IDS``): one splitmix32 mix for the HLL plane and k salted
splitmix32 mixes for the signature.

Differences from the JAX functions, all deliberate:

- **The signature plane is int64 on the device, holding the uint32
  value.**  torch has no uint32 minimum (``minimum``, ``amin`` and
  ``scatter_reduce(..., "amin")`` are not implemented for UInt32), and
  the hashes already come out of ``hll.splitmix32`` as int64 in
  ``[0, 2^32)``, so the fold scatters them as they are, with no
  conversion, and a signed compare keeps the unsigned order.  It costs
  8 B a cell: 200 KB at ``[100, 256]``.  Every boundary hands out the
  reference's uint32 numpy arrays (``mins_numpy``; snapshots, ship
  records, ``planes()``), and ``mins_tensor`` takes them back.
- **The fold updates the planes in place** (``scatter_reduce_`` with
  ``include_self=True``), as the HLL fold does; the reference returns new
  arrays.  Whoever keeps planes across a later fold (the query server)
  keeps a copy (``engine.sketches.ReachSketchEngine._reach_push``).
- torch has no scatter ``mode="drop"``: a row that does not count
  scatters ``EMPTY`` into the signature and rank 0 into the registers of
  campaign 0, which a min with a slot (never above ``EMPTY``) and a max
  with a register (never below 0) leave as they were.  Such rows go to
  slot ``j`` and register ``j``, spread so that the card's atomics do not
  queue on one address.
- The join goes through ``windowcount.gather_rows``, which wraps a
  negative ad index as JAX's gather does.
- ``_rank`` is ``ops/hll.py``'s, which keeps the reference's float32
  rounding below p = 8 (``w = 2^25 - 1`` reads as rank 0).
- ``scan_steps*`` are Python loops of steps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from streambench_tpu_torch.ops import hll
from streambench_tpu_torch.ops.hll import _rank, splitmix32
from streambench_tpu_torch.ops.windowcount import (
    NEG,
    gather_rows,
    unpack_columns,
)

#: "no device seen" in a signature slot (uint32 max: any real hash is
#: smaller, so the running min replaces it at the first touch)
EMPTY = 0xFFFFFFFF

#: the salt stream's constant for the k slot hashes (the golden-ratio
#: increment of the splitmix stream)
_SALT_GAMMA = 0x9E3779B9

_U32 = 0xFFFFFFFF


class ReachState(NamedTuple):
    """mins: ``[C, k]`` int64 holding uint32 values; registers: ``[C, R]``
    int32; watermark: the largest valid relative event time folded;
    dropped: always 0 (reach has no ring and no lateness cutoff)."""

    mins: torch.Tensor
    registers: torch.Tensor
    watermark: torch.Tensor
    dropped: torch.Tensor


def salts(k: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """The k slot salts (int64 holding uint32): slot ``j``'s hash is
    ``splitmix32(splitmix32(id) ^ salts[j])``."""
    return splitmix32((torch.arange(1, k + 1, dtype=torch.int64,
                                    device=device) * _SALT_GAMMA) & _U32)


def init_state(num_campaigns: int, k: int = 256, num_registers: int = 256,
               device: torch.device | str = "cpu") -> ReachState:
    if k <= 0:
        raise ValueError("k must be positive")
    if num_registers & (num_registers - 1) or num_registers < 16:
        raise ValueError("num_registers must be a power of two >= 16")
    if num_campaigns * max(k, num_registers) >= 2**31:
        raise ValueError("C*k / C*R must fit int32 flat indices")
    return ReachState(
        mins=torch.full((num_campaigns, k), EMPTY, dtype=torch.int64,
                        device=device),
        registers=torch.zeros((num_campaigns, num_registers),
                              dtype=torch.int32, device=device),
        watermark=torch.tensor(NEG, dtype=torch.int32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device))


def mins_numpy(mins: torch.Tensor) -> np.ndarray:
    """The signature plane as the reference's uint32 numpy array."""
    return mins.cpu().numpy().astype(np.uint32)


def mins_tensor(mins: np.ndarray,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """A uint32 signature plane (numpy) as the port's int64 tensor; a new
    tensor, never a view of ``mins``."""
    return torch.from_numpy(
        np.asarray(mins, np.uint32).astype(np.int64)).to(device)


def step(state: ReachState, join_table: torch.Tensor,
         ad_idx: torch.Tensor, user_idx: torch.Tensor,
         event_type: torch.Tensor, event_time: torch.Tensor,
         valid: torch.Tensor, *, view_type: int = 0) -> ReachState:
    """Fold one micro-batch into both planes, in place: for every wanted
    row ``mins[campaign, j] = min(., h_j(user))`` over the k slots (one
    ``[B, k]`` hash block, one flat scatter-min) and ``registers[campaign,
    h & (R-1)] = max(., rank)``."""
    C, k = state.mins.shape
    R = state.registers.shape[1]
    p = R.bit_length() - 1

    campaign = gather_rows(join_table, ad_idx).to(torch.int64)
    wanted = valid & (event_type == view_type) & (campaign >= 0)

    h = splitmix32(user_idx)                                    # [B]
    hk = splitmix32(h[:, None] ^ salts(k, h.device)[None, :])   # [B, k]
    slot = torch.arange(k, dtype=torch.int64, device=h.device)[None, :]
    flat = torch.where(wanted[:, None], campaign[:, None] * k + slot, slot)
    value = torch.where(wanted[:, None], hk, EMPTY)
    state.mins.view(-1).scatter_reduce_(0, flat.reshape(-1),
                                        value.reshape(-1), "amin",
                                        include_self=True)

    j = h & (R - 1)
    rank = _rank(h, p)
    rflat = torch.where(wanted, campaign * R + j, j)
    state.registers.view(-1).scatter_reduce_(
        0, rflat, torch.where(wanted, rank, 0), "amax", include_self=True)

    watermark = torch.maximum(
        state.watermark,
        torch.where(valid, event_time, NEG).max().to(torch.int32))
    return ReachState(state.mins, state.registers, watermark, state.dropped)


def scan_steps(state: ReachState, join_table: torch.Tensor,
               ad_idx: torch.Tensor, user_idx: torch.Tensor,
               event_type: torch.Tensor, event_time: torch.Tensor,
               valid: torch.Tensor, *, view_type: int = 0) -> ReachState:
    """Fold ``[N, B]`` stacked micro-batches, one ``step`` per row."""
    for i in range(ad_idx.shape[0]):
        state = step(state, join_table, ad_idx[i], user_idx[i],
                     event_type[i], event_time[i], valid[i],
                     view_type=view_type)
    return state


def scan_steps_packed(state: ReachState, join_table: torch.Tensor,
                      packed: torch.Tensor, user_idx: torch.Tensor,
                      event_time: torch.Tensor, *,
                      view_type: int = 0) -> ReachState:
    """``scan_steps`` over the packed wire word
    (``windowcount.pack_columns``) plus the user ids: 12 B an event, as
    the HLL engine's packed scan."""
    for i in range(packed.shape[0]):
        a, e, v = unpack_columns(packed[i])
        state = step(state, join_table, a, user_idx[i], e, event_time[i],
                     v, view_type=view_type)
    return state


def merge(a: ReachState, b: ReachState) -> ReachState:
    """Shard or partial-state merge: the elementwise min of the
    signatures and max of the registers, into new tensors.  The geometry
    is checked first: a ``[C, k]`` / ``[C, R]`` mismatch would broadcast
    into garbage."""
    if a.mins.shape != b.mins.shape or a.mins.dtype != b.mins.dtype:
        raise ValueError(
            f"minhash.merge: signature mismatch — a.mins "
            f"{tuple(a.mins.shape)}/{a.mins.dtype} vs b.mins "
            f"{tuple(b.mins.shape)}/{b.mins.dtype}")
    if (a.registers.shape != b.registers.shape
            or a.registers.dtype != b.registers.dtype):
        raise ValueError(
            f"minhash.merge: register mismatch — a.registers "
            f"{tuple(a.registers.shape)}/{a.registers.dtype} vs "
            f"b.registers {tuple(b.registers.shape)}/{b.registers.dtype}")
    return ReachState(
        mins=torch.minimum(a.mins, b.mins),
        registers=torch.maximum(a.registers, b.registers),
        watermark=torch.maximum(a.watermark, b.watermark),
        dropped=a.dropped + b.dropped)


def estimate(registers: torch.Tensor) -> torch.Tensor:
    """Distinct-device estimates from the HLL plane over its last axis
    (the windowed HLL's estimator: same alpha_m and linear counting)."""
    return hll.estimate(registers)
