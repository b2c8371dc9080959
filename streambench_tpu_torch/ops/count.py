"""K1: the masked (campaign, slot) cell count, as a hand-written CUDA kernel.

``count_cells(counts, campaign, slot, count_mask)`` adds one to
``counts[campaign[i], slot[i]]`` for every row with ``count_mask[i]`` set,
IN PLACE, and returns ``counts``.  It replaces the TPU kernel
``streambench_tpu/ops/pallas_count.py:count_tiles``, which returned
``counts + delta``.  Rows whose (campaign, slot) falls outside the
``[C, W]`` plane count nowhere, as in the TPU kernel's one-hot product.

On a CUDA tensor the wrapper launches the kernel of
``csrc/count_cells.cu`` (design and bound in that file) with the plan of
``launch_plan``, or raises; on a CPU tensor it runs ``count_cells_plain``,
the plain PyTorch version, which ``chip_smoke.py`` also holds the kernel
against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from streambench_tpu_torch.ops import _build

# Tier thresholds and shapes, from a tier sweep on one H100 (PERF.md,
# PR 2).  The direct tier's time grows with the rows; the private tier's is
# near flat in rows but grows with the C * W cells each block zeroes and
# flushes: it wins from PRIVATE_MIN_ROWS rows plus one row per cell on.
PRIVATE_MIN_ROWS = 4096
ROWS_PER_THREAD = 4              # csrc/count_cells.cu kRows
THREADS = {"direct": 256, "private": 1024, "global": 256}
GLOBAL_BLOCKS_PER_SM = 8
MAX_CELLS = 2**31 - 1            # the kernel's cell index is 32-bit
_MASK_DTYPES = (torch.bool, torch.uint8)


class LaunchPlan(NamedTuple):
    """How one launch of K1 covers rows ``[0, B)``: ``head`` rows before
    the first 16-byte-aligned campaign row, ``runs`` runs of
    ``ROWS_PER_THREAD`` rows read with vector loads, then ``tail`` rows;
    head and tail are read with scalar loads."""
    tier: str                   # "direct", "private" or "global"
    threads: int
    blocks: int
    head: int
    runs: int
    tail: int
    vector_slot: bool           # slot's runs are 16-byte aligned too
    vector_mask: bool           # count_mask's runs are 4-byte aligned
    smem_bytes: int             # dynamic shared memory per block


def launch_plan(B: int, C: int, W: int,
                align: tuple[int, int, int] = (0, 0, 0), sms: int = 132,
                smem_optin: int = 232_448) -> LaunchPlan:
    """K1's launch plan for ``B`` rows on a ``[C, W]`` plane, on a card
    with ``sms`` SMs and ``smem_optin`` bytes of shared memory per block.

    ``align`` is ``(campaign, slot, count_mask)``'s ``data_ptr() % 16``:
    campaign's decides the head, and the other two whether their runs can
    be read with vector loads.  Pure: the CPU tests check the row
    partition it gives."""
    cells = C * W
    if cells > MAX_CELLS:
        raise ValueError(f"count_cells: a {C} x {W} plane has more than "
                         f"{MAX_CELLS} cells")
    camp_off, slot_off, mask_off = align
    if camp_off % 4 or slot_off % 4:
        raise ValueError(f"count_cells: int32 columns must be 4-byte "
                         f"aligned, got offsets {align}")
    if 4 * cells > smem_optin:
        tier = "global"
    elif B >= PRIVATE_MIN_ROWS + cells:
        tier = "private"
    else:
        tier = "direct"
    R = ROWS_PER_THREAD
    threads = THREADS[tier]
    head = min(B, (16 - camp_off) % 16 // 4)
    runs, tail = divmod(B - head, R)
    units = runs + (head > 0) + (tail > 0)     # a thread's work items
    want = max(1, -(-units // threads))
    if tier == "private":
        blocks = min(want, sms)
    else:
        blocks = min(want, sms * GLOBAL_BLOCKS_PER_SM)
    return LaunchPlan(
        tier=tier, threads=threads, blocks=blocks, head=head, runs=runs,
        tail=tail, vector_slot=(slot_off + 4 * head) % 16 == 0,
        vector_mask=(mask_off + head) % R == 0,
        smem_bytes=4 * cells if tier == "private" else 0)


class _PlanArgs(ctypes.Structure):
    """A plan as ``sb_count_cells`` reads it (``struct Plan`` of
    ``csrc/count_cells.cu``, same field order)."""
    _fields_ = [("runs", ctypes.c_int64)] + [
        (name, ctypes.c_int32) for name in (
            "C", "W", "private_tier", "blocks", "threads", "head", "tail",
            "vec_slot", "vec_mask")]


#: bytes of the plan struct each launch passes (by pointer)
PLAN_BYTES = ctypes.sizeof(_PlanArgs)


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple[int, int]:
    """``(SM count, shared memory a block may opt in to)`` of CUDA device
    ``index``, asked of the driver once per device."""
    sms, smem = ctypes.c_int(), ctypes.c_int()
    rc = _build.count_cells_lib().sb_device_limits(
        index, ctypes.byref(sms), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"count_cells: querying device {index} failed: "
                           f"CUDA error {rc}")
    return sms.value, smem.value


@functools.lru_cache(maxsize=4096)
def _cached_plan(B: int, C: int, W: int, align: tuple[int, int, int],
                 index: int) -> _PlanArgs:
    """``launch_plan`` on device ``index``, as the kernel reads it."""
    plan = launch_plan(B, C, W, align, *device_limits(index))
    return _PlanArgs(plan.runs, C, W, plan.tier == "private", plan.blocks,
                     plan.threads, plan.head, plan.tail, plan.vector_slot,
                     plan.vector_mask)


def _check(counts: torch.Tensor, campaign: torch.Tensor, slot: torch.Tensor,
           count_mask: torch.Tensor) -> None:
    # one pass for the common case: CUDA tensors on one card, as the
    # kernel takes them
    if counts.is_cuda:
        index = counts.get_device()
        rows = campaign.shape
        if (counts.dtype == torch.int32 and counts.dim() == 2
                and counts.is_contiguous() and campaign.dtype == torch.int32
                and len(rows) == 1 and campaign.is_contiguous()
                and campaign.get_device() == index
                and slot.dtype == torch.int32 and slot.shape == rows
                and slot.is_contiguous() and slot.get_device() == index
                and count_mask.dtype in _MASK_DTYPES
                and count_mask.shape == rows
                and count_mask.is_contiguous()
                and count_mask.get_device() == index):
            return
    # every other case, to name what is wrong
    if counts.dtype != torch.int32 or counts.dim() != 2:
        raise ValueError(f"counts must be a 2-D int32 tensor, got "
                         f"{counts.dtype} of shape {tuple(counts.shape)}")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    rows = campaign.shape[0] if campaign.dim() == 1 else None
    for name, t, dtypes in (("campaign", campaign, (torch.int32,)),
                            ("slot", slot, (torch.int32,)),
                            ("count_mask", count_mask, _MASK_DTYPES)):
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))}"
                             f", got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != rows:
            raise ValueError(f"{name} must be 1-D with as many rows as "
                             f"campaign, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != counts.device:
            raise ValueError(f"{name} is on {t.device}, counts on "
                             f"{counts.device}")


def count_cells_plain(counts: torch.Tensor, campaign: torch.Tensor,
                      slot: torch.Tensor,
                      count_mask: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` on the flat ``[C*W]``
    view.  torch has no scatter ``mode="drop"``, so rows that do not
    count go to a pad cell ``C*W`` of a ``[C*W + 1]`` buffer."""
    C, W = counts.shape
    keep = (count_mask.bool() & (campaign >= 0) & (campaign < C)
            & (slot >= 0) & (slot < W))
    flat = torch.where(keep, campaign * W + slot, C * W)
    padded = torch.zeros(C * W + 1, dtype=torch.int32, device=counts.device)
    padded.index_add_(0, flat, torch.ones_like(flat))
    counts.view(-1).add_(padded[:C * W])
    return counts


def count_cells(counts: torch.Tensor, campaign: torch.Tensor,
                slot: torch.Tensor, count_mask: torch.Tensor) -> torch.Tensor:
    """``counts[campaign, slot] += 1`` for masked rows, in place.

    ``counts`` int32 ``[C, W]`` contiguous; ``campaign``/``slot`` int32
    ``[B]``; ``count_mask`` bool or uint8 ``[B]``; all on one device.
    ``count_cells.launches`` counts kernel launches (CPU calls do not
    launch and do not count)."""
    _check(counts, campaign, slot, count_mask)
    if not counts.is_cuda:
        if counts.device.type == "cpu":
            return count_cells_plain(counts, campaign, slot, count_mask)
        raise ValueError(f"count_cells runs on cuda or cpu, not "
                         f"{counts.device}")
    B = campaign.shape[0]
    if B == 0 or counts.numel() == 0:
        return counts
    index = counts.get_device()
    ptrs = (counts.data_ptr(), campaign.data_ptr(), slot.data_ptr(),
            count_mask.data_ptr())
    # held while the launch reads it: the cache may drop it meanwhile
    plan = _cached_plan(B, *counts.shape,
                        (ptrs[1] % 16, ptrs[2] % 16, ptrs[3] % 16), index)
    _build.launch("count_cells", _build.count_cells_lib().sb_count_cells,
                  index, *ptrs, ctypes.addressof(plan))
    count_cells.launches += 1
    return counts


count_cells.launches = 0
