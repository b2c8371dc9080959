"""K1: the masked (campaign, slot) cell count, as a hand-written CUDA kernel.

``count_cells(counts, campaign, slot, count_mask)`` adds one to
``counts[campaign[i], slot[i]]`` for every row with ``count_mask[i]`` set,
IN PLACE, and returns ``counts``.  It replaces the TPU kernel
``streambench_tpu/ops/pallas_count.py:count_tiles``, which returned
``counts + delta``.  Rows whose (campaign, slot) falls outside the
``[C, W]`` plane count nowhere, as in the TPU kernel's one-hot product.

On a CUDA tensor the wrapper launches the kernel of
``csrc/count_cells.cu`` (design and bound in that file) or raises; on a
CPU tensor it runs ``count_cells_plain``, the plain PyTorch version, which
``chip_smoke.py`` also holds the kernel against on the card.
"""

from __future__ import annotations

import torch

from streambench_tpu_torch.ops import _build


def _check(counts: torch.Tensor, campaign: torch.Tensor, slot: torch.Tensor,
           count_mask: torch.Tensor) -> None:
    if counts.dtype != torch.int32 or counts.dim() != 2:
        raise ValueError(f"counts must be a 2-D int32 tensor, got "
                         f"{counts.dtype} of shape {tuple(counts.shape)}")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    rows = campaign.shape[0] if campaign.dim() == 1 else None
    for name, t, dtypes in (("campaign", campaign, (torch.int32,)),
                            ("slot", slot, (torch.int32,)),
                            ("count_mask", count_mask,
                             (torch.bool, torch.uint8))):
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
    if counts.device.type == "cpu":
        return count_cells_plain(counts, campaign, slot, count_mask)
    if counts.device.type != "cuda":
        raise ValueError(f"count_cells runs on cuda or cpu, not "
                         f"{counts.device}")
    B = campaign.shape[0]
    if B == 0:
        return counts
    lib = _build.count_cells_lib()
    C, W = counts.shape
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sb_count_cells(counts.data_ptr(), campaign.data_ptr(),
                                slot.data_ptr(), count_mask.data_ptr(),
                                B, C, W, stream)
    if rc != 0:
        raise RuntimeError(f"count_cells kernel launch failed: CUDA error "
                           f"{rc}")
    count_cells.launches += 1
    return counts


count_cells.launches = 0
