"""K3: the count-min sketch's hashed row update and point query.

Four entry points, each one launch of ``csrc/cms_rows.cu`` on a CUDA
tensor (design and bound in that file), each the plain PyTorch version
below on a CPU tensor:

- ``cms_update(table, total, keys, weights, mask)``: for every masked row
  and each of the D rows, ``table[d, col_d(key)] += weight``, and
  ``total += sum(masked weights)``, IN PLACE (int32, wrapping);
- ``cms_query(table, keys)``: ``min_d table[d, col_d(key)]`` per key;
- ``cms_refresh_small(fat, small, keys, mask)``: the two-stage sketch's
  second half, ``small[d, h_d & (Ws - 1)] = max(., query(fat, key))`` for
  every masked row, IN PLACE;
- ``cms_cols(keys, depth, width)``: the ``[D, B]`` hashed columns.

``col_d(key) = splitmix32(uint32(key) ^ SALTS[d]) & (Wd - 1)``, the
reference's ``streambench_tpu/ops/cms.py:_row_cols``.  They replace the
XLA program of ``cms.update`` / ``query`` / ``update2`` (not a TPU
kernel).  The plain versions hash in int64 with a 32-bit mask
(``ops/hll.py:splitmix32``) and scatter with ``index_add_`` /
``scatter_reduce_("amax")`` into a buffer one element past the plane, the
masked rows aimed at that pad element; ``chip_smoke.py`` holds each
kernel against them on the card, exactly (integer atomics commute).

Each wrapper counts its launches (``.launches``); a CPU call launches
nothing and counts nothing.  On a CUDA tensor a wrapper launches its
kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from streambench_tpu_torch.ops import _build
from streambench_tpu_torch.ops.hll import splitmix32

#: the reference's ``cms._SALTS``: distinct odd salts for the D rows
SALTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
         0x165667B1, 0xFC545C4F, 0x2545F491, 0x61C88647)
MAX_DEPTH = len(SALTS)
THREADS = 256                    # one row a thread
I32_MIN = -2**31
_U32 = 0xFFFFFFFF
_MASK_DTYPES = (torch.bool, torch.uint8)


class LaunchPlan(NamedTuple):
    """One launch over ``B`` rows: ``blocks`` blocks of ``threads``
    threads, one row a thread (no launch when ``blocks`` is 0)."""
    blocks: int
    threads: int


def launch_plan(B: int) -> LaunchPlan:
    """K3's plan for ``B`` rows (every entry point takes the same)."""
    if B < 0:
        raise ValueError(f"cms_rows: negative row count {B}")
    return LaunchPlan(blocks=-(-B // THREADS), threads=THREADS)


# ----------------------------------------------------------------------
# the plain versions

def row_cols_plain(keys: torch.Tensor, depth: int,
                   width: int) -> torch.Tensor:
    """``[D, B]`` int32 column of each key in each row."""
    k = keys.to(torch.int64) & _U32
    return torch.stack([(splitmix32(k ^ SALTS[d]) & (width - 1)).to(
        torch.int32) for d in range(depth)])


def _flat(cols: torch.Tensor, mask: torch.Tensor, width: int) -> torch.Tensor:
    """Flat plane index of each (row, key), masked keys at the pad
    element ``D * width``."""
    D = cols.shape[0]
    rows = torch.arange(D, dtype=torch.int64, device=cols.device)[:, None]
    flat = rows * width + cols.to(torch.int64)
    return torch.where(mask.bool()[None, :], flat, D * width).reshape(-1)


def cms_update_plain(table: torch.Tensor, total: torch.Tensor,
                     keys: torch.Tensor, weights: torch.Tensor,
                     mask: torch.Tensor) -> None:
    D, Wd = table.shape
    w = torch.where(mask.bool(), weights, 0).to(torch.int32)
    padded = torch.zeros(D * Wd + 1, dtype=torch.int32, device=table.device)
    padded.index_add_(0, _flat(row_cols_plain(keys, D, Wd), mask, Wd),
                      w.expand(D, -1).reshape(-1))
    table.view(-1).add_(padded[:-1])
    total.add_(w.sum(dtype=torch.int32))


def cms_query_plain(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    D, Wd = table.shape
    cols = row_cols_plain(keys, D, Wd).to(torch.int64)
    return table.gather(1, cols).min(0).values


def cms_refresh_small_plain(fat: torch.Tensor, small: torch.Tensor,
                            keys: torch.Tensor, mask: torch.Tensor) -> None:
    D, Ws = small.shape
    est = cms_query_plain(fat, keys)
    padded = torch.cat([small.reshape(-1),
                        small.new_full((1,), I32_MIN)])
    padded.scatter_reduce_(0, _flat(row_cols_plain(keys, D, Ws), mask, Ws),
                           est.expand(D, -1).reshape(-1), "amax",
                           include_self=True)
    small.view(-1).copy_(padded[:-1])


# ----------------------------------------------------------------------
# the wrappers

def _check_plane(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D int32 tensor, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")
    D, W = t.shape
    if not 1 <= D <= MAX_DEPTH or W < 1 or W & (W - 1):
        raise ValueError(f"{name} must be [D, W] with 1 <= D <= {MAX_DEPTH} "
                         f"and W a power of two, got {tuple(t.shape)}")


def _check_rows(device: torch.device, **cols) -> int:
    """Rows of the 1-D columns ``cols`` (keys and weights int32, mask
    bool or uint8), all contiguous on ``device``."""
    rows = None
    for name, t in cols.items():
        dtypes = _MASK_DTYPES if name == "mask" else (torch.int32,)
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be "
                             f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor, got "
                             f"shape {tuple(t.shape)}")
        if rows is not None and t.shape[0] != rows:
            raise ValueError(f"{name} has {t.shape[0]} rows, keys {rows}")
        rows = t.shape[0]
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the plane on "
                             f"{device}")
    return rows


def _on_cuda(device: torch.device, what: str) -> bool:
    """True for a CUDA device, False for the CPU; raises otherwise."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{what} runs on cuda or cpu, not {device}")


def _launch(fn, device: torch.device, B: int, *args) -> None:
    plan = launch_plan(B)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    _build.launch(fn.__name__, fn, index, *args, plan.blocks, plan.threads)


def cms_update(table: torch.Tensor, total: torch.Tensor, keys: torch.Tensor,
               weights: torch.Tensor, mask: torch.Tensor) -> None:
    """Add each masked row's weight to its D cells of ``table`` [D, Wd]
    and the batch's masked weight to ``total`` (a 0-dim int32), in
    place."""
    _check_plane("table", table)
    if (total.dtype != torch.int32 or total.dim() != 0
            or total.device != table.device):
        raise ValueError(f"total must be a 0-dim int32 tensor on "
                         f"{table.device}, got {total.dtype} of shape "
                         f"{tuple(total.shape)} on {total.device}")
    B = _check_rows(table.device, keys=keys, weights=weights, mask=mask)
    if not _on_cuda(table.device, "cms_update"):
        return cms_update_plain(table, total, keys, weights, mask)
    if B == 0:
        return None
    D, Wd = table.shape
    lib = _build.cms_rows_lib()
    _launch(lib.sb_cms_update, table.device, B, table.data_ptr(),
            total.data_ptr(), keys.data_ptr(), weights.data_ptr(),
            mask.data_ptr(), D, Wd, B)
    cms_update.launches += 1
    return None


def cms_query(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """``[B]`` int32: the min over the D rows of each key's cells."""
    _check_plane("table", table)
    B = _check_rows(table.device, keys=keys)
    if not _on_cuda(table.device, "cms_query"):
        return cms_query_plain(table, keys)
    out = torch.empty(B, dtype=torch.int32, device=table.device)
    if B == 0:
        return out
    D, Wd = table.shape
    lib = _build.cms_rows_lib()
    _launch(lib.sb_cms_query, table.device, B, table.data_ptr(),
            keys.data_ptr(), out.data_ptr(), D, Wd, B)
    cms_query.launches += 1
    return out


def cms_refresh_small(fat: torch.Tensor, small: torch.Tensor,
                      keys: torch.Tensor, mask: torch.Tensor) -> None:
    """Raise each masked key's D cells of ``small`` [D, Ws] to its
    estimate in ``fat`` [D, Wd], in place."""
    _check_plane("fat", fat)
    _check_plane("small", small)
    if small.shape[0] != fat.shape[0] or small.device != fat.device:
        raise ValueError(f"small {tuple(small.shape)} on {small.device} "
                         f"does not match fat {tuple(fat.shape)} on "
                         f"{fat.device}")
    B = _check_rows(fat.device, keys=keys, mask=mask)
    if not _on_cuda(fat.device, "cms_refresh_small"):
        return cms_refresh_small_plain(fat, small, keys, mask)
    if B == 0:
        return None
    D, Wd = fat.shape
    lib = _build.cms_rows_lib()
    _launch(lib.sb_cms_refresh_small, fat.device, B, fat.data_ptr(),
            small.data_ptr(), keys.data_ptr(), mask.data_ptr(), D, Wd,
            small.shape[1], B)
    cms_refresh_small.launches += 1
    return None


def cms_cols(keys: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """``[depth, B]`` int32 hashed columns of ``keys`` at ``width``."""
    if not 1 <= depth <= MAX_DEPTH or width < 1 or width & (width - 1):
        raise ValueError(f"cms_cols: depth must be 1..{MAX_DEPTH} and width "
                         f"a power of two, got {depth}, {width}")
    B = _check_rows(keys.device, keys=keys)
    if not _on_cuda(keys.device, "cms_cols"):
        return row_cols_plain(keys, depth, width)
    cols = torch.empty((depth, B), dtype=torch.int32, device=keys.device)
    if B == 0:
        return cols
    lib = _build.cms_rows_lib()
    _launch(lib.sb_cms_cols, keys.device, B, keys.data_ptr(),
            cols.data_ptr(), depth, width, B)
    cms_cols.launches += 1
    return cols


ENTRY_POINTS = (cms_update, cms_query, cms_refresh_small, cms_cols)
for _fn in ENTRY_POINTS:
    _fn.launches = 0


def launches() -> dict[str, int]:
    """Launches of each entry point since the last ``reset_launches``."""
    return {fn.__name__: fn.launches for fn in ENTRY_POINTS}


def reset_launches() -> None:
    for fn in ENTRY_POINTS:
        fn.launches = 0
