"""K3: the count-min sketch's hashed row update and point query.

Six entry points, each launching ``csrc/cms_rows.cu``'s kernels on a CUDA
tensor (design and bounds in that file), each the plain PyTorch version
below on a CPU tensor:

- ``cms_update(table, total, keys, weights, mask)``: for every masked row
  and each of the D rows, ``table[d, col_d(key)] += weight``, and
  ``total += sum(masked weights)``, IN PLACE (int32, wrapping);
- ``cms_query(table, keys)``: ``min_d table[d, col_d(key)]`` per key;
- ``cms_refresh_small(fat, small, keys, mask)``: the two-stage sketch's
  second half, ``small[d, h_d & (Ws - 1)] = max(., query(fat, key))`` for
  every masked row, IN PLACE;
- ``cms_cols(keys, depth, width)``: the ``[D, B]`` hashed columns;
- ``cms_update_query(table, total, keys, weights, mask)``: ``cms_update``
  then ``cms_query`` of the same keys, both launched in one call;
- ``cms2_update_query(fat, small, total, keys, weights, mask)``: the
  two-stage sketch's update (``cms_update`` of the fat plane, then
  ``cms_refresh_small``) then ``cms_query`` of the small stage, the three
  launched in one call.

``col_d(key) = splitmix32(uint32(key) ^ SALTS[d]) & (Wd - 1)``, the
reference's ``streambench_tpu/ops/cms.py:_row_cols``.  They replace the
XLA program of ``cms.update`` / ``query`` / ``update2`` / ``query_small``
(not a TPU kernel).  The plain versions hash in int64 with a 32-bit mask
(``ops/hll.py:splitmix32``) and scatter with ``index_add_`` /
``scatter_reduce_("amax")`` into a buffer one element past the plane, the
masked rows aimed at that pad element; ``chip_smoke.py`` holds each
kernel against them on the card, exactly (integer atomics commute).

``launch_plan`` (pure Python) gives each launch its grid.

Each kernel counts its launches (``.launches`` of the wrapper named after
it, whichever wrapper launched it: a fused call adds one to the update's,
the refresh's and the query's counts, and one to its own); a CPU call
launches nothing and counts nothing.  On a CUDA tensor a wrapper launches
its kernels or raises on any CUDA error.
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
THREADS = 256                    # a block
WIDE_MIN_ROWS = 1 << 16          # the update: 4 rows a thread and the
                                 # block's hot-key table from here
I32_MIN = -2**31
_U32 = 0xFFFFFFFF
_MASK_DTYPES = (torch.bool, torch.uint8)
ENTRIES = ("cms_update", "cms_query", "cms_refresh_small", "cms_cols",
           "cms_update_query", "cms2_update_query")


class LaunchPlan(NamedTuple):
    """One launch over ``B`` rows (none when ``blocks`` is 0): ``blocks``
    blocks of ``threads`` threads, thread t covering rows [t *
    rows_per_thread, (t + 1) * rows_per_thread); for the update, ``hot``
    puts the block's hot-key table in front of its atomics."""
    blocks: int
    threads: int
    rows_per_thread: int
    hot: bool


def launch_plan(B: int, *, entry: str = "cms_query",
                aligned: bool = True) -> LaunchPlan:
    """K3's plan for ``entry`` over ``B`` rows.

    ``cms_query``, ``cms_cols`` and ``cms_refresh_small``: one row a
    thread.  ``cms_update`` and the fused entry points' update: from
    ``WIDE_MIN_ROWS`` rows the block's hot-key table, with 4 rows a thread
    where ``aligned`` (keys and weights on 16 bytes, the mask on 4), else
    one; below it one row a thread and no table.  A fused call's refresh
    and query then take one row a thread."""
    if B < 0:
        raise ValueError(f"cms_rows: negative row count {B}")
    if entry not in ENTRIES:
        raise ValueError(f"cms_rows: no entry point {entry!r}")
    wide = B >= WIDE_MIN_ROWS and entry not in ("cms_query", "cms_cols",
                                                "cms_refresh_small")
    per_thread = 4 if wide and aligned else 1
    return LaunchPlan(-(-B // (THREADS * per_thread)), THREADS, per_thread,
                      wide)


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


def cms_update_query_plain(table: torch.Tensor, total: torch.Tensor,
                           keys: torch.Tensor, weights: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    cms_update_plain(table, total, keys, weights, mask)
    return cms_query_plain(table, keys)


def cms2_update_query_plain(fat: torch.Tensor, small: torch.Tensor,
                            total: torch.Tensor, keys: torch.Tensor,
                            weights: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    cms_update_plain(fat, total, keys, weights, mask)
    cms_refresh_small_plain(fat, small, keys, mask)
    return cms_query_plain(small, keys)


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


def _check_total(total: torch.Tensor, device: torch.device) -> None:
    if (total.dtype != torch.int32 or total.dim() != 0
            or total.device != device):
        raise ValueError(f"total must be a 0-dim int32 tensor on {device}, "
                         f"got {total.dtype} of shape {tuple(total.shape)} "
                         f"on {total.device}")


def _check_small(fat: torch.Tensor, small: torch.Tensor) -> None:
    _check_plane("small", small)
    if small.shape[0] != fat.shape[0] or small.device != fat.device:
        raise ValueError(f"small {tuple(small.shape)} on {small.device} "
                         f"does not match fat {tuple(fat.shape)} on "
                         f"{fat.device}")


def _on_cuda(device: torch.device, what: str) -> bool:
    """True for a CUDA device, False for the CPU; raises otherwise."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{what} runs on cuda or cpu, not {device}")


def _call(fn, device: torch.device, *args) -> None:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    _build.launch(fn.__name__, fn, index, *args)


def _launch(fn, device: torch.device, B: int, *args) -> None:
    """A one-row-a-thread launch."""
    plan = launch_plan(B)
    _call(fn, device, *args, plan.blocks, plan.threads)


def _rows_aligned(keys, weights, mask) -> bool:
    """Keys and weights on 16 bytes and the mask on 4: the update's
    4-row loads."""
    return (keys.data_ptr() % 16 == 0 and weights.data_ptr() % 16 == 0
            and mask.data_ptr() % 4 == 0)


def _update_plan(entry: str, keys, weights, mask) -> LaunchPlan:
    return launch_plan(keys.shape[0], entry=entry,
                       aligned=_rows_aligned(keys, weights, mask))


def cms_update(table: torch.Tensor, total: torch.Tensor, keys: torch.Tensor,
               weights: torch.Tensor, mask: torch.Tensor) -> None:
    """Add each masked row's weight to its D cells of ``table`` [D, Wd]
    and the batch's masked weight to ``total`` (a 0-dim int32), in
    place."""
    _check_plane("table", table)
    _check_total(total, table.device)
    B = _check_rows(table.device, keys=keys, weights=weights, mask=mask)
    if not _on_cuda(table.device, "cms_update"):
        return cms_update_plain(table, total, keys, weights, mask)
    if B == 0:
        return None
    D, Wd = table.shape
    plan = _update_plan("cms_update", keys, weights, mask)
    _call(_build.cms_rows_lib().sb_cms_update, table.device,
          table.data_ptr(), total.data_ptr(), keys.data_ptr(),
          weights.data_ptr(), mask.data_ptr(), D, Wd, B, plan.blocks,
          plan.threads, plan.rows_per_thread, int(plan.hot))
    cms_update.launches += 1
    return None


def _update_query(entry: str, fat, small, total, keys, weights,
                  mask) -> torch.Tensor:
    """The fused entry points on the card: one call that launches the
    update, the refresh (two-stage) and the query; each kernel's count
    and the entry's own go up by one."""
    B = keys.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=fat.device)
    if B == 0:
        return out
    D, Wd = fat.shape
    Ws = small.shape[1] if small is not None else 0
    plan = _update_plan(entry, keys, weights, mask)
    _call(_build.cms_rows_lib().sb_cms_update_query, fat.device,
          fat.data_ptr(), total.data_ptr(), keys.data_ptr(),
          weights.data_ptr(), mask.data_ptr(),
          None if small is None else small.data_ptr(), out.data_ptr(), D,
          Wd, Ws, B, plan.blocks, plan.threads, plan.rows_per_thread,
          int(plan.hot))
    cms_update.launches += 1
    if small is not None:
        cms_refresh_small.launches += 1
    cms_query.launches += 1
    return out


def cms_update_query(table: torch.Tensor, total: torch.Tensor,
                     keys: torch.Tensor, weights: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """``cms_update`` (in place), then ``[B]`` int32: each key's estimate
    from the updated ``table``."""
    _check_plane("table", table)
    _check_total(total, table.device)
    _check_rows(table.device, keys=keys, weights=weights, mask=mask)
    if not _on_cuda(table.device, "cms_update_query"):
        return cms_update_query_plain(table, total, keys, weights, mask)
    out = _update_query("cms_update_query", table, None, total, keys,
                        weights, mask)
    if out.numel():
        cms_update_query.launches += 1
    return out


def cms2_update_query(fat: torch.Tensor, small: torch.Tensor,
                      total: torch.Tensor, keys: torch.Tensor,
                      weights: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """The two-stage update (``cms_update`` of ``fat``, then
    ``cms_refresh_small``, in place), then ``[B]`` int32: each key's
    estimate from the refreshed ``small`` stage."""
    _check_plane("fat", fat)
    _check_small(fat, small)
    _check_total(total, fat.device)
    _check_rows(fat.device, keys=keys, weights=weights, mask=mask)
    if not _on_cuda(fat.device, "cms2_update_query"):
        return cms2_update_query_plain(fat, small, total, keys, weights,
                                       mask)
    out = _update_query("cms2_update_query", fat, small, total, keys,
                        weights, mask)
    if out.numel():
        cms2_update_query.launches += 1
    return out


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
    _check_small(fat, small)
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


#: the four kernels, each counted under its wrapper's name
KERNELS = (cms_update, cms_query, cms_refresh_small, cms_cols)
ENTRY_POINTS = KERNELS + (cms_update_query, cms2_update_query)
for _fn in ENTRY_POINTS:
    _fn.launches = 0


def launches() -> dict[str, int]:
    """Launches of each kernel, and calls of each fused entry point that
    launched, since the last ``reset_launches``."""
    return {fn.__name__: fn.launches for fn in ENTRY_POINTS}


def kernel_launches() -> int:
    """Kernel launches in all since the last ``reset_launches``."""
    return sum(fn.launches for fn in KERNELS)


def reset_launches() -> None:
    for fn in ENTRY_POINTS:
        fn.launches = 0
