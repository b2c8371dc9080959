"""K2: device decode of raw journal rows, as a hand-written CUDA kernel.

``decode_rows(buf, starts, lens, keys, vals, probes, base_hi, base_lo,
meta=...)`` turns the bytes of each row ``buf[starts[r] : starts[r] +
lens[r]]`` of the generator's fixed JSON skeleton into four columns: the
ad's campaign (an FNV-1a hash of the 36 ad-id bytes, linear-probed against
the ``keys``/``vals`` table of ``ops.devdecode.build_ad_table``; -1 when
the ad is unknown), whether the event is a view, its time in ms relative
to ``base_hi * 10^9 + base_lo`` (int32), and whether the row is real (pad
rows have ``lens == 0``).  It replaces no Pallas kernel: it is the port
of the XLA fusion ``streambench_tpu/ops/devdecode.py:_decode_columns``,
whose eager torch form would run to ~150 launches per row group
(``csrc/decode_rows.cu`` gives the design and the bound).

On a CUDA tensor the wrapper launches the kernel with the plan of
``decode_plan`` or raises; the kernel reads the table through ``meta``,
the slot tags, values and used bits of ``slot_meta``, built once per
table.  On a CPU tensor it runs ``decode_rows_plain``, the transcription
of ``_decode_columns`` in torch ops, which ``chip_smoke.py`` also holds
the kernel against on the card.  Pad rows come out as ``campaign -1,
is_view False, rel 0, valid False`` from both (the reference decodes
garbage there, which the fold masks).  No single PyTorch call computes
this function, so there is no library yardstick for it.

The byte layout is the generator's wire format, the contract the host
probe (``native/encoder.cpp:sb_probe_block``) validates row by row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from streambench_tpu_torch.ops import _build
from streambench_tpu_torch.ops.count import device_limits
from streambench_tpu_torch.ops.windowcount import gather_rows

# ----------------------------------------------------------------------
# Wire-format constants (the generator's fixed skeleton), as the
# reference's ops/devdecode.py states them.
UUID_LEN = 36
HEAD = b'{"user_id": "'                       # 13 @ 0
LIT_PAGE = b'", "page_id": "'                 # 15 @ 49
LIT_AD = b'", "ad_id": "'                     # 13 @ 100
LIT_ADTYPE = b'", "ad_type": "'               # 15 @ 149
LIT_ET = b'", "event_type": "'                # 18, end-relative
LIT_TM = b'", "event_time": "'                # 18 @ L-58
SUFFIX = b'", "ip_address": "1.2.3.4"}'       # 27 @ L-27
AD_OFF = 113                                  # ad id bytes [113, 149)
ADTYPE_OFF = 164
TIME_DIGITS = 13
# end-relative offsets
SUF_OFF = 27
DIG_OFF = SUF_OFF + TIME_DIGITS               # 40
TM_OFF = DIG_OFF + len(LIT_TM)                # 58
# fixed bytes head+tail (164 + 18+18+13+27 = 240) + >=1 ad_type + >=4 et
MIN_ROW = 245

# FNV-1a 32-bit; the kernel hashes in uint32, the plain version in int64
# masked to 32 bits (h < 2^32 and the prime < 2^25, so no product
# overflows), so the host table build and both decoders wrap alike.
FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
_U32 = 0xFFFFFFFF

# ----------------------------------------------------------------------
# The slot table the kernel probes: per slot a 32-bit tag (FNV-1a of its
# key), its value and a used bit, packed into one uint32 array that one
# bulk copy brings into shared memory: tags [tp], vals [tp], used bits
# [up] words, each part padded to 16 bytes (a bulk copy moves multiples
# of 16 bytes between 16-byte-aligned addresses).
SMEM_STATIC = 128           # the kernel's static shared memory (ptxas: its
                            # mbarrier, 128-aligned before the staged table)
SMEM_DEFAULT = 48 * 1024    # what a block takes without opting in
SMALL_THREADS = 64          # block size up to SMALL_ROWS_PER_SM rows an SM
LARGE_THREADS = 256         # block size past it
SMALL_ROWS_PER_SM = 2 * SMALL_THREADS   # from chip_decode_probe.py


def meta_layout(T: int) -> tuple[int, int]:
    """``(tp, up)``: the words of each of the tags and vals parts and of
    the used-bits part of a ``T``-slot table's ``slot_meta``."""
    return (T + 3) // 4 * 4, ((T + 31) // 32 + 3) // 4 * 4


def meta_bytes(T: int) -> int:
    """The bytes of a ``T``-slot table's ``slot_meta``: what the smem tier
    stages in every block."""
    tp, up = meta_layout(T)
    return 4 * (2 * tp + up)


def fnv1a32_rows(keys: np.ndarray) -> np.ndarray:
    """FNV-1a 32-bit of each row of a uint8 ``[N, L]`` array, as uint32."""
    h = np.full(keys.shape[0], FNV_OFFSET, np.uint64)
    for i in range(keys.shape[1]):
        h = ((h ^ keys[:, i]) * np.uint64(FNV_PRIME)) & np.uint64(_U32)
    return h.astype(np.uint32)


def slot_meta(keys: np.ndarray, vals: np.ndarray,
              used: np.ndarray) -> np.ndarray:
    """The kernel's view of a join table (``keys [T, 36]``, ``vals [T]``
    and the ``used [T]`` mask of ``build_ad_table(..., with_used=True)``):
    uint32 ``[2 * tp + up]`` of ``meta_layout``, a used slot's tag the
    FNV-1a hash of its key (0 on unused slots, which no probe compares),
    vals as their int32 bits, bit ``j % 32`` of used word ``j // 32`` set
    for a used slot ``j``."""
    T = keys.shape[0]
    tp, up = meta_layout(T)
    used = np.asarray(used, bool)
    meta = np.zeros(2 * tp + up, np.uint32)
    meta[:T] = np.where(used, fnv1a32_rows(keys), 0)
    meta[tp:tp + T] = np.asarray(vals, np.int32).view(np.uint32)
    bits = np.zeros(up * 32, bool)
    bits[:T] = used
    meta[2 * tp:] = np.packbits(bits.reshape(-1, 8), axis=1,
                                bitorder="little").reshape(-1).view(
                                    np.uint32)
    return meta


class DecodePlan(NamedTuple):
    """How one launch of K2 covers its rows, one row a thread: the tier
    (``smem``: the slot table staged in each block's shared memory;
    ``global``: read from global memory), the block size, the grid, the
    shared bytes a block stages, and whether ``buf`` is 16-byte aligned,
    so that rows whose spans lie in ``[0, cap & ~15)`` take 16-byte loads
    (the others read bytes one at a time)."""
    tier: str
    threads: int
    blocks: int
    smem_bytes: int
    vector: bool


def decode_plan(T: int, cap: int, buf_align: int, rows: int,
                smem_limit: int = SMEM_DEFAULT, sms: int = 132) -> DecodePlan:
    """K2's plan for ``rows`` rows of a ``cap``-byte buffer whose
    ``data_ptr() % 16`` is ``buf_align``, probing a ``T``-slot table, on
    a card with ``sms`` SMs, a block staging at most ``smem_limit`` bytes.

    The smem tier takes every table whose ``slot_meta`` fits the budget
    beside the kernel's static bytes (up to 4,096 slots at the 48 KB a
    block takes without opting in); a larger one runs the global tier.  Up
    to ``SMALL_ROWS_PER_SM * sms`` rows (16,896 on an H100) get
    ``SMALL_THREADS``-thread blocks, so a small dispatch's real rows spread
    over most SMs; larger ones get ``LARGE_THREADS``-thread blocks.  Pure:
    the CPU tests check it."""
    if T < 1 or T & (T - 1):
        raise ValueError(f"the table's size must be a power of two, got {T}")
    if rows < 1:
        raise ValueError(f"a launch covers at least one row, got {rows}")
    staged = meta_bytes(T)
    tier = "smem" if staged + SMEM_STATIC <= smem_limit else "global"
    threads = (SMALL_THREADS if rows <= SMALL_ROWS_PER_SM * sms
               else LARGE_THREADS)
    return DecodePlan(tier=tier, threads=threads, blocks=-(-rows // threads),
                      smem_bytes=staged if tier == "smem" else 0,
                      vector=buf_align % 16 == 0 and cap >= 16)


class _PlanArgs(ctypes.Structure):
    """A plan as ``sb_decode_rows`` reads it (``struct Plan`` of
    ``csrc/decode_rows.cu``, same field order)."""
    _fields_ = [(name, ctypes.c_int32) for name in (
        "smem_tier", "threads", "blocks", "smem_bytes", "vector")]


@functools.lru_cache(maxsize=4096)
def _cached_plan(T: int, cap: int, buf_align: int, rows: int,
                 index: int) -> _PlanArgs:
    """``decode_plan`` on device ``index``, as the kernel reads it."""
    sms, _ = device_limits(index)
    plan = decode_plan(T, cap, buf_align, rows, sms=sms)
    return _PlanArgs(plan.tier == "smem", plan.threads, plan.blocks,
                     plan.smem_bytes, plan.vector)


def _check(buf, starts, lens, keys, vals) -> None:
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError(f"buf must be a contiguous 1-D uint8 tensor, got "
                         f"{buf.dtype} of shape {tuple(buf.shape)}")
    if buf.shape[0] == 0:
        raise ValueError("buf is empty")
    for name, t in (("starts", starts), ("lens", lens)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, "
                             f"got {t.dtype}")
    if starts.shape != lens.shape:
        raise ValueError(f"starts {tuple(starts.shape)} and lens "
                         f"{tuple(lens.shape)} differ in shape")
    if (keys.dtype != torch.uint8 or keys.dim() != 2
            or keys.shape[1] != UUID_LEN or not keys.is_contiguous()):
        raise ValueError(f"keys must be a contiguous uint8 [T, {UUID_LEN}] "
                         f"tensor, got {keys.dtype} of shape "
                         f"{tuple(keys.shape)}")
    T = keys.shape[0]
    if (vals.dtype != torch.int32 or tuple(vals.shape) != (T,)
            or not vals.is_contiguous()):
        raise ValueError(f"vals must be a contiguous int32 [{T}] tensor, "
                         f"got {vals.dtype} of shape {tuple(vals.shape)}")
    if T < 1 or T & (T - 1):
        raise ValueError(f"the table's size must be a power of two, got {T}")
    for name, t in (("starts", starts), ("lens", lens), ("keys", keys),
                    ("vals", vals)):
        if t.device != buf.device:
            raise ValueError(f"{name} is on {t.device}, buf on {buf.device}")


def decode_rows_plain(buf: torch.Tensor, starts: torch.Tensor,
                      lens: torch.Tensor, keys: torch.Tensor,
                      vals: torch.Tensor, probes: int, base_hi: int,
                      base_lo: int):
    """The plain PyTorch version: ``_decode_columns`` in torch ops, every
    byte read through ``gather_rows`` (JAX's gather rule).  Returns
    ``(campaign int32, is_view bool, rel int32, valid bool)`` shaped as
    ``starts``."""
    shape = starts.shape
    dev = buf.device
    valid = (lens > 0).reshape(-1)
    s = torch.where(valid, starts.reshape(-1), 0).long()
    e = torch.where(valid, (starts + lens).reshape(-1), MIN_ROW).long()

    def take(first: torch.Tensor, n: int) -> torch.Tensor:
        idx = first[:, None] + torch.arange(n, device=dev)[None, :]
        return gather_rows(buf, idx).long()

    ad = take(s + AD_OFF, UUID_LEN)                            # [R, 36]
    h = torch.full_like(s, FNV_OFFSET)
    for i in range(UUID_LEN):
        h = ((h ^ ad[:, i]) * FNV_PRIME) & _U32

    T = vals.shape[0]
    campaign = torch.full_like(s, -1, dtype=torch.int32)
    found = torch.zeros_like(valid)
    keys_l = keys.long()
    for p in range(probes):
        slot = (h + p) & (T - 1)
        hit = (keys_l[slot] == ad).all(dim=1) & ~found
        campaign = torch.where(hit, vals[slot], campaign)
        found = found | hit

    vt = take(e - (TM_OFF + 4), 4)
    # byte by byte against scalars: no host-to-device copy, so the plain
    # version can be captured in a CUDA graph and timed as the kernel is
    is_view = valid.clone()
    for i, c in enumerate(b"view"):
        is_view &= vt[:, i] == c

    d = take(e - DIG_OFF, TIME_DIGITS) - 48
    hi = ((d[:, 0] * 10 + d[:, 1]) * 10 + d[:, 2]) * 10 + d[:, 3]
    lo = d[:, 4]
    for k in range(5, TIME_DIGITS):
        lo = lo * 10 + d[:, k]
    # the reference's int32 ops wrap at every step; the exact value mod
    # 2^32, read as signed, is the same number
    t = ((hi - base_hi) * 1_000_000_000 + (lo - base_lo)) & _U32
    rel = torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)

    campaign = torch.where(valid, campaign, -1)
    rel = torch.where(valid, rel, 0)
    return (campaign.reshape(shape), is_view.reshape(shape),
            rel.reshape(shape), valid.reshape(shape))


def _check_meta(meta, keys, buf) -> None:
    T = keys.shape[0]
    tp, up = meta_layout(T)
    if (meta.dtype != torch.int32 or tuple(meta.shape) != (2 * tp + up,)
            or not meta.is_contiguous()):
        raise ValueError(f"meta must be a contiguous int32 [{2 * tp + up}] "
                         f"tensor (slot_meta of a {T}-slot table), got "
                         f"{meta.dtype} of shape {tuple(meta.shape)}")
    if meta.device != buf.device:
        raise ValueError(f"meta is on {meta.device}, buf on {buf.device}")
    # one bulk copy stages meta; the kernel reads keys a word at a time
    if meta.data_ptr() % 16 or keys.data_ptr() % 4:
        raise ValueError("meta must be 16-byte and keys 4-byte aligned")


def decode_rows(buf: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                keys: torch.Tensor, vals: torch.Tensor, probes: int,
                base_hi: int, base_lo: int, *,
                meta: torch.Tensor | None = None):
    """Decode the rows ``(starts, lens)`` of ``buf``: ``(campaign int32,
    is_view bool, rel int32, valid bool)``, each shaped as ``starts``.

    ``buf`` uint8 ``[cap]``; ``starts``/``lens`` int32, any shape;
    ``keys`` uint8 ``[T, 36]`` and ``vals`` int32 ``[T]``, ``T`` a power
    of two, a table ``build_ad_table`` filled by linear probing; all
    contiguous, on one device.  On a CUDA device the kernel also needs
    ``meta``, ``slot_meta`` of the same table as int32 (it probes that,
    and verifies against ``keys``).  ``decode_rows.launches`` counts
    kernel launches (CPU calls do not launch and do not count)."""
    _check(buf, starts, lens, keys, vals)
    if not buf.is_cuda:
        if buf.device.type == "cpu":
            return decode_rows_plain(buf, starts, lens, keys, vals, probes,
                                     base_hi, base_lo)
        raise ValueError(f"decode_rows runs on cuda or cpu, not "
                         f"{buf.device}")
    if meta is None:
        raise ValueError("decode_rows on cuda needs the table's meta "
                         "(ops.decode.slot_meta)")
    _check_meta(meta, keys, buf)
    shape = starts.shape
    campaign = torch.empty(shape, dtype=torch.int32, device=buf.device)
    rel = torch.empty(shape, dtype=torch.int32, device=buf.device)
    is_view = torch.empty(shape, dtype=torch.bool, device=buf.device)
    valid = torch.empty(shape, dtype=torch.bool, device=buf.device)
    if starts.numel() == 0:
        return campaign, is_view, rel, valid
    index = buf.get_device()
    _launch(buf, starts, lens, keys, meta, probes, base_hi, base_lo,
            (campaign, is_view, rel, valid), index,
            # the plan reads cap only as cap >= 16: one cache entry serves
            # every block's buffer
            _cached_plan(keys.shape[0], min(buf.shape[0], 16),
                         buf.data_ptr() % 16, starts.numel(), index))
    return campaign, is_view, rel, valid


def _launch(buf, starts, lens, keys, meta, probes: int, base_hi: int,
            base_lo: int, outs, index: int, plan: _PlanArgs) -> None:
    """One launch of K2 on CUDA device ``index``'s current stream with
    ``plan`` into the four ``outs``; raises when the library cannot be
    built or the launch is refused, and counts only a launch that was
    made."""
    lib = _build.decode_rows_lib()
    campaign, is_view, rel, valid = outs
    # the plan is held while the launch reads it (the cache may drop it)
    _build.launch(
        "decode_rows", lib.sb_decode_rows, index,
        buf.data_ptr(), buf.shape[0], starts.data_ptr(), lens.data_ptr(),
        starts.numel(), keys.data_ptr(), meta.data_ptr(), keys.shape[0],
        int(probes), int(base_hi), int(base_lo), campaign.data_ptr(),
        is_view.data_ptr(), rel.data_ptr(), valid.data_ptr(),
        ctypes.addressof(plan))
    decode_rows.launches += 1


decode_rows.launches = 0
