"""K2: device decode of raw journal rows, as a hand-written CUDA kernel.

``decode_rows(buf, starts, lens, keys, vals, probes, base_hi, base_lo)``
turns the bytes of each row ``buf[starts[r] : starts[r] + lens[r]]`` of
the generator's fixed JSON skeleton into four columns: the ad's campaign
(an FNV-1a hash of the 36 ad-id bytes, linear-probed against the
``keys``/``vals`` table of ``ops.devdecode.build_ad_table``; -1 when the
ad is unknown), whether the event is a view, its time in ms relative to
``base_hi * 10^9 + base_lo`` (int32), and whether the row is real (pad
rows have ``lens == 0``).  It replaces no Pallas kernel: it is the port
of the XLA fusion ``streambench_tpu/ops/devdecode.py:_decode_columns``,
whose eager torch form would run to ~150 launches per row group
(``csrc/decode_rows.cu`` gives the design and the bound).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs ``decode_rows_plain``, the transcription of
``_decode_columns`` in torch ops, which ``chip_smoke.py`` also holds the
kernel against on the card.  Pad rows come out as ``campaign -1,
is_view False, rel 0, valid False`` from both (the reference decodes
garbage there, which the fold masks).  No single PyTorch call computes
this function, so there is no library yardstick for it.

The byte layout is the generator's wire format, the contract the host
probe (``native/encoder.cpp:sb_probe_block``) validates row by row.
"""

from __future__ import annotations

import contextlib

import torch

from streambench_tpu_torch.ops import _build
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


def decode_rows(buf: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
                keys: torch.Tensor, vals: torch.Tensor, probes: int,
                base_hi: int, base_lo: int):
    """Decode the rows ``(starts, lens)`` of ``buf``: ``(campaign int32,
    is_view bool, rel int32, valid bool)``, each shaped as ``starts``.

    ``buf`` uint8 ``[cap]``; ``starts``/``lens`` int32, any shape;
    ``keys`` uint8 ``[T, 36]`` and ``vals`` int32 ``[T]``, ``T`` a power
    of two; all contiguous, on one device.  ``decode_rows.launches``
    counts kernel launches (CPU calls do not launch and do not count)."""
    _check(buf, starts, lens, keys, vals)
    if not buf.is_cuda:
        if buf.device.type == "cpu":
            return decode_rows_plain(buf, starts, lens, keys, vals, probes,
                                     base_hi, base_lo)
        raise ValueError(f"decode_rows runs on cuda or cpu, not "
                         f"{buf.device}")
    shape = starts.shape
    campaign = torch.empty(shape, dtype=torch.int32, device=buf.device)
    rel = torch.empty(shape, dtype=torch.int32, device=buf.device)
    is_view = torch.empty(shape, dtype=torch.bool, device=buf.device)
    valid = torch.empty(shape, dtype=torch.bool, device=buf.device)
    rows = starts.numel()
    if rows == 0:
        return campaign, is_view, rel, valid
    index = buf.get_device()
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        _launch(buf, starts, lens, keys, vals, probes, base_hi, base_lo,
                (campaign, is_view, rel, valid),
                torch._C._cuda_getCurrentRawStream(index))
    return campaign, is_view, rel, valid


def _launch(buf, starts, lens, keys, vals, probes: int, base_hi: int,
            base_lo: int, outs, stream: int) -> None:
    """One launch of K2 on ``stream`` into the four ``outs``; raises
    when the library cannot be built or the launch is refused, and
    counts only a launch that was made."""
    lib = _build.decode_rows_lib()
    campaign, is_view, rel, valid = outs
    rc = lib.sb_decode_rows(
        buf.data_ptr(), buf.shape[0], starts.data_ptr(), lens.data_ptr(),
        starts.numel(), keys.data_ptr(), vals.data_ptr(), keys.shape[0],
        int(probes), int(base_hi), int(base_lo), campaign.data_ptr(),
        is_view.data_ptr(), rel.data_ptr(), valid.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"decode_rows kernel launch failed: CUDA error "
                           f"{rc}")
    decode_rows.launches += 1


decode_rows.launches = 0
