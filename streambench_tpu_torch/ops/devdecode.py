"""On-device event decode: raw journal bytes -> columns -> the window fold.

The port of ``streambench_tpu/ops/devdecode.py``.  The host ships each
journal block as ONE ``uint8`` buffer plus per-row (start, len)
vectors, and the device does, per dispatch:

- fixed-schema field extraction, the ``event_type == "view"`` filter,
  the ad -> campaign join against a device-resident open-addressed hash
  table (FNV-1a over the 36 ad bytes, linear probing with a build-time
  probe bound) and the 13-digit event-time parse: all of it in ONE launch
  of K2 (``ops.decode.decode_rows``, ``csrc/decode_rows.cu``) over the
  whole ``[kp, B]`` dispatch, where the reference fuses it into its
  jitted step;
- then per row group the port's ``assign_windows`` + ``apply_count``
  with the engine's method, so on the card the count is K1.

What stays on the host is a probe, not an encode: one C pass
(``native/encoder.cpp:sb_probe_block``; numpy fallback below) that finds
record boundaries, validates the fixed layout byte for byte without
building any columns, and parses the times the host loop needs anyway
for the ring-span guard and the watermark mirror.  Rows that fail the
probe go back through the host encoder verbatim, so bad-line counting
and dead-letter behaviour are identical to the host arms.

Threading: the ingest pipeline runs ``DeviceDecoder.prepare`` on its
encode thread, where the port touches no torch, so ``prepare`` is numpy
only and keeps a host copy of the block's bytes (``RawBlock``).  The first ``fold``
that reads a block uploads it once, on the host loop; the halves of a
span-guard split share that upload.

Differences from the reference: the decode is a hand-written kernel and
not part of a jitted scan; the group loop is Python; the method table
and its ``<device type>/devdecode`` A/B winner live in the port's own
cache (``ops.methodbench``).
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from streambench_tpu_torch.ops import methodbench
from streambench_tpu_torch.ops import windowcount as wc
from streambench_tpu_torch.ops.decode import (
    AD_OFF,
    ADTYPE_OFF,
    DIG_OFF,
    FNV_OFFSET,
    FNV_PRIME,
    HEAD,
    LIT_AD,
    LIT_ADTYPE,
    LIT_ET,
    LIT_PAGE,
    LIT_TM,
    MIN_ROW,
    SUF_OFF,
    SUFFIX,
    TM_OFF,
    UUID_LEN,
    decode_rows,
    slot_meta,
)

_EVENT_TYPES = (b"view", b"click", b"purchase")


def fnv1a32(data: bytes) -> int:
    h = FNV_OFFSET
    for c in data:
        h = ((h ^ c) * FNV_PRIME) & 0xFFFFFFFF
    return h


# ----------------------------------------------------------------------
# Device-resident ad -> campaign join table
def build_ad_table(ads: list[bytes], campaign_idx: np.ndarray, *,
                   with_used: bool = False):
    """Open-addressed (linear probe) hash table over 36-byte ad ids.

    Returns ``(keys [T, 36] uint8, vals [T] int32, max_probes)`` with
    ``T`` a power of two sized for load factor <= 0.5, and with
    ``with_used`` a fourth value, ``used [T]`` bool: the slots it filled
    (K2 stops a probe at the first unused one; ``ops.decode.slot_meta``).
    Empty slots hold val -1 and an all-zero key no uuid can equal, so a
    probe that exhausts ``max_probes`` without a key match yields
    campaign -1, the host encoder's unknown-ad semantics.
    """
    if not ads:
        raise ValueError("device decode needs a non-empty ad table")
    if any(len(a) != UUID_LEN for a in ads):
        raise ValueError(
            "device decode requires fixed 36-byte ad ids (the generator's "
            "uuid wire format); got other lengths")
    T = 1 << max((2 * len(ads) - 1).bit_length(), 3)
    keys = np.zeros((T, UUID_LEN), np.uint8)
    vals = np.full(T, -1, np.int32)
    used = np.zeros(T, bool)
    max_probes = 1
    for ad, c in zip(ads, campaign_idx):
        h = fnv1a32(ad)
        p = 0
        while used[(h + p) & (T - 1)]:
            p += 1
        slot = (h + p) & (T - 1)
        used[slot] = True
        keys[slot] = np.frombuffer(ad, np.uint8)
        vals[slot] = int(c)
        max_probes = max(max_probes, p + 1)
    if with_used:
        return keys, vals, max_probes, used
    return keys, vals, max_probes


# ----------------------------------------------------------------------
# Host probe: record boundaries + full layout validation + times, no
# columns.  C fast path; numpy fallback when the native library is
# unavailable.
def _probe_native(lib, data, n_hint: int):
    starts_l, lens_l, times_l, ok_l = [], [], [], []
    cap = max(min(n_hint, 1 << 16), 1024)
    pos = 0
    i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    while pos < len(data):
        starts = np.empty(cap, np.int32)
        lens = np.empty(cap, np.int32)
        times = np.empty(cap, np.int64)
        ok = np.empty(cap, np.uint8)
        n = int(lib.sb_probe_block(
            data, len(data), pos, cap, i32p(starts), i32p(lens),
            times.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))))
        if n == 0:
            break
        starts_l.append(starts[:n])
        lens_l.append(lens[:n])
        times_l.append(times[:n])
        ok_l.append(ok[:n])
        pos = int(starts[n - 1]) + int(lens[n - 1]) + 1
    if not starts_l:
        z = np.empty(0, np.int32)
        return z, z.copy(), np.empty(0, np.int64), np.empty(0, bool)
    cat = (lambda xs: xs[0] if len(xs) == 1 else np.concatenate(xs))
    return (cat(starts_l), cat(lens_l), cat(times_l),
            cat(ok_l).astype(bool))


def _tmpl_positions():
    """(positions, bytes) of every fixed HEAD byte, and the same for the
    end-relative tail (suffix + time literal)."""
    head = {}
    for off, lit in ((0, HEAD), (49, LIT_PAGE), (100, LIT_AD),
                     (149, LIT_ADTYPE)):
        for i, b in enumerate(lit):
            head[off + i] = b
    tail = {}
    for off, lit in ((-SUF_OFF, SUFFIX), (-TM_OFF, LIT_TM)):
        for i, b in enumerate(lit):
            tail[off + i] = b
    hp = np.asarray(sorted(head), np.int64)
    tp = np.asarray(sorted(tail), np.int64)
    return (hp, np.asarray([head[int(p)] for p in hp], np.uint8),
            tp, np.asarray([tail[int(p)] for p in tp], np.uint8))


_HP, _HB, _TP, _TB = _tmpl_positions()


def _probe_numpy(arr: np.ndarray):
    """Pure-numpy probe: the same accept predicate as ``sb_probe_block``
    (differential-tested); the fallback when the native library is
    unavailable."""
    nl = np.flatnonzero(arr == 10)
    if nl.size == 0:
        z = np.empty(0, np.int32)
        return z, z.copy(), np.empty(0, np.int64), np.empty(0, bool)
    starts = np.empty(nl.size, np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    ends = nl
    lens = ends - starts
    ok = lens >= MIN_ROW
    s = np.where(ok, starts, 0)
    e = np.where(ok, ends, MIN_ROW)
    # pad so clamped gathers of not-ok rows stay in bounds
    if arr.size < MIN_ROW:
        arr = np.concatenate([arr, np.zeros(MIN_ROW, np.uint8)])
    ok &= (arr[s[:, None] + _HP[None, :]] == _HB).all(axis=1)
    ok &= (arr[e[:, None] + _TP[None, :]] == _TB).all(axis=1)
    # quote-free uuid fields (a quote inside a 36-byte span would make
    # the host token parser see a different structure)
    for off in (13, 64, AD_OFF):
        span = arr[s[:, None] + (off + np.arange(UUID_LEN))[None, :]]
        ok &= ~(span == ord('"')).any(axis=1)
    d = arr[e[:, None] + np.arange(-DIG_OFF, -SUF_OFF)[None, :]]
    digits_ok = ((d >= 48) & (d <= 57)).all(axis=1)
    ok &= digits_ok
    times = np.where(
        digits_ok,
        (d.astype(np.int64) - 48) @ (10 ** np.arange(12, -1, -1)), 0)
    # event type: full literal match, anchored at the end
    et_len = np.zeros(nl.size, np.int64)
    for name in _EVENT_TYPES:
        lit = LIT_ET + name
        p = np.arange(-TM_OFF - len(lit), -TM_OFF)
        m = (arr[e[:, None] + p[None, :]]
             == np.frombuffer(lit, np.uint8)).all(axis=1)
        et_len = np.where(m, len(name), et_len)
    ok &= et_len > 0
    # ad_type: non-empty and quote-free between the fixed head and tail
    at_len = lens - 240 - et_len
    ok &= at_len >= 1
    at_max = int(at_len[ok].max()) if ok.any() else 0
    if at_max > 0:
        span = arr[s[:, None] + (ADTYPE_OFF + np.arange(at_max))[None, :]]
        quote = (span == ord('"')) & (np.arange(at_max)[None, :]
                                      < at_len[:, None])
        ok &= ~quote.any(axis=1)
    return (starts.astype(np.int32), lens.astype(np.int32),
            np.where(ok, times, 0), ok)


def probe_block(data, *, native: bool | None = None):
    """``(starts, lens, times_abs, ok)`` for every complete record in
    ``data`` (an incomplete trailing record is not scanned).  ``native``
    forces the C/numpy implementation; default tries C first."""
    if isinstance(data, np.ndarray):
        buf = data.tobytes() if native is not False else None
        arr = data
    else:
        buf = data
        arr = None
    lib = None
    if native is not False:
        from streambench_tpu_torch import native as _native

        lib = _native.load()
    if lib is not None and native is not False:
        if buf is None:
            buf = arr.tobytes()
        return _probe_native(lib, buf, len(buf) // MIN_ROW + 2)
    if arr is None:
        arr = np.frombuffer(data, np.uint8)
    return _probe_numpy(arr)


# ----------------------------------------------------------------------
# The decode + fold
def decode_fold_scan(state: wc.WindowState, buf: torch.Tensor,
                     starts: torch.Tensor, lens: torch.Tensor,
                     keys: torch.Tensor, vals: torch.Tensor, base_hi: int,
                     base_lo: int, *, divisor_ms: int, lateness_ms: int,
                     method: str, probes: int,
                     meta: torch.Tensor | None = None) -> wc.WindowState:
    """Decode + filter + join + fold ``[K, B]`` row groups out of ONE
    shared byte buffer: one K2 launch over all ``K * B`` rows (``meta``:
    the table's ``slot_meta``, which the kernel needs on a card), then per
    group the window claim and the count (``state.counts`` in place, as
    ``windowcount.step``)."""
    campaign, is_view, rel, valid = decode_rows(
        buf, starts, lens, keys, vals, probes, base_hi, base_lo, meta=meta)
    for k in range(starts.shape[0]):
        wid = torch.div(rel[k], divisor_ms, rounding_mode="floor")
        wanted = valid[k] & is_view[k] & (campaign[k] >= 0)
        slot, count_mask, window_ids, watermark = wc.assign_windows(
            state.window_ids, state.watermark, wid, wanted, valid[k],
            rel[k], divisor_ms=divisor_ms, lateness_ms=lateness_ms)
        counts = wc.apply_count(state.counts, campaign[k], slot, count_mask,
                                method)
        dropped = state.dropped + (wanted.sum(dtype=torch.int32)
                                   - count_mask.sum(dtype=torch.int32))
        state = wc.WindowState(counts, window_ids, watermark, dropped)
    return state


# ----------------------------------------------------------------------
class RawBlock:
    """One journal block's bytes in a host buffer, shared by the
    prepared blocks cut from it and their halves.  ``on(device)`` uploads
    it once, on the host loop, and hands every later caller the same
    device tensor.  ``counted`` marks that the transfer ledger has taken
    its bytes."""

    def __init__(self, host: np.ndarray):
        self.host = host
        self.nbytes = int(host.nbytes)
        self.counted = False
        self._dev: torch.Tensor | None = None

    def on(self, device: torch.device) -> torch.Tensor:
        if self._dev is None:
            self._dev = torch.from_numpy(self.host).to(device)
        return self._dev


class PreparedBlock:
    """One probed journal block, ready for device dispatch.

    Duck-types the ``EncodedBatch`` surface the host bookkeeping reads
    (``n``, ``valid``, ``event_time`` as relative int32 ms of the
    probe-ok rows, ``base_time_ms``, the ``_lc_*`` attribution stamps),
    so the watermark mirror, span guard and obs lifecycle treat it like
    any encoded batch.  It carries no columns: the bytes ride raw.
    """

    is_device_block = True

    def __init__(self, raw: RawBlock, starts: np.ndarray, lens: np.ndarray,
                 rel_times: np.ndarray, base_time_ms: int,
                 batch_size: int):
        self.raw = raw
        self.starts = starts
        self.lens = lens
        self.event_time = rel_times
        self.base_time_ms = base_time_ms
        self.batch_size = batch_size
        self.n = int(starts.shape[0])
        self.valid = np.ones(self.n, bool)
        self._lc_read_ms = None
        self._lc_encode_ms = None

    def halves(self) -> tuple["PreparedBlock", "PreparedBlock"]:
        """Split for the span-guard recursion; the byte buffer (and its
        upload) is shared, only the row vectors split."""
        mid = self.n // 2
        lo = PreparedBlock(self.raw, self.starts[:mid], self.lens[:mid],
                           self.event_time[:mid], self.base_time_ms,
                           self.batch_size)
        hi = PreparedBlock(self.raw, self.starts[mid:], self.lens[mid:],
                           self.event_time[mid:], self.base_time_ms,
                           self.batch_size)
        for part in (lo, hi):
            part._lc_read_ms = self._lc_read_ms
            part._lc_encode_ms = self._lc_encode_ms
        return lo, hi


class DeviceDecoder:
    """Per-engine device-decode driver: owns the device-resident join
    table and turns raw journal blocks into :class:`PreparedBlock`\\ s
    plus the probe-rejected lines the engine re-encodes on the host."""

    def __init__(self, encoder, *, batch_size: int, scan_batches: int,
                 divisor_ms: int, lateness_ms: int,
                 device: torch.device | str):
        keys, vals, probes, used = build_ad_table(
            [a.encode() for a in encoder.ads],
            encoder.join_table[:-1], with_used=True)
        self.device = torch.device(device)
        self.keys = torch.from_numpy(keys).to(self.device)
        self.vals = torch.from_numpy(vals).to(self.device)
        # K2's view of the table: slot tags, vals and used bits, staged in
        # shared memory by each block (built and uploaded once)
        self.meta = torch.from_numpy(
            slot_meta(keys, vals, used).view(np.int32)).to(self.device)
        self.probes = probes
        self.encoder = encoder
        self.batch_size = max(int(batch_size), 1)
        self.scan_batches = max(int(scan_batches), 1)
        self.divisor_ms = divisor_ms
        self.lateness_ms = lateness_ms
        # telemetry (single-writer ints, GIL-safe)
        self.rows_decoded = 0
        self.rows_fallback = 0
        self.probe_ms_total = 0.0

    # ------------------------------------------------------------------
    def prepare(self, data: bytes
                ) -> tuple[list[PreparedBlock], list[bytes]]:
        """Probe one raw block (numpy and the C probe only: no torch, so
        the ingest pipeline's encode thread may call it).  Returns the
        device-ready blocks and the probe-rejected raw lines (host-encoder
        fallback, in journal order).  Establishes the encoder's
        ``base_time_ms`` from the first probe-ok row when unset (the
        host encoder's rebase rule for its first parsed event)."""
        t0 = time.perf_counter()
        starts, lens, times, ok = probe_block(data)
        bad_lines: list[bytes] = []
        blocks: list[PreparedBlock] = []
        if starts.size == 0:
            self.probe_ms_total += (time.perf_counter() - t0) * 1e3
            return blocks, bad_lines
        base = self.encoder.base_time_ms
        if base is None and bool(ok.any()):
            t_first = int(times[int(np.flatnonzero(ok)[0])])
            base = (t_first - (t_first % self.divisor_ms)
                    - self.lateness_ms)
            self.encoder.set_base_time(base)
        if base is not None and ok.any():
            rel = times - base
            # rebased time must fit the int32 column (the host fallback
            # applies the same rule); out-of-range rows fall back
            ok = ok & (rel >= -(1 << 31)) & (rel < (1 << 31))
        if not bool(ok.all()):
            for i in np.flatnonzero(~ok).tolist():
                s = int(starts[i])
                bad_lines.append(bytes(data[s:s + int(lens[i])]))
            self.rows_fallback += len(bad_lines)
        n_ok = int(ok.sum())
        if n_ok:
            # one copy of the block's bytes, shared by every group of the
            # block (the caller may reuse ``data``'s buffer); K2 takes its
            # length as an argument, so it needs no compile-bucket padding
            raw = RawBlock(np.frombuffer(data, np.uint8).copy())
            s_ok = starts[ok]
            l_ok = lens[ok]
            rel32 = (times[ok] - base).astype(np.int32)
            per = self.batch_size * self.scan_batches
            for off in range(0, n_ok, per):
                blocks.append(PreparedBlock(
                    raw, s_ok[off:off + per], l_ok[off:off + per],
                    rel32[off:off + per], base, self.batch_size))
            self.rows_decoded += n_ok
        self.probe_ms_total += (time.perf_counter() - t0) * 1e3
        return blocks, bad_lines

    # ------------------------------------------------------------------
    def fold(self, state: wc.WindowState, block: PreparedBlock, *,
             method: str) -> wc.WindowState:
        """Dispatch one prepared block: its rows padded to a
        power-of-two number of ``B``-row groups (the reference's compile
        buckets; every group is folded, pad groups included, so the
        state matches the reference's bit for bit), one K2 launch per
        dispatch and the fold of each group."""
        B = block.batch_size
        base = int(block.base_time_ms)
        buf = block.raw.on(self.device)
        per = B * self.scan_batches
        for off in range(0, block.n, per):
            s = block.starts[off:off + per]
            k = -(-s.shape[0] // B)
            kp = 1
            while kp < k:
                kp *= 2
            rows = np.zeros((2, kp * B), np.int32)
            rows[0, :s.shape[0]] = s
            rows[1, :s.shape[0]] = block.lens[off:off + per]
            # starts and lens in one host-to-device copy
            rows_dev = torch.from_numpy(rows).to(self.device)
            state = decode_fold_scan(
                state, buf, rows_dev[0].view(kp, B),
                rows_dev[1].view(kp, B), self.keys, self.vals,
                base // 1_000_000_000, base % 1_000_000_000,
                divisor_ms=self.divisor_ms, lateness_ms=self.lateness_ms,
                method=method, probes=self.probes, meta=self.meta)
        return state

    def warmup(self, state: wc.WindowState, *, method: str
               ) -> wc.WindowState:
        """One decode + fold of a group of ``B`` pad rows (every row
        invalid, so the state is unchanged): builds K2 before the first
        real block."""
        buf = torch.zeros(1 << 12, dtype=torch.uint8, device=self.device)
        rows = torch.zeros((1, self.batch_size), dtype=torch.int32,
                           device=self.device)
        return decode_fold_scan(
            state, buf, rows, rows, self.keys, self.vals, 0, 0,
            divisor_ms=self.divisor_ms, lateness_ms=self.lateness_ms,
            method=method, probes=self.probes, meta=self.meta)

    def telemetry(self) -> dict:
        return {
            "rows_decoded": self.rows_decoded,
            "rows_fallback": self.rows_fallback,
            "probe_ms_total": round(self.probe_ms_total, 3),
        }


# ----------------------------------------------------------------------
# auto gating: the measured A/B of the run's ingest mode decides
# (chip_smoke.py records one per mode in the port's method cache: the
# winner differs between the serial loop and the staged pipeline);
# without a measurement the device arm is assumed to pay on the card and
# not on the CPU.
def ab_key(device_type: str, pipelined: bool) -> str:
    """The method-cache key of the decode A/B for one ingest mode."""
    return (f"{device_type}/devdecode/"
            f"{'pipelined' if pipelined else 'serial'}")


def auto_enabled(device_type: str, pipelined: bool) -> bool:
    """Whether ``jax.decode.device: auto`` decodes on the device of
    ``device_type`` (``"cuda"`` or ``"cpu"``) under the serial loop or,
    with ``pipelined``, the staged ingest pipeline."""
    winner = methodbench.cached_value(ab_key(device_type, pipelined))
    if winner is not None:
        return winner.get("winner") == "device"
    return device_type != "cpu"
