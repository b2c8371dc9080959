"""Native-backed EventEncoder: same contract, C++ hot path.

Drop-in subclass of ``EventEncoder``: the fixed-layout JSON scan, string
interning, and column fill run in ``libsbnative.so``; only lines the native
scanner rejects (layout mismatch) take the Python ``json.loads`` fallback,
interned through the same native maps so indices stay consistent.

Use ``make_encoder()`` to get the native version when the library builds
and the pure-Python one otherwise.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np

from streambench_tpu_torch import native
from streambench_tpu_torch.encode.encoder import (
    AD_TYPE_INDEX,
    EVENT_TYPE_INDEX,
    EncodedBatch,
    EventEncoder,
    _id_hash32,
)


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# Mirrors kBaseUnset in encoder.cpp: INT64_MIN marks "no base yet".  A
# plain "< 0" check would conflate unset with the legitimately negative
# bases produced by small (synthetic/test) event times.
BASE_UNSET = -(1 << 63)


class NativeEventEncoder(EventEncoder):
    RELEASES_GIL = True  # the ctypes scan runs GIL-free (see base class)

    def __init__(self, ad_to_campaign: dict[str, str],
                 campaigns: list[str] | None = None,
                 divisor_ms: int = 10_000, lateness_ms: int = 60_000):
        super().__init__(ad_to_campaign, campaigns,
                         divisor_ms=divisor_ms, lateness_ms=lateness_ms)
        lib = native.load()
        if lib is None:
            raise RuntimeError("native encoder library unavailable")
        self._lib = lib
        ads_b = [a.encode() for a in self.ads]
        offsets = np.zeros(len(ads_b) + 1, np.int64)
        np.cumsum([len(a) for a in ads_b], out=offsets[1:])
        self._enc = lib.sb_encoder_new(
            b"".join(ads_b),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(ads_b), divisor_ms, lateness_ms)

    def set_intern_ids(self, on: bool) -> None:
        super().set_intern_ids(on)
        self._lib.sb_encoder_set_intern_ids(self._enc, 1 if on else 0)

    def set_hash_ids(self, on: bool) -> None:
        super().set_hash_ids(on)  # python encode_tbl fallback shares it
        self._lib.sb_encoder_set_hash_ids(self._enc, 1 if on else 0)

    def set_base_time(self, base_time_ms: int | None) -> None:
        super().set_base_time(base_time_ms)
        self._lib.sb_encoder_set_base_time(
            self._enc, BASE_UNSET if base_time_ms is None else base_time_ms)

    def dump_intern_tables(self) -> tuple[list[bytes], list[bytes]]:
        out = []
        for n_fn, bytes_fn, dump_fn in (
                (self._lib.sb_encoder_n_users,
                 self._lib.sb_encoder_users_bytes,
                 self._lib.sb_encoder_dump_users),
                (self._lib.sb_encoder_n_pages,
                 self._lib.sb_encoder_pages_bytes,
                 self._lib.sb_encoder_dump_pages)):
            n = int(n_fn(self._enc))
            buf = ctypes.create_string_buffer(max(int(bytes_fn(self._enc)), 1))
            offsets = np.zeros(n + 1, np.int64)
            dump_fn(self._enc, buf,
                    offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            raw = buf.raw
            out.append([raw[offsets[i]:offsets[i + 1]] for i in range(n)])
        return out[0], out[1]

    def user_key(self, idx: int) -> bytes:
        """Reverse lookup of an interned user index (heavy-hitter
        reports): the C-side table dumps once and re-dumps only when a
        newer index appears."""
        cache = getattr(self, "_user_key_cache", None)
        if cache is None or idx >= len(cache):
            cache, _ = self.dump_intern_tables()
            self._user_key_cache = cache
        return cache[idx]

    def num_interned_users(self) -> int:
        return int(self._lib.sb_encoder_n_users(self._enc))

    def _intern(self, table: dict, key: bytes) -> int:
        """Python-side parse paths (the tbl wire format, encode_tbl)
        must intern through the SAME C-side maps the native scanner
        uses — a Python-dict side table would make reverse lookups and
        intern snapshots see only part of the universe."""
        fn = (self._lib.sb_intern_user if table is self.user_index
              else self._lib.sb_intern_page)
        return int(fn(self._enc, key, len(key)))

    def restore_intern_tables(self, users: list[bytes],
                              pages: list[bytes]) -> None:
        if self._lib.sb_encoder_n_users(self._enc) or \
                self._lib.sb_encoder_n_pages(self._enc):
            raise ValueError(
                "restore_intern_tables on a used encoder: intern indices "
                "would diverge from the snapshot; restore into a fresh "
                "engine instead")
        for table, fn, keys in (("user", self._lib.sb_intern_user, users),
                                ("page", self._lib.sb_intern_page, pages)):
            for i, k in enumerate(keys):
                got = fn(self._enc, bytes(k), len(k))
                if got != i:
                    raise ValueError(
                        f"{table} intern diverged on restore: key {k!r} "
                        f"re-interned to {got}, snapshot says {i} "
                        "(duplicate or corrupted dump?)")

    def __del__(self):  # pragma: no cover - interpreter teardown order
        lib = getattr(self, "_lib", None)
        enc = getattr(self, "_enc", None)
        if lib is not None and enc is not None:
            lib.sb_encoder_free(enc)

    def encode(self, lines: list[bytes], batch_size: int | None = None
               ) -> EncodedBatch:
        B = batch_size if batch_size is not None else len(lines)
        nl = len(lines)
        if nl > B:
            raise ValueError(f"{nl} lines exceed batch size {B}")
        buf = b"".join(lines)
        offsets = np.zeros(nl + 1, np.int64)
        np.cumsum([len(l) for l in lines], out=offsets[1:])

        ad_idx = np.zeros(B, np.int32)
        etype = np.full(B, -1, np.int32)
        etime = np.zeros(B, np.int32)
        user_idx = np.zeros(B, np.int32)
        page_idx = np.zeros(B, np.int32)
        ad_type = np.full(B, -1, np.int32)
        status = np.zeros(B, np.uint8)

        self._lib.sb_encode_json(
            self._enc, buf,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nl,
            _i32p(ad_idx), _i32p(etype), _i32p(etime), _i32p(user_idx),
            _i32p(page_idx), _i32p(ad_type),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))

        # Python fallback for layout-mismatch lines (rare: hand-written or
        # re-ordered JSON), through the native intern maps.
        for i in np.flatnonzero(status[:nl] == 2).tolist():
            self.fallback_lines += 1
            rec = self._parse_fallback(lines[i])
            if rec is None:
                self._reject(lines[i])
                status[i] = 0
                continue
            (ad_idx[i], etype[i], etime[i], user_idx[i], page_idx[i],
             ad_type[i]) = rec
            status[i] = 1

        valid = status == 1
        n = int(valid.sum())
        if n != nl:
            # compact valid rows to the front (engine reads [:n]); tail
            # rows revert to the padding defaults (ad 0 / types -1 / t 0)
            keep = np.flatnonzero(valid)
            for col, pad in ((ad_idx, 0), (etype, -1), (etime, 0),
                             (user_idx, 0), (page_idx, 0), (ad_type, -1)):
                col[:n] = col[keep]
                col[n:] = pad
            valid = np.zeros(B, bool)
            valid[:n] = True
        self.base_time_ms = base = self._lib.sb_encoder_base_time(self._enc)
        if base == BASE_UNSET:
            self.base_time_ms = None
        return EncodedBatch(ad_idx, etype, etime, user_idx, page_idx,
                            ad_type, valid, n=n,
                            base_time_ms=self.base_time_ms
                            if self.base_time_ms is not None else 0)

    def encode_block(self, data: bytes, batch_size: int,
                     start: int = 0,
                     end: int | None = None) -> tuple[EncodedBatch, int]:
        """Encode up to ``batch_size`` records straight from a raw
        journal block (complete newline-delimited lines), starting at
        byte ``start`` and never reading past ``end`` (default: the
        whole block).  Returns ``(batch, consumed_bytes)``.

        This is the zero-copy ingest path: no per-line bytes objects,
        no join/offsets round trip — the C scanner finds record
        boundaries (memchr) and parses in the same pass.  An incomplete
        trailing record is not consumed.  The ``end`` bound lets several
        workers scan disjoint regions of ONE shared block without
        slicing (a slice would copy megabytes per sub-block).
        """
        B = batch_size
        bound = len(data) if end is None else min(end, len(data))
        ad_idx = np.zeros(B, np.int32)
        etype = np.full(B, -1, np.int32)
        etime = np.zeros(B, np.int32)
        user_idx = np.zeros(B, np.int32)
        page_idx = np.zeros(B, np.int32)
        ad_type = np.full(B, -1, np.int32)
        status = np.zeros(B, np.uint8)
        rec_off = np.zeros(B + 1, np.int64)

        nl = int(self._lib.sb_encode_block(
            self._enc, data, bound, start, B,
            _i32p(ad_idx), _i32p(etype), _i32p(etime), _i32p(user_idx),
            _i32p(page_idx), _i32p(ad_type),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            rec_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))))
        consumed = int(rec_off[nl]) - start

        # Python fallback for layout-mismatch records (slice them back
        # out of the block via the recorded offsets; newline-terminated)
        for i in np.flatnonzero(status[:nl] == 2).tolist():
            # rec_off[i + 1] always exists (i < nl): the record's end + 1
            line = data[int(rec_off[i]):int(rec_off[i + 1]) - 1]
            self.fallback_lines += 1
            rec = self._parse_fallback(line)
            if rec is None:
                self._reject(line)
                status[i] = 0
                continue
            (ad_idx[i], etype[i], etime[i], user_idx[i], page_idx[i],
             ad_type[i]) = rec
            status[i] = 1

        valid = status == 1
        n = int(valid.sum())
        if n != nl:
            keep = np.flatnonzero(valid)
            for col, pad in ((ad_idx, 0), (etype, -1), (etime, 0),
                             (user_idx, 0), (page_idx, 0), (ad_type, -1)):
                col[:n] = col[keep]
                col[n:] = pad
            valid = np.zeros(B, bool)
            valid[:n] = True
        self.base_time_ms = base = self._lib.sb_encoder_base_time(self._enc)
        if base == BASE_UNSET:
            self.base_time_ms = None
        return EncodedBatch(ad_idx, etype, etime, user_idx, page_idx,
                            ad_type, valid, n=n,
                            base_time_ms=self.base_time_ms
                            if self.base_time_ms is not None else 0), \
            consumed

    def carve_block(self, data: bytes, batch_size: int, start: int = 0,
                    max_batches: int | None = None,
                    end: int | None = None
                    ) -> tuple[list[EncodedBatch], int]:
        """Encode consecutive batches out of a raw block: returns the
        non-empty batches plus the offset where consumption stopped
        (either end-of-complete-records or the ``max_batches`` cap).
        The shared carve loop for every block-mode call site."""
        bound = len(data) if end is None else min(end, len(data))
        batches: list[EncodedBatch] = []
        while ((max_batches is None or len(batches) < max_batches)
               and start < bound):
            b, consumed = self.encode_block(data, batch_size, start, bound)
            if consumed <= 0:
                break
            start += consumed
            if b.n:
                batches.append(b)
        return batches, start

    def _parse_fallback(self, line: bytes):
        try:
            ev = json.loads(line)
            t = int(ev["event_time"])
        except (KeyError, ValueError, TypeError):
            return None
        if self._lib.sb_encoder_base_time(self._enc) == BASE_UNSET:
            self._lib.sb_encoder_set_base_time(
                self._enc,
                t - (t % self.divisor_ms) - self.lateness_ms)
        base = self._lib.sb_encoder_base_time(self._enc)
        if not (-2**31 <= t - base < 2**31):
            # rebased time must fit the int32 column; an absurd timestamp
            # (clock garbage, fuzzed input) is a bad line, not a crash
            return None
        ad = str(ev.get("ad_id", "")).encode()
        u = str(ev.get("user_id", "")).encode()
        p = str(ev.get("page_id", "")).encode()
        if self.hash_ids:
            # the fallback must mirror the fast path's id semantics: an
            # interned index here would be a phantom distinct user to the
            # HLL kernel (and could collide with other users' hashes)
            uid, pid = _id_hash32(u), _id_hash32(p)
        elif self.intern_ids:
            uid = self._lib.sb_intern_user(self._enc, u, len(u))
            pid = self._lib.sb_intern_page(self._enc, p, len(p))
        else:
            # stray fallback rows must not grow the maps or break the
            # zeros invariant when interning is off
            uid = pid = 0
        return (
            self.ad_index.get(ad, self.unknown_ad),
            EVENT_TYPE_INDEX.get(str(ev.get("event_type", "")), -1),
            t - base,
            uid,
            pid,
            AD_TYPE_INDEX.get(str(ev.get("ad_type", "")), -1),
        )


def make_encoder(ad_to_campaign: dict[str, str],
                 campaigns: list[str] | None = None,
                 divisor_ms: int = 10_000, lateness_ms: int = 60_000,
                 use_native: bool = True) -> EventEncoder:
    """Native encoder when available, else the pure-Python one."""
    if use_native and native.load() is not None:
        return NativeEventEncoder(ad_to_campaign, campaigns,
                                  divisor_ms=divisor_ms,
                                  lateness_ms=lateness_ms)
    return EventEncoder(ad_to_campaign, campaigns,
                        divisor_ms=divisor_ms, lateness_ms=lateness_ms)
