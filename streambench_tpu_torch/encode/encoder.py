"""Host-side event encoding: JSON lines -> fixed-shape int32 columnar batches.

This is the TPU analog of the JVM engines' deserialize stage
(``DeserializeBolt``, ``storm-benchmarks/.../AdvertisingTopology.java:44-70``)
— but instead of producing per-tuple objects, it produces *columns*: dense
int32 index arrays that a jitted aggregation step can gather/scatter on.
Everything dynamic (UUIDs, strings, JSON) dies here, at the host boundary;
nothing string-shaped ever reaches the device.  This mirrors the design of
the fork's mmap'd columnar handoff experiment (``WindowedArrowFormatBolter``,
``AdvertisingTopologyNative.java:278-356``): row->column transposition on the
host, fixed-layout buffers to the compute engine.

Two parser paths share one contract:

- a *fast path* that exploits the generator's fixed JSON field order
  (``make-kafka-event-at``, ``core.clj:175-181``): split on ``"`` and read
  values at fixed token positions, with a cheap layout check per line;
- a *fallback* (``json.loads``) for any line the fast path rejects, so
  hand-crafted or re-ordered JSON still parses.

A native C++ path (``streambench_tpu_torch.native``) can replace both when built;
the contract (EncodedBatch columns) is identical.

Timestamps are rebased to ``base_time_ms`` so all device arithmetic stays in
int32 (TPU-friendly; JAX x64 stays off): 2^31 ms of relative room ~= 24 days.
"""

from __future__ import annotations

import json
import zlib
from dataclasses import dataclass

import numpy as np


def _id_hash32(b: bytes) -> int:
    """Stateless 32-bit id hash (crc32, as a signed int32 bit pattern).
    Must stay bit-identical to ``crc32b`` in native/encoder.cpp — the
    differential tests pin this."""
    c = zlib.crc32(b)
    return c - (1 << 32) if c & 0x80000000 else c

AD_TYPES = ("banner", "modal", "sponsored-search", "mail", "mobile")
EVENT_TYPES = ("view", "click", "purchase")
AD_TYPE_INDEX = {t: i for i, t in enumerate(AD_TYPES)}
EVENT_TYPE_INDEX = {t: i for i, t in enumerate(EVENT_TYPES)}
VIEW = EVENT_TYPE_INDEX["view"]
# bytes-keyed twins for the hot parse loop (no per-row decode)
AD_TYPE_INDEX_B = {t.encode(): i for i, t in enumerate(AD_TYPES)}
EVENT_TYPE_INDEX_B = {t.encode(): i for i, t in enumerate(EVENT_TYPES)}


@dataclass
class EncodedBatch:
    """One fixed-shape columnar micro-batch.

    ``valid`` marks real rows; the tail of a ragged batch is padding
    (ad_idx 0, times 0) that every kernel masks out.  ``n`` is the count of
    valid rows.
    """

    ad_idx: np.ndarray       # int32 [B] index into the join table; -1 unknown
    event_type: np.ndarray   # int32 [B] index into EVENT_TYPES; -1 unknown
    event_time: np.ndarray   # int32 [B] ms relative to base_time_ms
    user_idx: np.ndarray     # int32 [B] dense user index (interned)
    page_idx: np.ndarray     # int32 [B] dense page index (interned)
    ad_type: np.ndarray      # int32 [B] index into AD_TYPES; -1 unknown
    valid: np.ndarray        # bool  [B]
    n: int = 0
    base_time_ms: int = 0

    @property
    def batch_size(self) -> int:
        return len(self.ad_idx)


_BATCH_COLS = ("ad_idx", "event_type", "event_time", "user_idx",
               "page_idx", "ad_type")
_COL_PAD = {"event_type": -1, "ad_type": -1}


def repack_batches(batches: list[EncodedBatch],
                   batch_size: int) -> list[EncodedBatch]:
    """Merge a run of batches into the minimum number of full batches,
    preserving event order.

    Parallel sub-block carving yields one partial tail batch per worker;
    folding those as-is would cost a full fixed-shape device step each
    (a quarter-filled batch prices like a full one).  The repack is a
    per-column memcpy (~28 bytes/event) — noise next to the ~250
    bytes/event parse it follows.  All inputs must share one
    ``base_time_ms`` (enforced): merging differently-based rows would
    corrupt every merged timestamp.
    """
    if all(b.n == b.batch_size == batch_size for b in batches):
        return batches
    bases = {b.base_time_ms for b in batches}
    if len(bases) > 1:
        raise ValueError(f"cannot repack mixed-base batches: {bases}")
    cols = {name: np.concatenate([getattr(b, name)[:b.n] for b in batches])
            for name in _BATCH_COLS}
    total = int(cols["ad_idx"].shape[0])
    out: list[EncodedBatch] = []
    for off in range(0, total, batch_size):
        n = min(batch_size, total - off)
        kw = {}
        for name in _BATCH_COLS:
            col = np.full(batch_size, _COL_PAD.get(name, 0), np.int32)
            col[:n] = cols[name][off:off + n]
            kw[name] = col
        valid = np.zeros(batch_size, bool)
        valid[:n] = True
        out.append(EncodedBatch(valid=valid, n=n,
                                base_time_ms=batches[0].base_time_ms, **kw))
    return out


class EventEncoder:
    """Stateful interning encoder.

    The ad->index map is fixed up front from the join table (1,000 ads,
    ``RedisAdCampaignCache`` semantics: the join side is known data); user
    and page ids are interned on first sight, unbounded, like the reference's
    in-process LRU caches but without eviction (a uuid string + int is ~100
    bytes; 10^6 users ~= 100 MB, acceptable for benchmark runs).

    ``RELEASES_GIL`` marks whether ``encode`` spends its time outside the
    GIL (the native subclass's ctypes call does) — the signal the
    parallel encode pool uses; threading a GIL-bound encoder is pure
    overhead.
    """

    RELEASES_GIL = False

    def set_intern_ids(self, on: bool) -> None:
        """Disable/enable user/page interning.  Engines whose kernels
        never read the interned columns (exact counts, sliding windows)
        turn it off: the per-row hash probes are the biggest per-event
        cost after tokenization, and the columns then carry zeros."""
        self.intern_ids = bool(on)

    def set_hash_ids(self, on: bool) -> None:
        """STATELESS id columns: user/page_idx = crc32 of the id bytes
        instead of intern indices.  For kernels that only need a
        well-mixed identity (HLL cardinality — which splitmix-hashes the
        column anyway, so a 32-bit string hash loses nothing), this makes
        the columns consistent across independent encoders (parallel
        encode pools, micro-batch partitions) and across process
        restarts, with no intern table to snapshot.  Kernels that index
        arrays by the column (session rows) must keep interning."""
        self.hash_ids = bool(on)

    def __init__(self, ad_to_campaign: dict[str, str],
                 campaigns: list[str] | None = None,
                 divisor_ms: int = 10_000, lateness_ms: int = 60_000):
        # Window length + allowed lateness drive the base-time rebase; they
        # MUST match what the engine passes to ops.windowcount.step, or
        # windows misalign / legitimately-late events go negative.
        self.divisor_ms = divisor_ms
        self.lateness_ms = lateness_ms
        # Deterministic campaign indexing: sorted unless an order is given.
        if campaigns is None:
            campaigns = sorted(set(ad_to_campaign.values()))
        self.campaigns: list[str] = list(campaigns)
        self.campaign_index = {c: i for i, c in enumerate(self.campaigns)}
        self.ads: list[str] = list(ad_to_campaign.keys())
        # bytes-keyed: the hot loop parses bytes and must not decode per row
        self.ad_index = {a.encode(): i for i, a in enumerate(self.ads)}
        # join_table[ad_idx] -> campaign_idx ; one trailing row for "unknown"
        jt = np.fromiter(
            (self.campaign_index[ad_to_campaign[a]] for a in self.ads),
            dtype=np.int32, count=len(self.ads))
        self.join_table = np.concatenate([jt, np.array([-1], np.int32)])
        self.unknown_ad = len(self.ads)   # maps to campaign -1
        self.user_index: dict[bytes, int] = {}
        self.page_index: dict[bytes, int] = {}
        self.intern_ids = True
        self.hash_ids = False
        self.base_time_ms: int | None = None
        self.fallback_lines = 0
        self.bad_lines = 0
        # Dead-letter sink (optional): malformed lines are appended here
        # raw instead of only being counted — the reference silently drops
        # bad tuples; a DLQ keeps them replayable after a parser fix.
        self._deadletter = None
        self.dlq_lines = 0

    @property
    def num_campaigns(self) -> int:
        return len(self.campaigns)

    def set_deadletter(self, sink) -> None:
        """Attach a dead-letter sink (anything with ``append(bytes)``,
        e.g. a ``JournalWriter`` on a ``<topic>-deadletter`` topic).
        Every line that would only bump ``bad_lines`` is also appended
        raw; both encoder paths (fast/fallback, Python/native) reject
        through the same counting sites, so the DLQ sees every reject."""
        self._deadletter = sink

    def _reject(self, line: bytes) -> None:
        """One malformed line: count it, and dead-letter it if a sink is
        attached (the ONLY place ``bad_lines`` is allowed to grow)."""
        self.bad_lines += 1
        if self._deadletter is not None:
            self._deadletter.append(bytes(line))
            self.dlq_lines += 1

    def set_base_time(self, base_time_ms: int | None) -> None:
        """Pin the rebase origin (checkpoint restore): window ids are
        relative to ``base_time_ms``, so a restored engine must encode new
        events against the *same* base or its ring slots would shift."""
        self.base_time_ms = base_time_ms

    # -- intern-table snapshot (checkpoint/resume for sketch engines) --
    def dump_intern_tables(self) -> tuple[list[bytes], list[bytes]]:
        """User/page id keys in INDEX ORDER.  Sketch state keyed by
        interned indices (HLL register hashes, CMS/session rows) is only
        restorable if a resumed encoder re-assigns identical indices."""
        # _intern only appends (idx == len(table)), so dict insertion
        # order IS index order — no sort needed on the checkpoint path.
        return list(self.user_index), list(self.page_index)

    def restore_intern_tables(self, users: list[bytes],
                              pages: list[bytes]) -> None:
        """Re-intern dumped keys; indices land exactly as dumped."""
        if self.user_index or self.page_index:
            raise ValueError(
                "restore_intern_tables on a used encoder: intern indices "
                "would diverge from the snapshot; restore into a fresh "
                "engine instead")
        self.user_index = {bytes(u): i for i, u in enumerate(users)}
        self.page_index = {bytes(p): i for i, p in enumerate(pages)}

    # -- interning helpers --------------------------------------------
    def user_key(self, idx: int) -> bytes:
        """Reverse lookup: interned index -> user id.  Amortized O(1):
        the index-order list is rebuilt only when the table grew since
        the last call (insertion order IS index order; _intern only
        appends), so k lookups at report time don't each pay an O(users)
        scan."""
        cache = getattr(self, "_user_key_cache", None)
        if cache is None or len(cache) != len(self.user_index):
            cache = self._user_key_cache = list(self.user_index)
        return cache[idx]

    def num_interned_users(self) -> int:
        """Interned-user count (session engines size legacy-snapshot
        reseeding by it; the native encoder reads its C-side table)."""
        return len(self.user_index)

    def _intern(self, table: dict[bytes, int], key: bytes) -> int:
        idx = table.get(key)
        if idx is None:
            idx = len(table)
            table[key] = idx
        return idx

    def _ad_lookup(self, ad: bytes) -> int:
        idx = self.ad_index.get(ad)
        return self.unknown_ad if idx is None else idx

    def _rebase(self, t: int) -> None:
        # Rebase a full lateness span below the first event's window start
        # so even maximally-late events (core.clj:170-173) keep
        # non-negative relative times.
        self.base_time_ms = t - (t % self.divisor_ms) - self.lateness_ms

    # -- parsing ------------------------------------------------------
    # Fast-path layout: the generator's field order, split on '"' gives
    # values at fixed positions (keys at even check positions).
    _FAST_KEYS = (b"user_id", b"page_id", b"ad_id", b"ad_type",
                  b"event_type", b"event_time")

    def _parse_fast(self, line: bytes):
        parts = line.split(b'"')
        # layout: {, user_id, :, <u>, , page_id, :, <p>, ... 27+ tokens
        if len(parts) < 26:
            return None
        if (parts[1] != b"user_id" or parts[5] != b"page_id"
                or parts[9] != b"ad_id" or parts[13] != b"ad_type"
                or parts[17] != b"event_type" or parts[21] != b"event_time"):
            return None
        try:
            t = int(parts[23])
        except ValueError:
            return None
        return parts[3], parts[7], parts[11], parts[15], parts[19], t

    def _parse_slow(self, line: bytes):
        try:
            ev = json.loads(line)
            return (
                str(ev["user_id"]).encode(),
                str(ev["page_id"]).encode(),
                str(ev["ad_id"]).encode(),
                str(ev.get("ad_type", "")).encode(),
                str(ev["event_type"]).encode(),
                int(ev["event_time"]),
            )
        except (KeyError, ValueError, TypeError):
            return None

    def encode(self, lines: list[bytes], batch_size: int | None = None
               ) -> EncodedBatch:
        """Encode ``lines`` into one EncodedBatch padded to ``batch_size``.

        ``len(lines)`` must be <= batch_size; unparseable lines are counted
        in ``bad_lines`` and become invalid (masked) rows.
        """
        B = batch_size if batch_size is not None else len(lines)
        if len(lines) > B:
            raise ValueError(f"{len(lines)} lines exceed batch size {B}")
        ad_idx = np.zeros(B, np.int32)
        etype = np.full(B, -1, np.int32)
        etime = np.zeros(B, np.int32)
        user_idx = np.zeros(B, np.int32)
        page_idx = np.zeros(B, np.int32)
        ad_type = np.full(B, -1, np.int32)
        valid = np.zeros(B, bool)

        n = 0
        for line in lines:
            rec = self._parse_fast(line)
            if rec is None:
                self.fallback_lines += 1
                rec = self._parse_slow(line)
                if rec is None:
                    self._reject(line)
                    continue
            u, p, ad, at, et, t = rec
            if self.base_time_ms is None:
                self._rebase(t)
            if not (-2**31 <= t - self.base_time_ms < 2**31):
                # rebased time must fit the int32 column; an absurd
                # timestamp (clock garbage, fuzzed input) is a bad
                # line, not a crash or a silent int32 wrap (every
                # encoder arm applies this same rule)
                self._reject(line)
                continue
            i = n
            ad_idx[i] = self._ad_lookup(ad)
            etype[i] = EVENT_TYPE_INDEX_B.get(et, -1)
            etime[i] = t - self.base_time_ms
            if self.hash_ids:
                user_idx[i] = _id_hash32(u)
                page_idx[i] = _id_hash32(p)
            elif self.intern_ids:
                user_idx[i] = self._intern(self.user_index, u)
                page_idx[i] = self._intern(self.page_index, p)
            ad_type[i] = AD_TYPE_INDEX_B.get(at, -1)
            valid[i] = True
            n += 1

        return EncodedBatch(ad_idx, etype, etime, user_idx, page_idx,
                            ad_type, valid, n=n,
                            base_time_ms=self.base_time_ms or 0)

    def encode_tbl(self, lines: list[bytes], batch_size: int | None = None
                   ) -> EncodedBatch:
        """Encode the fork's pipe-separated ``events.tbl`` format
        (``u|p|ad|ad_type|event_type|time``; emitted at
        ``AdvertisingTopologyNative.java:210-222``)."""
        B = batch_size if batch_size is not None else len(lines)
        converted = []
        for line in lines:
            f = line.rstrip(b"\n").split(b"|")
            if len(f) < 6:
                self._reject(line)
                continue
            converted.append((line, f))
        if len(converted) > B:
            raise ValueError(f"{len(converted)} lines exceed batch size {B}")
        ad_idx = np.zeros(B, np.int32)
        etype = np.full(B, -1, np.int32)
        etime = np.zeros(B, np.int32)
        user_idx = np.zeros(B, np.int32)
        page_idx = np.zeros(B, np.int32)
        ad_type = np.full(B, -1, np.int32)
        valid = np.zeros(B, bool)
        n = 0
        for line, c in converted:
            u, p, ad, at, et, t = c[:6]
            try:
                ti = int(t)
            except ValueError:
                self._reject(line)
                continue
            if self.base_time_ms is None:
                self._rebase(ti)
            if not (-2**31 <= ti - self.base_time_ms < 2**31):
                self._reject(line)   # same int32-fit rule as encode()
                continue
            ad_idx[n] = self._ad_lookup(ad)
            etype[n] = EVENT_TYPE_INDEX_B.get(et, -1)
            etime[n] = ti - self.base_time_ms
            if self.hash_ids:
                user_idx[n] = _id_hash32(u)
                page_idx[n] = _id_hash32(p)
            elif self.intern_ids:
                user_idx[n] = self._intern(self.user_index, u)
                page_idx[n] = self._intern(self.page_index, p)
            ad_type[n] = AD_TYPE_INDEX_B.get(at, -1)
            valid[n] = True
            n += 1
        return EncodedBatch(ad_idx, etype, etime, user_idx, page_idx,
                            ad_type, valid, n=n,
                            base_time_ms=self.base_time_ms or 0)
