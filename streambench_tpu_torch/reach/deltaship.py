"""Incremental delta ships: O(ΔC) dirty-row state shipping.

The full-plane ship (:class:`~streambench_tpu_torch.reach.replica.
SnapshotShipper`) gathers and base64-encodes every campaign row on
every cadence tick — O(C) work and bytes even when a tick touched 0.1%
of campaigns, which is exactly the term that makes "millions of
campaigns" incompatible with a tight cadence (the autoscaler's
``ship_cadence`` knob gets MORE expensive exactly when diagnosis says
to turn it).  The sketch planes' merge algebra (elementwise min on the
MinHash signature, max on the HLL registers — commutative, associative,
idempotent; test-pinned) means a replica that folds only the
changed rows lands bit-identical state, so the wire can carry deltas.

Record chain (all through ``DurableDimensionStore`` — its ship
fault hook tears/corrupts delta records exactly like bases):

- BASE: the existing ``reach_sketch`` full-plane record, now stamped
  ``seq`` — every base restarts the chain (a reader needs no history
  before it);
- DELTA: a ``reach_delta`` record ``(epoch, seq, ps=prev_seq, idx,
  rows…)`` carrying only the dirty rows of each plane.  A reader folds
  it iff ``ps`` equals the seq it last applied AND the epoch matches;
  any gap, damaged record, or epoch skew breaks the chain and the
  reader serves its last consistent state until the next base resyncs
  it (never a half-folded plane).

The writer (:class:`DeltaShipper`) ships a base on: first ship, any
``force=True`` (close-time AND the restart path — a respawned writer's
dirty set is empty, so forcing a delta would ship nothing and strand
replicas), an epoch bump, every ``base_every``-th record (bounds the
resync window), and whenever ``len(dirty)/C`` crosses
``cutover_frac`` — deltas must never cost more than the thing they
replace.  An empty dirty set still ships a zero-row heartbeat delta at
the cadence so replica staleness stays anchored to live evidence.

Everything is written against a plane-generic surface — a dict of
named arrays plus a per-plane row merge (:data:`REACH_PLANES`) — not
reach-specific fields, so another served plane can adopt the shipper
verbatim.  Pure numpy; nothing here touches the device.
"""

from __future__ import annotations

import base64
import json
from typing import NamedTuple

import numpy as np

from streambench_tpu_torch.reach.replica import (
    SHIP_KIND,
    SnapshotShipper,
    decode_ship_record,
)

#: the dirty-row record kind (DurableDimensionStore.put_reach_delta)
DELTA_KIND = "reach_delta"

#: ``jax.reach.ship.delta=auto`` floor: below this campaign count the
#: full-plane gather is trivially cheap (a few hundred KB) and the
#: dirty-mask bookkeeping buys nothing
DELTA_AUTO_MIN_CAMPAIGNS = 4096

#: default base cadence: one full record every N ships bounds how far
#: a desynced reader can trail before it resyncs
DEFAULT_BASE_EVERY = 64

#: default Δ/C cutover: above this dirty fraction a delta record stops
#: being meaningfully cheaper than a base (row payload parity is at
#: 1.0; the margin covers the idx column + per-record overhead)
DEFAULT_CUTOVER_FRAC = 0.5


class PlaneSpec(NamedTuple):
    """One named state plane and how its rows merge.

    ``key`` is the planes()-dict / folded-view key, ``wire`` the JSON
    field, ``width_key`` the JSON field naming the row width, ``merge``
    the elementwise row algebra ("min" or "max" — both commutative,
    associative, idempotent, which is what makes delta folds exact)."""

    key: str
    wire: str
    width_key: str
    dtype: type
    merge: str


#: the reach planes: MinHash signature mins (elementwise min) + HLL
#: registers (elementwise max) — matches ops/minhash.merge exactly
REACH_PLANES = (
    PlaneSpec("mins", "mins", "k", np.uint32, "min"),
    PlaneSpec("registers", "regs", "r", np.int32, "max"),
)


def merge_rows(planes: dict, idx: np.ndarray, rows: dict,
               specs=REACH_PLANES) -> None:
    """Fold delta ``rows`` into ``planes`` at ``idx`` via each plane's
    merge algebra, in place (read-only arrays — ``np.frombuffer``
    views — are copied into ``planes`` first)."""
    for sp in specs:
        dst = planes[sp.key]
        if not dst.flags.writeable:
            dst = planes[sp.key] = dst.copy()
        fn = np.minimum if sp.merge == "min" else np.maximum
        dst[idx] = fn(dst[idx], rows[sp.key])


def decode_delta_record(rec: dict, specs=REACH_PLANES) -> dict | None:
    """One parsed delta line -> ``{idx, rows, epoch, seq, ps, …}``, or
    None when torn/corrupt (the chain-break signal)."""
    if rec.get("kind") != DELTA_KIND:
        return None
    try:
        seq, ps = int(rec["seq"]), int(rec["ps"])
        idx = np.frombuffer(base64.b64decode(rec["idx"]), np.int32)
        rows = {}
        for sp in specs:
            w = int(rec[sp.width_key])
            rows[sp.key] = np.frombuffer(
                base64.b64decode(rec[sp.wire]),
                sp.dtype).reshape(len(idx), w)
    except (KeyError, ValueError, TypeError):
        return None
    return {"idx": idx, "rows": rows, "epoch": int(rec.get("epoch", 0)),
            "seq": seq, "ps": ps, "watermark": rec.get("wm"),
            "shipped_ms": int(rec.get("t", 0)),
            "folded_ms": rec.get("fm"), "submit_ms": rec.get("sm"),
            "origin": rec.get("origin")}


class DeltaShipper(SnapshotShipper):
    """Writer-side O(ΔC) shipper: dirty rows ride chain-stamped delta
    records between periodic bases.  Drop-in for
    :class:`SnapshotShipper` (same ``due``/``note_state`` surface) —
    the engine additionally passes its dirty row set and enables
    host-side dirty tracking because ``wants_dirty`` is True."""

    wants_dirty = True
    mode = "delta"

    def __init__(self, store, campaigns: list[str],
                 interval_ms: int = 1000, registry=None,
                 origin: dict | None = None, specs=REACH_PLANES,
                 base_every: int = DEFAULT_BASE_EVERY,
                 cutover_frac: float = DEFAULT_CUTOVER_FRAC):
        super().__init__(store, campaigns, interval_ms=interval_ms,
                         registry=registry, origin=origin)
        self.specs = tuple(specs)
        self.base_every = max(int(base_every), 1)
        self.cutover_frac = float(cutover_frac)
        self.bases = 0
        self.deltas = 0
        self.cutovers = 0
        self._seq = 0              # last shipped record's chain stamp
        self._since_base = 0

    def note_state(self, mins, registers, epoch: int,
                   watermark: int = 0, force: bool = False,
                   folded_ms: int | None = None,
                   dirty_rows=None) -> bool:
        return self.note_planes(
            {"mins": mins, "registers": registers}, epoch,
            watermark=watermark, force=force, folded_ms=folded_ms,
            dirty_rows=dirty_rows)

    def note_planes(self, planes: dict, epoch: int, *,
                    watermark: int = 0, force: bool = False,
                    folded_ms: int | None = None,
                    dirty_rows=None) -> bool:
        """Plane-generic ship: ``planes`` is a dict of named arrays
        matching ``self.specs``; ``dirty_rows`` the row indices touched
        since the last ship (None = unknown -> base).  Returns True
        when a record was written."""
        import time as _time

        from streambench_tpu_torch.utils.ids import now_ms

        now = _time.monotonic()
        epoch = int(epoch)
        if (not force and self._last_epoch == epoch
                and (now - self._last_ship) * 1000.0 < self.interval_ms):
            return False
        t0 = _time.perf_counter()
        np_planes = {sp.key: np.asarray(planes[sp.key])
                     for sp in self.specs}
        C = int(np_planes[self.specs[0].key].shape[0])
        if dirty_rows is None:
            dirty = None
        else:
            dirty = np.ascontiguousarray(
                np.asarray(dirty_rows).ravel(), dtype=np.int32)
        cutover = (dirty is not None
                   and dirty.size >= self.cutover_frac * C)
        # force covers the restart path: a
        # respawned writer's dirty set is EMPTY — a forced delta would
        # ship nothing and strand replicas until the next organic base
        need_base = (force or dirty is None
                     or self._last_epoch != epoch
                     or self._since_base >= self.base_every
                     or cutover)
        submit_ms = now_ms()
        seq = self._seq + 1
        if need_base:
            if cutover and not force and self._last_epoch == epoch:
                self.cutovers += 1
            nbytes = self.store.put_reach_sketches(
                np_planes["mins"], np_planes["registers"],
                self.campaigns, epoch, watermark=int(watermark),
                folded_ms=(int(folded_ms) if folded_ms is not None
                           else submit_ms),
                submit_ms=submit_ms, origin=self.origin, seq=seq)
            rows_n = C
            self.bases += 1
            self._since_base = 0
        else:
            rows = {sp.wire: np.ascontiguousarray(
                        np_planes[sp.key][dirty], dtype=sp.dtype)
                    for sp in self.specs}
            nbytes = self.store.put_reach_delta(
                dirty, rows, epoch=epoch, seq=seq, prev_seq=self._seq,
                watermark=int(watermark),
                folded_ms=(int(folded_ms) if folded_ms is not None
                           else submit_ms),
                submit_ms=submit_ms, origin=self.origin)
            rows_n = int(dirty.size)
            self.deltas += 1
            self._since_base += 1
        self._seq = seq
        self._mark_shipped(now, epoch, nbytes, rows_n,
                           (_time.perf_counter() - t0) * 1e3)
        return True

    def summary(self) -> dict:
        out = super().summary()
        out.update(bases=self.bases, deltas=self.deltas,
                   cutovers=self.cutovers, base_every=self.base_every,
                   cutover_frac=self.cutover_frac, seq=self._seq)
        return out


class ChainTailer:
    """Chain-validating ship-log consumer: the delta-aware replacement
    for :class:`~streambench_tpu_torch.reach.replica.ShipLogTailer`.

    Each ``poll`` consumes newly appended complete lines in order
    (torn tails stay buffered until the newline lands), loads bases,
    folds chain-consistent deltas via :func:`merge_rows`, and returns
    the folded view — the same dict shape ``decode_ship_record``
    produces — when anything was applied, else None.  Any gap (missing
    ``ps`` link, damaged record, epoch skew) breaks the chain: deltas
    are discarded and the view stays at the last consistent state (it
    ages until the replica's staleness bound sheds) until the next
    base resyncs.  Over a base-only log (full-ship mode) this behaves
    exactly like the legacy tailer: the newest base wins.

    The returned plane arrays are owned by the tailer and mutated
    across polls — consumers that retain them (rather than converting
    to device arrays immediately) must copy."""

    def __init__(self, path: str, specs=REACH_PLANES):
        self.path = path
        self.specs = tuple(specs)
        self._pos = 0
        self._carry = b""
        self._view: dict | None = None
        self._seq: int | None = None    # None = chain cannot extend
        self.records_seen = 0
        self.bases_loaded = 0
        self.deltas_folded = 0
        self.gaps = 0
        self.damaged = 0
        self.resyncs = 0

    def _apply_base(self, rec: dict) -> bool:
        view = decode_ship_record(rec)
        if view is None:
            self.damaged += 1
            return False
        if self._view is not None and self._seq is None:
            self.resyncs += 1
        self._view = view
        # a legacy (pre-chain) base has no seq: it loads fine but no
        # delta can chain off it — exactly right, legacy writers never
        # emit deltas
        self._seq = rec.get("seq")
        self.bases_loaded += 1
        return True

    def _apply_delta(self, rec: dict) -> bool:
        if self._view is None or self._seq is None:
            self.gaps += 1
            return False
        d = decode_delta_record(rec, self.specs)
        if d is None:
            # a damaged delta is a lost link even when the NEXT record
            # would chain: break now, resync at the next base
            self.damaged += 1
            self._seq = None
            return False
        C = len(self._view["campaigns"])
        if (d["epoch"] != self._view["epoch"] or d["ps"] != self._seq
                or (d["idx"].size and (int(d["idx"].min()) < 0
                                       or int(d["idx"].max()) >= C))):
            self.gaps += 1
            self._seq = None
            return False
        merge_rows(self._view, d["idx"], d["rows"], self.specs)
        if d["watermark"] is not None:
            self._view["watermark"] = int(d["watermark"])
        self._view["shipped_ms"] = d["shipped_ms"]
        self._view["folded_ms"] = d["folded_ms"]
        self._view["submit_ms"] = d["submit_ms"]
        if d["origin"] is not None:
            self._view["origin"] = d["origin"]
        self._seq = d["seq"]
        self.deltas_folded += 1
        return True

    def poll(self) -> dict | None:
        try:
            with open(self.path, "rb") as f:
                f.seek(self._pos)
                data = f.read()
        except FileNotFoundError:
            return None
        if not data:
            return None
        self._pos += len(data)
        data = self._carry + data
        nl = data.rfind(b"\n") + 1
        self._carry = data[nl:]
        changed = False
        for line in data[:nl].splitlines():
            line = line.strip()
            if not line:
                continue
            is_base = b'"reach_sketch"' in line
            is_delta = b'"reach_delta"' in line
            if not (is_base or is_delta):
                continue
            self.records_seen += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                # an unparseable ship line may have been a chain link;
                # the seq stamps catch the loss at the next delta, so
                # only count the damage here
                self.damaged += 1
                continue
            if rec.get("kind") == SHIP_KIND:
                changed = self._apply_base(rec) or changed
            elif rec.get("kind") == DELTA_KIND:
                changed = self._apply_delta(rec) or changed
        return dict(self._view) if changed else None

    def stats(self) -> dict:
        return {"records_seen": self.records_seen,
                "bases_loaded": self.bases_loaded,
                "deltas_folded": self.deltas_folded,
                "gaps": self.gaps, "damaged": self.damaged,
                "resyncs": self.resyncs,
                "seq": self._seq,
                "epoch": (self._view or {}).get("epoch")}
