"""Durable aggregate store: the HDHT-store peer, latency-aware.

The Apex reference persists dimensional aggregates in an HDHT store (an
HDFS-backed hash table, ``ApplicationDimensionComputation.createStore``,
``:201-211``) wrapped by ``ProcessTimeAwareStore`` which records
per-(key, bucket) update times and reports a latency decile table
(``ProcessTimeAwareStore.java:62-89,115-176``).  SURVEY.md §5.4 classifies
it as a *durable sink*, not a resumable checkpoint — same here.

This peer is an append-only JSON-lines log plus an in-memory index:

- ``put_rows`` appends one record per (key, bucket) with its final
  aggregate values and the update time, updates the index, and feeds the
  latency tracker (the ProcessTimeAwareStore role);
- reopening replays the log to rebuild the index (crash-durable up to the
  last fsync; ``sync_every`` bounds the window);
- ``compact`` rewrites the log keeping only each (key, bucket)'s latest
  record — the HDHT compaction analog.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Iterator

import numpy as np

from streambench_tpu_torch.metrics import LatencyTracker
from streambench_tpu_torch.utils.ids import now_ms

LOG_NAME = "dimensions.log"


class DurableDimensionStore:
    def __init__(self, directory: str, bucket_ms: int = 10_000,
                 ignore_first: int = 10, sync_every: int = 1):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.path = os.path.join(directory, LOG_NAME)
        self.bucket_ms = bucket_ms
        # (key, bucket_ms) -> {"<value>:<AGG>": final, "_updated": ms}
        self.index: dict[tuple[str, int], dict] = {}
        self.latency = LatencyTracker(window_ms=bucket_ms,
                                      ignore_first=ignore_first)
        self._sync_every = max(sync_every, 0)
        self._since_sync = 0
        # latest materialized reach-sketch record (reach/):
        # {"mins": [C,k] uint32, "registers": [C,R] int32,
        #  "campaigns": [...], "epoch": int, "_updated": ms} or None
        self._reach: dict | None = None
        # delta-ship chain bookkeeping: the newest intact
        # base record (raw parsed dict), the delta records folded on
        # top of it in order, and the seq of the last chained record
        # (None = no chain / chain broken — deltas are dropped until
        # the next base).  compact() dumps base + chain verbatim so a
        # mid-chain compaction never orphans deltas.
        self._reach_base: dict | None = None
        self._reach_chain: list[dict] = []
        self._reach_seq: int | None = None
        # chaos hook: when set, every put_reach_sketches
        # line passes through ``hook(line) -> (data, intact)`` before
        # hitting the file — the ship-log fault surface.  None (the
        # default) is a byte-exact pass-through.
        self.ship_fault_hook = None
        if os.path.exists(self.path):
            self._replay()
        self._f = open(self.path, "a", encoding="utf-8")

    # -- write path ----------------------------------------------------
    def put_rows(self, rows: list[tuple[str, int, dict]],
                 update_time_ms: int | None = None) -> int:
        """``rows``: (key, bucket_start_ms, {"value:AGG": final}).  Returns
        rows written."""
        stamp = now_ms() if update_time_ms is None else update_time_ms
        for key, bucket, aggs in rows:
            rec = {"k": key, "b": bucket, "t": stamp, "a": aggs}
            self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self.index[(key, bucket)] = {**aggs, "_updated": stamp}
            self.latency.record(key, bucket, stamp)
        self._since_sync += len(rows)
        if self._sync_every and self._since_sync >= self._sync_every:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._since_sync = 0
        return len(rows)

    def put_reach_sketches(self, mins: np.ndarray, registers: np.ndarray,
                           campaigns: list[str], epoch: int,
                           update_time_ms: int | None = None,
                           watermark: int | None = None,
                           folded_ms: int | None = None,
                           submit_ms: int | None = None,
                           origin: dict | None = None,
                           seq: int | None = None) -> int:
        """Materialize the reach sketch planes (reach/) as one
        durable log record, so a reopened store can serve audience
        queries without re-folding the journal.  Latest record wins on
        replay; ``compact`` keeps only it.

        This record is also the replica shipping format: the
        snapshot shipper appends one per cadence tick and read-replica
        processes tail the log for them; ``watermark`` rides along so a
        replica can report how much event time its planes cover.

        Fleet freshness stamps: ``folded_ms``
        is the writer wall time of the last fold into these planes,
        ``submit_ms`` the wall time the ship was submitted (``fm`` /
        ``sm`` on the wire — the writer-side hop boundaries of the
        freshness ledger), and ``origin`` names the writer's pub/sub
        endpoint + pid so replicas can ping it for the clock-offset
        estimate (obs/clock.py).

        ``seq`` is the delta-ship chain stamp: a base
        record carrying one restarts the chain — subsequent
        ``reach_delta`` records link off it via ``ps``.  Legacy
        full-ship callers omit it.  Returns the encoded record size in
        bytes (pre-fault-hook — what the writer produced)."""
        stamp = now_ms() if update_time_ms is None else update_time_ms
        mins = np.ascontiguousarray(mins, dtype=np.uint32)
        regs = np.ascontiguousarray(registers, dtype=np.int32)
        rec = {"kind": "reach_sketch", "t": stamp, "epoch": int(epoch),
               "c": list(campaigns),
               "k": int(mins.shape[1]), "r": int(regs.shape[1]),
               "mins": base64.b64encode(mins.tobytes()).decode(),
               "regs": base64.b64encode(regs.tobytes()).decode()}
        if watermark is not None:
            rec["wm"] = int(watermark)
        if folded_ms is not None:
            rec["fm"] = int(folded_ms)
        if submit_ms is not None:
            rec["sm"] = int(submit_ms)
        if origin is not None:
            rec["origin"] = dict(origin)
        if seq is not None:
            rec["seq"] = int(seq)
        data = json.dumps(rec, separators=(",", ":")) + "\n"
        nbytes = len(data)
        intact = True
        hook = self.ship_fault_hook
        if hook is not None:
            # ship-log fault surface: the hook may tear,
            # corrupt, or delay the appended record; a damaged record
            # must not be absorbed — the writer's own replay view
            # stays no fresher than what it durably wrote
            data, intact = hook(data)
        if data:
            self._f.write(data)
        self._f.flush()
        os.fsync(self._f.fileno())
        if intact:
            self._absorb_reach(rec)
        return nbytes

    def put_reach_delta(self, row_idx: np.ndarray, rows: dict, *,
                        epoch: int, seq: int, prev_seq: int,
                        update_time_ms: int | None = None,
                        watermark: int | None = None,
                        folded_ms: int | None = None,
                        submit_ms: int | None = None,
                        origin: dict | None = None) -> int:
        """Append one chain-stamped dirty-row delta record:
        only the rows in ``row_idx`` of each plane, linked to the
        previous ship via ``ps=prev_seq``.  ``rows`` maps wire plane
        names (``mins`` / ``regs``) to ``[n, width]`` arrays.  Goes
        through the same ship-fault hook as bases.  Returns the
        encoded record size in bytes (pre-hook)."""
        stamp = now_ms() if update_time_ms is None else update_time_ms
        idx = np.ascontiguousarray(np.asarray(row_idx).ravel(),
                                   dtype=np.int32)
        mins = np.ascontiguousarray(rows["mins"], dtype=np.uint32)
        regs = np.ascontiguousarray(rows["regs"], dtype=np.int32)
        rec = {"kind": "reach_delta", "t": stamp, "epoch": int(epoch),
               "seq": int(seq), "ps": int(prev_seq),
               "k": int(mins.shape[1]) if mins.ndim == 2 else 0,
               "r": int(regs.shape[1]) if regs.ndim == 2 else 0,
               "idx": base64.b64encode(idx.tobytes()).decode(),
               "mins": base64.b64encode(mins.tobytes()).decode(),
               "regs": base64.b64encode(regs.tobytes()).decode()}
        if watermark is not None:
            rec["wm"] = int(watermark)
        if folded_ms is not None:
            rec["fm"] = int(folded_ms)
        if submit_ms is not None:
            rec["sm"] = int(submit_ms)
        if origin is not None:
            rec["origin"] = dict(origin)
        data = json.dumps(rec, separators=(",", ":")) + "\n"
        nbytes = len(data)
        intact = True
        hook = self.ship_fault_hook
        if hook is not None:
            data, intact = hook(data)
        if data:
            self._f.write(data)
        self._f.flush()
        os.fsync(self._f.fileno())
        if intact:
            self._absorb_reach_delta(rec)
        return nbytes

    def _absorb_reach(self, rec: dict) -> None:
        try:
            c = list(rec["c"])
            k, r = int(rec["k"]), int(rec["r"])
            mins = np.frombuffer(base64.b64decode(rec["mins"]),
                                 np.uint32).reshape(len(c), k)
            regs = np.frombuffer(base64.b64decode(rec["regs"]),
                                 np.int32).reshape(len(c), r)
        except (KeyError, ValueError, TypeError):
            return   # torn/corrupt sketch record: keep the previous one
        self._reach = {"mins": mins, "registers": regs, "campaigns": c,
                       "epoch": int(rec.get("epoch", 0)),
                       "watermark": int(rec.get("wm", 0)),
                       "_updated": int(rec.get("t", 0)),
                       # fleet freshness stamps + origin;
                       # absent on pre-fleet records
                       "folded_ms": rec.get("fm"),
                       "submit_ms": rec.get("sm"),
                       "origin": rec.get("origin")}
        # every intact base restarts the delta chain; a
        # legacy base without seq still loads but nothing chains off it
        self._reach_base = rec
        self._reach_chain = []
        self._reach_seq = rec.get("seq")

    def _absorb_reach_delta(self, rec: dict) -> None:
        """Fold one intact delta record into the materialized view iff
        it chains off the last absorbed record; otherwise mark the
        chain broken so later deltas are dropped until the next base
        (the store's view must never be half-folded)."""
        if self._reach is None or self._reach_seq is None:
            return
        from streambench_tpu_torch.reach.deltaship import (
            decode_delta_record, merge_rows)
        d = decode_delta_record(rec)
        if d is None:
            self._reach_seq = None
            return
        C = len(self._reach["campaigns"])
        if (d["epoch"] != self._reach["epoch"]
                or d["ps"] != self._reach_seq
                or (d["idx"].size and (int(d["idx"].min()) < 0
                                       or int(d["idx"].max()) >= C))):
            self._reach_seq = None
            return
        merge_rows(self._reach, d["idx"], d["rows"])
        if d["watermark"] is not None:
            self._reach["watermark"] = int(d["watermark"])
        self._reach["_updated"] = d["shipped_ms"]
        self._reach["folded_ms"] = d["folded_ms"]
        self._reach["submit_ms"] = d["submit_ms"]
        if d["origin"] is not None:
            self._reach["origin"] = d["origin"]
        self._reach_chain.append(rec)
        self._reach_seq = d["seq"]

    def reach_sketches(self) -> dict | None:
        """Latest materialized reach-sketch record (or None)."""
        return self._reach

    # -- read path -----------------------------------------------------
    def get(self, key: str, bucket_ms: int) -> dict | None:
        return self.index.get((key, bucket_ms))

    def scan_key(self, key: str) -> dict[int, dict]:
        return {b: v for (k, b), v in self.index.items() if k == key}

    def buckets(self) -> list[int]:
        return sorted({b for _, b in self.index})

    def __len__(self) -> int:
        return len(self.index)

    def items(self) -> Iterator[tuple[tuple[str, int], dict]]:
        return iter(self.index.items())

    # -- durability ----------------------------------------------------
    def _replay(self) -> None:
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail record from a crash mid-append
                if rec.get("kind") == "reach_sketch":
                    self._absorb_reach(rec)
                    continue
                if rec.get("kind") == "reach_delta":
                    # must precede the (k, b) index fallback: delta
                    # records carry "k" (plane width) but no "b"
                    self._absorb_reach_delta(rec)
                    continue
                self.index[(rec["k"], rec["b"])] = {
                    **rec["a"], "_updated": rec["t"]}
                self.latency.record(rec["k"], rec["b"], rec["t"])

    def compact(self) -> None:
        """Rewrite the log with only each (key, bucket)'s latest record.

        Reach records keep the newest base PLUS its subsequent delta
        chain verbatim: "keep latest record" would orphan
        the deltas folded on top of the base — a tailer replaying the
        compacted log must land on the exact same folded view (seq
        stamps and freshness fields included), so the raw records are
        preserved, not re-synthesized from the folded planes."""
        tmp = self.path + ".compact"
        with open(tmp, "w", encoding="utf-8") as f:
            for (key, bucket), val in self.index.items():
                aggs = {k: v for k, v in val.items() if k != "_updated"}
                rec = {"k": key, "b": bucket, "t": val["_updated"],
                       "a": aggs}
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            if self._reach_base is not None:
                f.write(json.dumps(self._reach_base,
                                   separators=(",", ":")) + "\n")
                for rec in self._reach_chain:
                    f.write(json.dumps(rec,
                                       separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()

    def __enter__(self) -> "DurableDimensionStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
