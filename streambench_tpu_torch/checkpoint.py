"""Checkpoint/resume: (journal offset, window-state carry) snapshots.

A copy of ``streambench_tpu/checkpoint.py`` (numpy only): the npz format
is the same byte for byte, so a snapshot written by either engine loads
in the other.

The reference has NO working checkpointing — Flink's ``enableCheckpointing``
is commented out (``AdvertisingTopologyNative.java:81-84``) and the only
resume semantics are Kafka consumer offsets (``setStartFromEarliest``,
``AdvertisingTopologyNative.java:92``; ``auto.offset.reset=smallest``,
``AdvertisingSpark.scala:64``): crash = recount everything from the earliest
retained offset.  Here checkpointing is cheap and exact, because the whole
engine state is a handful of fixed-shape int32 arrays plus two small host
dicts (SURVEY.md §5.4): one ``np.savez`` per snapshot, written atomically
(tmp file + ``os.replace``) so a crash mid-save can never corrupt the
latest good checkpoint.

Semantics: a snapshot captures the engine *exactly* as of a journal byte
``offset`` — device arrays (count deltas, ring slots, watermark, dropped),
the host pending-delta buffer, the per-window latency ledger, and the
encoder's time base.  Restoring and re-tailing the journal at ``offset``
replays the stream with no loss and no recount **relative to the
snapshot**.  End-to-end the guarantee is at-least-once: Redis window
writes are HINCRBY deltas, so any flush performed after the snapshot a
crash rewinds to is applied again on replay.  The replay window is
bounded by the snapshot cadence — the runner snapshots right after each
flush by default (``jax.checkpoint.interval.ms = 0``), shrinking the
double-count exposure to a crash landing inside one flush→save gap; a
larger interval widens it to every flush since the last snapshot.  This
is the same guarantee class as the reference engines' offset commits
(at-least-once on restart from the last committed Kafka offset).

With ``jax.sink.exactly_once`` on the guarantee tightens to equality
(ROBUSTNESS.md "Exactly-once"): the snapshot additionally carries the
last sink fence it covers (``meta["sink_epoch"]``/``meta["sink_seq"]``),
the cumulative per-window writeback ledger (``extra["xo_totals"]``) and
the tainted-window set (``extra["xo_taint"]``).  On resume the engine
compares the sink's fence against the snapshot's: any flush the crashed
attempt landed — fully or partially — after this snapshot is detected
and the attempt reconciles with absolute ledger writes instead of
replayed increments.  All three fields ride the existing meta/extra
channels, so the format version is unchanged and flag-off snapshots are
byte-identical.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from dataclasses import dataclass, field

import numpy as np

# v2: offset may be a per-partition vector (multi-partition topics).
# v1 snapshots (scalar offset) remain readable.
FORMAT_VERSION = 2
READABLE_VERSIONS = (1, 2)


class CheckpointVersionError(RuntimeError):
    """Checkpoint written by an incompatible format version.

    Deliberately NOT treated as a torn file by ``Checkpointer.load``:
    silently skipping a version-mismatched snapshot would restart the
    engine from offset 0 and replay the whole journal into persistent
    Redis counts.  The operator must migrate or discard explicitly.
    """


@dataclass
class Snapshot:
    """One engine checkpoint, decoded (see ``AdAnalyticsEngine.restore``).

    ``offset`` is the journal position to re-tail from: a single int for
    one partition, or a per-partition vector (``MultiReader.offsets``)
    for a multi-partition topic — the Kafka committed-offset-vector
    analog (``AdvertisingTopologyNative.java:92``).
    """

    offset: int | list[int]
    meta: dict
    counts: np.ndarray        # [C, W] int32 undrained device deltas
    window_ids: np.ndarray    # [W] int32
    watermark: int
    dropped: int
    pending: list[tuple[int, int, int]] = field(default_factory=list)
    latency: list[tuple[int, int]] = field(default_factory=list)
    # Engine-specific payload (sketch engines: HLL registers, t-digest
    # centroids, CMS table, session carries, intern tables).  Arrays of
    # any dtype incl. bytes ("S*"); round-trips through the npz untouched.
    extra: dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def seq(self) -> int:
        return int(self.meta.get("seq", 0))


def _encode(snapshot: Snapshot) -> dict:
    pending = np.asarray(snapshot.pending, np.int64).reshape(-1, 3)
    latency = np.asarray(snapshot.latency, np.int64).reshape(-1, 2)
    offset = (list(map(int, snapshot.offset))
              if isinstance(snapshot.offset, (list, tuple))
              else int(snapshot.offset))
    meta = dict(snapshot.meta)
    meta.update(version=FORMAT_VERSION, offset=offset,
                watermark=int(snapshot.watermark),
                dropped=int(snapshot.dropped))
    out = dict(
        counts=np.asarray(snapshot.counts, np.int32),
        window_ids=np.asarray(snapshot.window_ids, np.int32),
        pending=pending,
        latency=latency,
        meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
    )
    for name, arr in snapshot.extra.items():
        out[f"x_{name}"] = np.asarray(arr)
    return out


def _decode(z) -> Snapshot:
    meta = json.loads(bytes(z["meta"].tobytes()).decode())
    if meta.get("version") not in READABLE_VERSIONS:
        raise CheckpointVersionError(
            f"unsupported checkpoint version {meta.get('version')} "
            f"(this build reads {READABLE_VERSIONS})")
    off = meta["offset"]
    return Snapshot(
        offset=[int(o) for o in off] if isinstance(off, list) else int(off),
        meta=meta,
        counts=z["counts"],
        window_ids=z["window_ids"],
        watermark=int(meta["watermark"]),
        dropped=int(meta["dropped"]),
        pending=[tuple(r) for r in z["pending"].tolist()],
        latency=[tuple(r) for r in z["latency"].tolist()],
        extra={name[2:]: z[name] for name in z.files
               if name.startswith("x_")},
    )


class Checkpointer:
    """Rotating atomic snapshots in a directory.

    ``save`` writes ``ckpt-<seq>.npz`` via tmp-file + ``os.replace`` and
    prunes all but the newest ``keep``; ``load`` returns the newest
    readable snapshot (a torn file from a crash mid-save is skipped, not
    fatal).
    """

    def __init__(self, directory: str, keep: int = 2):
        self.directory = directory
        self.keep = max(keep, 1)
        os.makedirs(directory, exist_ok=True)
        self._seq = max((s for s, _ in self._existing()), default=-1) + 1

    def _existing(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt-") and name.endswith(".npz"):
                try:
                    out.append((int(name[5:-4]),
                                os.path.join(self.directory, name)))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, snapshot: Snapshot) -> str:
        snapshot.meta["seq"] = self._seq
        path = os.path.join(self.directory, f"ckpt-{self._seq:08d}.npz")
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **_encode(snapshot))
                f.flush()
                os.fsync(f.fileno())  # rename-before-data = torn npz
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self._seq += 1
        for _, old in self._existing()[:-self.keep]:
            os.unlink(old)
        return path

    def load(self) -> Snapshot | None:
        for _, path in reversed(self._existing()):
            try:
                with np.load(path) as z:
                    return _decode(z)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile):
                continue  # torn/corrupt file: fall back to an older one
        return None
