"""Count-based micro-batch mode: the fork's barrier-aligned windows.

The port of ``streambench_tpu/engine/microbatch.py``.  The reference
fork's research vehicle (``MockWindowedFlatMap``,
``AdvertisingTopologyNative.java:167-254``) replaces event-time windows
with *count-based* ones: each of ``map.partitions`` parallel mappers
buffers ``window.size / map.partitions`` events, then all partitions
rendezvous at a window barrier; the last partition to arrive becomes the
owner and stamps the window's start time into Redis, the rest spin on
``HGET start_time``.  Every event is tagged with that shared stamp, and the
downstream processor records per-window latency ``now − start`` which it
dumps to a Redis hash at job close (``CampaignProcessor``, ``:477-533``).

Here:

- the per-window work (filter "view" -> join -> per-campaign count) is
  one masked count over the whole window on the device: the join is
  ``ops.windowcount.gather_rows``, the count the kernel K1
  (``ops.count.count_cells``) into a fresh ``[C, 1]`` plane.  A
  micro-batch IS a window, so the keyed shuffle collapses to a single
  ``[C]`` count vector per partition, merged across partitions by
  addition on the host;
- in-process partitions align on a ``threading.Barrier`` whose action
  stamps the window (``LocalWindowBarrier``); distributed processes use
  ``RedisWindowBarrier``, the fork's protocol with one fix: the fork
  HDELs a *shared* ``start_time`` field on window entry, which lets a
  late-arriving partition delete the stamp the owner just wrote; here
  stamps are per-window-index fields ``start_time:<k>``, so nothing is
  ever deleted while being waited on;
- the latency dump keeps the fork's exact hash schema
  (``redis.hashtable``: ``thread_idx``, ``running_time:<i>``,
  ``<windowStart>:<i>`` -> latency) via ``dump_latency_hash``.

The ``P`` mapper threads fold on one device: each copies its window's
columns in, launches the fold and copies the ``[C]`` counts back before
it records the window's latency, so ``now − start`` includes the device
round trip.  Partitions each consume their own broker partition.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from streambench_tpu_torch.config import BenchmarkConfig
from streambench_tpu_torch.encode.native_encoder import make_encoder
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import RedisLike, dump_latency_hash
from streambench_tpu_torch.ops import hll
from streambench_tpu_torch.ops.count import count_cells
from streambench_tpu_torch.ops.windowcount import gather_rows
from streambench_tpu_torch.utils.device import resolve_device
from streambench_tpu_torch.utils.ids import now_ms


# ----------------------------------------------------------------------
# window barriers
# ----------------------------------------------------------------------

class LocalWindowBarrier:
    """In-process rendezvous: the barrier action stamps the window start.

    The action runs exactly once per generation before any waiter is
    released, so every partition reads the same stamp — the same role the
    fork's "last HINCRBY arrival" owner plays.
    """

    def __init__(self, n_partitions: int, timeout_s: float = 60.0,
                 on_window=None):
        self._stamps: dict[int, int] = {}
        self._timeout = timeout_s
        self.ended = False  # abort() was an end-of-stream, not a timeout
        self._on_window = on_window
        # Resume support: a run restored from a window-k checkpoint keeps
        # window ordinals, but this barrier's generations restart at 0 —
        # base_window rebases stamp keys so arrive(k + g) finds them.
        self.base_window = 0
        self._barrier = threading.Barrier(n_partitions, action=self._stamp)

    def _stamp(self) -> None:
        # generations are sequential: all partitions are at window k here
        k = self.base_window + len(self._stamps)
        self._stamps[k] = now_ms()
        if self._on_window is not None:
            # Every partition is parked in wait(): windows 0..k-1 are
            # fully folded and no result dict can mutate concurrently —
            # the one quiescent point in the run (used for checkpoints).
            self._on_window(k)

    def arrive(self, window_idx: int) -> int:
        try:
            self._barrier.wait(self._timeout)
        except threading.BrokenBarrierError:
            # CPython Barrier race: a peer that already passed this
            # generation can abort() (end-of-stream) before WE re-check
            # the barrier state on wake-up, poisoning a generation that
            # in fact completed.  The stamp discriminates exactly: the
            # barrier action ran (stamp exists) iff our generation
            # completed — return it; only a genuinely un-assembled
            # window falls through.
            if window_idx in self._stamps:
                return self._stamps[window_idx]
            if self.ended:
                raise  # normal end-of-stream release (drive() swallows it)
            # Barrier.wait's own timeout also breaks the barrier; surface
            # it as the error it is instead of a silent partial result.
            raise TimeoutError(
                f"window barrier {window_idx}: a partition failed to "
                f"arrive within {self._timeout}s") from None
        return self._stamps[window_idx]

    def abort(self) -> None:
        """End the run: once any partition hits end-of-stream no further
        window can ever assemble (the barrier needs all parties), so
        waiting peers are released with ``BrokenBarrierError`` and their
        in-flight window is dropped — consistent with the no-partial-
        windows rule."""
        self.ended = True
        self._barrier.abort()

    def reset(self) -> None:
        """No-op: a fresh object IS a fresh barrier (state is in-process)."""


class RedisWindowBarrier:
    """The fork's Redis barrier, with per-window stamp keys (see module
    docstring for the delete-race fix).  Protocol per window ``k``:

    - ``HINCRBY <table> partition_count 1``; the arrival that brings the
      count to ``n_partitions`` resets it to 0 and becomes the owner
      (``start_new_window``, ``AdvertisingTopologyNative.java:228-238``);
    - owner: ``HSET <table> start_time:<k> now`` (``finish_window``);
    - others: 1 ms-sleep spin on ``HGET start_time:<k>`` (``wait_window``).

    Construction is **side-effect-free**: residue from a prior run
    (``partition_count`` left by an aborted run's already-arrived spinners,
    a stale ``aborted`` broadcast) is cleared by ``reset()``, which
    ``run_microbatch`` calls exactly once before any partition starts — a
    per-partition constructor clear would itself race with peers already
    arriving, and can erase a live run's end-of-stream broadcast.  (The
    fork has both flaws and leans on the harness FLUSHALL between runs.)
    Runs sharing one hashtable can alternatively be isolated with
    ``run_id``, which namespaces every barrier field.
    """

    def __init__(self, redis: RedisLike, hashtable: str, n_partitions: int,
                 poll_interval_s: float = 0.001, timeout_s: float = 60.0,
                 run_id: str = ""):
        self.redis = redis
        self.table = hashtable
        self.n = n_partitions
        self._poll = poll_interval_s
        self._timeout = timeout_s
        suffix = f":{run_id}" if run_id else ""
        self._f_count = "partition_count" + suffix
        self._f_abort = "aborted" + suffix
        self._f_stamp = "start_time" + suffix

    def reset(self) -> None:
        """Clear this run's barrier fields.  MUST be called exactly once,
        by the run, before any partition can arrive.

        Clears the per-window stamps too: a stale ``start_time:<k>`` from
        a prior run would satisfy a spinner *instantly* — partitions would
        stop rendezvousing at all and every event would carry the previous
        run's stamp (garbage latencies)."""
        self.redis.execute("HDEL", self.table, self._f_count)
        self.redis.execute("HDEL", self.table, self._f_abort)
        prefix = self._f_stamp + ":"
        flat = (self.redis.hgetall(self.table)
                if hasattr(self.redis, "hgetall") else {})
        for name in flat:
            if name.startswith(prefix):
                self.redis.execute("HDEL", self.table, name)

    def arrive(self, window_idx: int) -> int:
        if self.redis.execute("HGET", self.table, self._f_abort) is not None:
            raise threading.BrokenBarrierError
        my = int(self.redis.execute("HINCRBY", self.table, self._f_count, 1))
        field_ = f"{self._f_stamp}:{window_idx}"
        if my == self.n:
            self.redis.execute("HSET", self.table, self._f_count, "0")
            stamp = now_ms()
            self.redis.execute("HSET", self.table, field_, str(stamp))
            return stamp
        deadline = time.monotonic() + self._timeout
        while True:
            res, ab = self.redis.pipeline_execute(
                [("HGET", self.table, field_),
                 ("HGET", self.table, self._f_abort)])
            if res is not None:
                return int(res)
            if ab is not None:
                # a peer hit end-of-stream: this window can never assemble
                raise threading.BrokenBarrierError
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"window barrier {window_idx}: no stamp after "
                    f"{self._timeout}s (partition died?)")
            time.sleep(self._poll)

    def abort(self) -> None:
        """End-of-stream broadcast: release peers parked in ``arrive``
        (their in-flight window is dropped, matching the local barrier)."""
        self.redis.execute("HSET", self.table, self._f_abort, "1")


# ----------------------------------------------------------------------
# the per-window device fold
# ----------------------------------------------------------------------

def window_campaign_counts(join_table: torch.Tensor, ad_idx: torch.Tensor,
                           event_type: torch.Tensor, valid: torch.Tensor,
                           *, num_campaigns: int,
                           view_type: int = 0) -> torch.Tensor:
    """One micro-batch window -> per-campaign view counts ``[C]`` int32.

    The whole fork chain (EventFilterBolt -> project -> RedisJoinBolt ->
    keyBy(campaign) -> count) as one masked count: the join is a gather,
    the keyed shuffle K1 counting into a fresh ``[C, 1]`` plane (every
    row in slot 0)."""
    campaign = gather_rows(join_table, ad_idx)
    mask = valid & (event_type == view_type) & (campaign >= 0)
    counts = torch.zeros((num_campaigns, 1), dtype=torch.int32,
                         device=join_table.device)
    count_cells(counts, campaign, torch.zeros_like(campaign), mask)
    return counts.view(-1)


def window_campaign_hll(join_table: torch.Tensor, ad_idx: torch.Tensor,
                        user_idx: torch.Tensor, event_type: torch.Tensor,
                        valid: torch.Tensor, *, num_campaigns: int,
                        num_registers: int,
                        view_type: int = 0) -> torch.Tensor:
    """One micro-batch window -> per-campaign HLL registers ``[C, R]``
    int32.

    The sketch variant of ``window_campaign_counts`` (BASELINE config #2
    under the fork's count-window mode): a scatter-max of splitmix ranks
    (``ops.hll``'s, the reference's float32 rank rounding at p < 8
    included).  torch has no scatter ``mode="drop"``: rows that do not
    count go to the pad element ``C·R`` of a ``[C·R + 1]`` buffer.
    Partition partials merge by elementwise max."""
    C, R = num_campaigns, num_registers
    p = R.bit_length() - 1
    campaign = gather_rows(join_table, ad_idx)
    mask = valid & (event_type == view_type) & (campaign >= 0)
    h = hll.splitmix32(user_idx)
    rank = hll._rank(h, p)
    flat = torch.where(mask, campaign.to(torch.int64) * R + (h & (R - 1)),
                       C * R)
    regs = torch.zeros(C * R + 1, dtype=torch.int32, device=join_table.device)
    regs.scatter_reduce_(0, flat, rank, "amax", include_self=True)
    return regs[:C * R].view(C, R)


class _EngineFamily:
    """Per-window fold + cross-partition merge for one engine family."""

    def __init__(self, name: str, fold, merge, finalize):
        self.name = name
        self.fold = fold          # (encoder_batch) -> np.ndarray
        self.merge = merge        # (partial, partial) -> partial
        self.finalize = finalize  # merged partial -> [C] int counts


def _columns(device: torch.device, *arrays: np.ndarray) -> list[torch.Tensor]:
    """Host columns of one window on the fold's device."""
    return [torch.from_numpy(a).to(device) for a in arrays]


def _make_family(name: str, encoder, join_table_dev: torch.Tensor,
                 registers: int = 128) -> _EngineFamily:
    C = encoder.num_campaigns
    dev = join_table_dev.device
    # each fold returns host numpy: the copy back waits for the device,
    # so a window's latency includes the round trip
    if name == "exact":
        return _EngineFamily(
            "exact",
            fold=lambda b: window_campaign_counts(
                join_table_dev, *_columns(dev, b.ad_idx, b.event_type,
                                          b.valid),
                num_campaigns=C).cpu().numpy(),
            merge=lambda a, b: a + b,
            finalize=lambda m: m)
    if name == "hll":
        if registers & (registers - 1):
            raise ValueError("num_registers must be a power of two")
        # Stateless id hashing: per-partition encoders would otherwise
        # intern the same user to different indices, and the register
        # merge across partitions would count one user several times.
        encoder.set_hash_ids(True)
        return _EngineFamily(
            "hll",
            fold=lambda b: window_campaign_hll(
                join_table_dev, *_columns(dev, b.ad_idx, b.user_idx,
                                          b.event_type, b.valid),
                num_campaigns=C, num_registers=registers).cpu().numpy(),
            merge=np.maximum,
            finalize=lambda m: torch.round(hll.estimate(
                torch.from_numpy(m))).numpy().astype(np.int64))
    raise ValueError(
        f"micro-batch mode supports engine families 'exact' and 'hll'; "
        f"'{name}' has no count-window form (sliding windows need a time "
        f"axis and session windows a gap axis — the fork's mode is "
        f"count-based, AdvertisingTopologyNative.java:200-201)")


# ----------------------------------------------------------------------
# per-partition mapper + multi-partition run
# ----------------------------------------------------------------------

@dataclass
class PartitionResult:
    partition: int
    windows: int = 0
    events: int = 0
    started_ms: int = 0    # first window start stamp
    finished_ms: int = 0   # completion time of the last window
    # window index -> per-campaign counts [C].  Indexed by window ordinal,
    # not stamp: in catchup runs consecutive windows can share a
    # millisecond and stamp-keyed state would silently merge them (the
    # fork has exactly this hazard — its latency map is stamp-keyed).
    counts: dict[int, np.ndarray] = field(default_factory=dict)
    # window index -> barrier stamp (shared across partitions)
    stamps: dict[int, int] = field(default_factory=dict)
    # window start stamp -> last observed latency (now - start), fork style
    latency: dict[int, int] = field(default_factory=dict)
    # window index -> broker byte offset after the window's last line
    # (the checkpoint unit: resume re-opens the reader here)
    offsets: dict[int, int] = field(default_factory=dict)

    @property
    def running_time_ms(self) -> int:
        return max(self.finished_ms - self.started_ms, 0)


class MicroBatchMapper:
    """One map partition: buffer ``partition_size`` lines, rendezvous,
    fold the window on the device, record latency."""

    def __init__(self, cfg: BenchmarkConfig, encoder, join_table_dev,
                 barrier, partition: int, input_format: str = "json",
                 family: _EngineFamily | None = None):
        if cfg.window_size < cfg.map_partitions:
            raise ValueError(
                f"window.size {cfg.window_size} is smaller than "
                f"map.partitions {cfg.map_partitions}: a partition would "
                f"buffer no event")
        # The fork's integer division (AdvertisingTopologyNative.java:
        # 200-201): each partition buffers window.size // map.partitions
        # events, 1,666 at the stock 5000 / 3.  (The JAX package refuses
        # a window.size that map.partitions does not divide, and so the
        # stock configuration.)
        self.partition_size = cfg.window_size // cfg.map_partitions
        self.encoder = encoder
        self.join_table_dev = join_table_dev
        self.barrier = barrier
        self.family = family or _make_family("exact", encoder,
                                             join_table_dev)
        # "json" for generator journals; "tbl" for the fork's pipe-separated
        # events files (AdvertisingTopologyNative.java:210: "u|p|ad|...")
        self._encode = (encoder.encode if input_format == "json"
                        else encoder.encode_tbl)
        self.result = PartitionResult(partition)
        self._buf: list[bytes] = []
        self._window_idx = 0
        self._bytes = 0  # broker bytes consumed (lines + newlines)

    def feed(self, lines: list[bytes]) -> None:
        for line in lines:
            self._buf.append(line)
            self._bytes += len(line) + 1
            if len(self._buf) == self.partition_size:
                self._close_window()

    def _close_window(self) -> None:
        start = self.barrier.arrive(self._window_idx)
        batch = self._encode(self._buf, self.partition_size)
        counts = self.family.fold(batch)
        r = self.result
        r.counts[self._window_idx] = counts
        r.stamps[self._window_idx] = start
        r.offsets[self._window_idx] = self._bytes
        done = now_ms()
        r.latency[start] = done - start
        if not r.started_ms:
            r.started_ms = start
        r.finished_ms = done
        r.windows += 1
        r.events += len(self._buf)
        self._buf.clear()
        self._window_idx += 1

    @property
    def leftover(self) -> int:
        """Events short of a full window at end of stream (the fork simply
        never emits a partial window; neither do we)."""
        return len(self._buf)


class MicroBatchCheckpointer:
    """Window-boundary snapshots of a micro-batch run, as INCREMENTAL
    chunks.

    Chunk ``mb-<k>.npz`` holds, per partition, only the windows since
    the previous chunk (``[k_from, k)``): their stacked partials and
    stamps, plus the cumulative small state (latency map, counters, and
    the broker byte offset after window ``k-1``'s last line).  Chunking
    keeps each save O(windows since last save) — a full-history rewrite
    would grow O(k) per save inside the window barrier's action, whose
    waiters carry a 60 s timeout, and would bill ever-growing fsync
    pauses to measured windows.  Snapshots are written inside the
    barrier action (the one quiescent point: all partitions parked,
    windows ``0..k-1`` final), so they need no locking; single-process
    (``LocalWindowBarrier``) runs only.  ``load`` replays the chunk
    chain (contiguity checked) and seeds the run to continue at the
    last chunk's ``k``.  The files are the reference's, key for key.
    """

    def __init__(self, directory: str):
        self.dir = directory
        self._saved_upto = 0
        os.makedirs(directory, exist_ok=True)

    def _files(self) -> list[str]:
        return sorted(glob.glob(os.path.join(self.dir, "mb-*.npz")))

    def save(self, k: int, mappers, meta: dict) -> None:
        k0 = self._saved_upto
        if k <= k0:
            return  # resumed run re-arrives at an already-saved window
        arrays: dict[str, np.ndarray] = {}
        per_part = []
        for m in mappers:
            r = m.result
            arrays[f"counts_{r.partition}"] = np.stack(
                [r.counts[w] for w in range(k0, k)])
            stamps = [r.stamps[w] for w in range(k0, k)]
            chunk_stamps = set(stamps)
            per_part.append({
                "partition": r.partition,
                "stamps": stamps,
                # ONLY this chunk's windows, looked up by the chunk's
                # own stamps so save cost is O(chunk) — iterating the
                # cumulative map would still grow O(total windows) per
                # save inside the barrier action; load() merges chunks
                "latency": sorted((s, r.latency[s]) for s in chunk_stamps
                                  if s in r.latency),
                "offset": r.offsets[k - 1],
                "events": r.events, "windows": r.windows,
                "started_ms": r.started_ms, "finished_ms": r.finished_ms,
            })
        path = os.path.join(self.dir, f"mb-{k:08d}.npz")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, meta=np.frombuffer(json.dumps(
                {"k_from": k0, "k": k, "parts": per_part, **meta}
            ).encode(), np.uint8), **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._saved_upto = k

    def load(self) -> tuple[int, dict, dict[int, np.ndarray]] | None:
        files = self._files()
        if not files:
            return None
        chunks: dict[int, list[np.ndarray]] = {}
        stamps: dict[int, list[int]] = {}
        latency: dict[int, dict] = {}
        expect = 0
        meta = None
        for path in files:
            with np.load(path) as z:
                meta = json.loads(z["meta"].tobytes().decode())
                if meta["k_from"] != expect:
                    raise ValueError(
                        f"checkpoint chain broken at {path}: chunk starts "
                        f"at window {meta['k_from']}, expected {expect} "
                        f"(missing/deleted chunk file?)")
                expect = meta["k"]
                for p in meta["parts"]:
                    chunks.setdefault(p["partition"], []).append(
                        z[f"counts_{p['partition']}"])
                    stamps.setdefault(p["partition"], []).extend(
                        p["stamps"])
                    # per-chunk latency entries merge across the chain
                    # (later chunks win for a re-observed stamp)
                    latency.setdefault(p["partition"], {}).update(
                        dict(p["latency"]))
        for p in meta["parts"]:
            p["stamps"] = stamps[p["partition"]]
            p["latency"] = sorted(latency[p["partition"]].items())
        counts = {part: np.concatenate(cs) for part, cs in chunks.items()}
        self._saved_upto = meta["k"]
        return meta["k"], meta, counts

    def seed(self, mappers, meta: dict,
             counts: dict[int, np.ndarray]) -> None:
        """Restore mapper state from a loaded snapshot (before threads
        start).  Readers must then be opened at each result's
        ``offsets[k-1]``."""
        k = meta["k"]
        for m, pm in zip(mappers, meta["parts"]):
            r = m.result
            assert r.partition == pm["partition"]
            for w in range(k):
                r.counts[w] = counts[r.partition][w]
                r.stamps[w] = pm["stamps"][w]
            r.latency.update({int(s): int(l) for s, l in pm["latency"]})
            r.offsets[k - 1] = pm["offset"]
            r.events = pm["events"]
            r.windows = pm["windows"]
            r.started_ms = pm["started_ms"]
            r.finished_ms = pm["finished_ms"]
            m._window_idx = k
            m._bytes = pm["offset"]


def run_microbatch(cfg: BenchmarkConfig, broker: FileBroker,
                   ad_to_campaign: dict[str, str],
                   campaigns: list[str] | None = None,
                   redis: RedisLike | None = None,
                   barrier=None,
                   max_windows: int | None = None,
                   input_format: str = "json",
                   engine: str = "exact",
                   registers: int = 128,
                   checkpoint_dir: str | None = None,
                   checkpoint_every: int = 16,
                   device: torch.device | str | None = None,
                   ) -> tuple[dict[int, np.ndarray], list[PartitionResult]]:
    """Drive ``map.partitions`` mapper threads over the broker topic.

    Returns ``(merged, results)``: merged per-campaign counts keyed by
    window ordinal (partition partials summed for exact counts, register
    max + estimate for ``engine="hll"`` — the unifier /
    ``reduce.partitions`` role) and the per-partition results.
    When ``redis`` is given, each partition dumps its latency map in the
    fork's hash format at close.
    ``checkpoint_dir`` enables window-boundary snapshots every
    ``checkpoint_every`` windows and resume-from-newest on entry
    (single-process runs only).  ``device`` is where the windows fold:
    ``cuda`` unless the caller asks for ``cpu``.
    """
    dev = resolve_device(device)
    P = cfg.map_partitions
    have = set(broker.partitions(cfg.kafka_topic))
    missing = [p for p in range(P) if p not in have]
    if missing:
        raise ValueError(
            f"map.partitions={P} but broker topic '{cfg.kafka_topic}' has "
            f"no partition(s) {missing} (found {sorted(have)}); generate "
            f"the dataset with a matching partition count")
    ckpt = MicroBatchCheckpointer(checkpoint_dir) if checkpoint_dir else None
    if ckpt is not None and barrier is not None:
        raise ValueError(
            "micro-batch checkpointing requires the in-process barrier "
            "(snapshots are taken in its action, where all partitions are "
            "quiescent); it does not compose with a custom/Redis barrier")
    if ckpt is not None:
        # The id digest binds the snapshot to the campaign/ad universe its
        # count columns are keyed to: resuming against regenerated ids
        # would otherwise silently merge restored rows with columns for
        # DIFFERENT campaigns.
        h = hashlib.sha1()
        for ad, c in sorted(ad_to_campaign.items()):
            h.update(f"{ad}>{c};".encode())
        for c in campaigns or ():
            h.update(f"#{c}".encode())
        mb_meta = {"engine": engine, "window_size": cfg.window_size,
                   "map_partitions": P,
                   "registers": registers if engine == "hll" else 0,
                   "ids_digest": h.hexdigest()[:16]}
        loaded = ckpt.load()
        if loaded is not None and loaded[1] is not None:
            got = {key: loaded[1].get(key) for key in mb_meta}
            if got != mb_meta:
                raise ValueError(
                    f"checkpoint geometry {got} != run config {mb_meta}; "
                    f"restart with the original config or a fresh "
                    f"checkpoint dir")

        def on_window(k: int) -> None:
            if k and k % checkpoint_every == 0:
                ckpt.save(k, mappers, mb_meta)

        barrier = LocalWindowBarrier(P, on_window=on_window)
    else:
        loaded = None
        barrier = barrier or LocalWindowBarrier(P)
    # THE single reset point (see RedisWindowBarrier docstring): clear any
    # prior run's residue before the first partition can arrive.
    barrier.reset()
    # ONE ENCODER PER MAPPER THREAD: encoders carry mutable intern state
    # (user/page maps, rebase origin) that is not thread-safe.  The join
    # table is deterministic from the mapping, so one device copy is
    # shared.
    encoders = [make_encoder(ad_to_campaign, campaigns,
                             divisor_ms=cfg.jax_time_divisor_ms,
                             lateness_ms=cfg.jax_allowed_lateness_ms,
                             use_native=cfg.jax_use_native_encoder)
                for _ in range(P)]
    join_table_dev = torch.from_numpy(
        np.asarray(encoders[0].join_table, np.int32)).to(dev)
    families = [_make_family(engine, encoders[p], join_table_dev,
                             registers=registers) for p in range(P)]
    mappers = [MicroBatchMapper(cfg, encoders[p], join_table_dev, barrier, p,
                                input_format=input_format,
                                family=families[p])
               for p in range(P)]
    resume_offsets = [0] * P
    if ckpt is not None and loaded is not None:
        k0, meta0, counts0 = loaded
        ckpt.seed(mappers, meta0, counts0)
        resume_offsets = [m.result.offsets[k0 - 1] if k0 else 0
                          for m in mappers]
        # the barrier's stamp generations restart at 0; rebase them so
        # arrive(window_idx=k0...) finds its stamps
        barrier.base_window = k0
    # Warm the fold before spawning threads, as the reference warms its
    # jit: build K1's library and run the window fold once (one launch
    # on the card) on all-masked rows, so the first window of every
    # mapper does not pay for the build.
    psize = mappers[0].partition_size
    C = encoders[0].num_campaigns
    zeros = torch.zeros(psize, dtype=torch.int32, device=dev)
    none_valid = torch.zeros(psize, dtype=torch.bool, device=dev)
    no_type = torch.full((psize,), -1, dtype=torch.int32, device=dev)
    if engine == "hll":
        window_campaign_hll(join_table_dev, zeros, zeros, no_type,
                            none_valid, num_campaigns=C,
                            num_registers=registers).cpu()
    else:
        window_campaign_counts(join_table_dev, zeros, no_type, none_valid,
                               num_campaigns=C).cpu()

    limit = max_windows * psize if max_windows else None
    errors: list[BaseException] = []

    def drive(p: int) -> None:
        try:
            with broker.reader(cfg.kafka_topic, p) as reader:
                if resume_offsets[p]:
                    reader.seek(resume_offsets[p])
                fed = 0
                while True:
                    want = (min(4096, limit - fed)
                            if limit is not None else 4096)
                    if want <= 0:
                        break
                    lines = reader.poll(max_records=want)
                    if not lines:
                        break
                    mappers[p].feed(lines)
                    fed += len(lines)
            # end-of-stream: no further window can assemble without this
            # partition; release any peers parked at the rendezvous
            barrier.abort()
        except threading.BrokenBarrierError:
            pass  # a peer hit end-of-stream; our partial window is dropped
        except BaseException as e:  # surface thread failures to the caller
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=drive, args=(p,), daemon=True)
               for p in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]

    fam = families[0]
    merged: dict[int, np.ndarray] = {}
    for m in mappers:
        for k, partial in m.result.counts.items():
            if k in merged:
                merged[k] = fam.merge(merged[k], partial)
            else:
                merged[k] = partial
    merged = {k: fam.finalize(v) for k, v in merged.items()}

    if redis is not None and cfg.redis_hashtable:
        for m in mappers:
            dump_latency_hash(redis, cfg.redis_hashtable, m.result.latency,
                              running_time_ms=m.result.running_time_ms)
    return merged, [m.result for m in mappers]
