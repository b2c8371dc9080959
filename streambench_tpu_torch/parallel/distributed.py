"""Multi-process backend: the sharded engine with one partition per rank.

The port of ``streambench_tpu/parallel/distributed.py``.  The JAX package
joins processes into ``jax.distributed`` and builds one mesh over every
host's devices; here every process is one rank of a ``torch.distributed``
group and one device of the mesh:

- ``init_distributed`` joins (or starts) the process group, from the
  ``STREAMBENCH_COORDINATOR`` / ``STREAMBENCH_NUM_PROCESSES`` /
  ``STREAMBENCH_PROCESS_ID`` variables as in the reference;
- ``global_mesh`` is the ``(data, campaign)`` mesh over all ranks;
- ``cross_host_barrier`` is ``dist.barrier``;
- ``DistributedWindowEngine`` is the sharded engine with (a) per-rank
  ingest: each rank reads its own partition and encodes a LOCAL batch of
  ``jax_batch_size`` rows, and the fold gathers all of them, so the
  global batch is ``B x world`` (no rank holds it before the gather); and
  (b) shard-owned flushes: one elected replica of each campaign shard
  writes that shard's rows, so the writeback runs on several ranks with
  no duplicate rows;
- ``run_distributed_catchup`` drives it in lockstep, with one host vote a
  round on the gloo group.

Tested with real process separation: gloo ranks on the CPU, one shared
RESP server (``tests/test_torch_distributed.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from streambench_tpu_torch.config import BenchmarkConfig
from streambench_tpu_torch.engine.runner import StreamRunner
from streambench_tpu_torch.io.redis_schema import RedisLike
from streambench_tpu_torch.ops import windowcount as wc
from streambench_tpu_torch.parallel.mesh import (
    CAMPAIGN_AXIS,
    DATA_AXIS,
    DEFAULT_TIMEOUT_S,
    Mesh,
    build_mesh,
    init_process_group,
)
from streambench_tpu_torch.parallel.sharded import (
    ShardedWindowEngine,
    _host_allgather,
)
from streambench_tpu_torch.utils.ids import now_ms


@dataclass(frozen=True)
class DistContext:
    process_id: int
    num_processes: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: torch.device | str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> DistContext:
    """Join the process group for ``device`` (default ``"cuda"``: NCCL;
    ``"cpu"``: gloo).  Arguments default to the ``STREAMBENCH_*``
    variables; a single process starts a world-size-1 group."""
    rank, world, _ = init_process_group(
        device, coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id,
        timeout_s=timeout_s)
    return DistContext(rank, world)


def global_mesh(campaign: int = 1,
                device: torch.device | str | None = None) -> Mesh:
    """(data x campaign) mesh over every rank of the process group."""
    return build_mesh(campaign=campaign, device=device)


def cross_host_barrier(name: str = "") -> None:
    """All ranks rendezvous (the Redis-spin replacement); ``name`` labels
    the call site, as the reference's does."""
    dist.barrier()


class DistributedWindowEngine(ShardedWindowEngine):
    """Sharded engine across processes: local ingest, shard-owned flushes.

    Each rank tails its own partition(s) and encodes a LOCAL batch; the
    fold gathers every rank's batch over all ranks (the global batch is
    ``B x world``, in rank order).  ``base_time_ms`` must be agreed across
    ranks up front (window ids are relative to it): pass the dataset
    start, or any value every rank computes identically.  Every rank
    drives its own engine in lockstep (``run_distributed_catchup``); none
    follows another."""

    COMMANDED = False
    # Lockstep: collective call counts must match across ranks, so no
    # multi-batch chunking of any kind.
    SCAN_SUPPORTED = False

    def __init__(self, cfg: BenchmarkConfig, ad_to_campaign: dict[str, str],
                 mesh: Mesh, base_time_ms: int,
                 campaigns: list[str] | None = None,
                 redis: RedisLike | None = None, method: str | None = None,
                 device: torch.device | str | None = None):
        super().__init__(cfg, ad_to_campaign, mesh, campaigns=campaigns,
                         redis=redis, method=method, device=device)
        self.encoder.set_base_time(base_time_ms)
        # the batch is gathered over ALL ranks; each brings whole batches
        self._axes = self._axes._replace(gather=mesh.world_group)
        self._data_pad = 0

    # -- the ONE copy of the lockstep ring-safety invariant ------------
    # Every device call of this engine is a collective, so drain
    # decisions must be identical on every rank: they are always
    # computed from GLOBAL (voted) spans through these helpers, never
    # from local batch times (the base class also halves over-wide
    # batches, a shape change that would diverge).

    def drain_due(self, lo: int, hi: int) -> bool:
        """Deterministic drain decision for one lockstep step with global
        event-time span [lo, hi].  Raises if a single step outspans the
        ring (lockstep batches cannot halve)."""
        if hi - lo > self._span_guard:
            raise ValueError(
                f"one lockstep batch spans {hi - lo} ms of event time; "
                f"ring-safe span is {self._span_guard} ms -- lower "
                "jax_batch_size or raise jax_window_slots (lockstep "
                "batches cannot halve: shapes must match across ranks)")
        return (self._span_start is not None
                and hi - self._span_start > self._span_guard)

    def apply_drain(self, lo: int) -> None:
        with self.tracer.span("drain"):
            self._drain_device()
        self._span_start = lo

    def note_span(self, lo: int) -> None:
        if self._span_start is None:
            self._span_start = lo

    def _fold(self, batch) -> None:
        """Lockstep fold of one batch: span accounting on GLOBAL batch
        extrema, exchanged with one small host all-gather a step
        (``run_distributed_catchup`` amortizes it to one a round)."""
        gmin, gmax = self._global_batch_span(batch)
        if gmax >= gmin:  # any rank had data
            if self.drain_due(gmin, gmax):
                self.apply_drain(gmin)
            else:
                self.note_span(gmin)
        self._device_step(batch)
        self.events_processed += batch.n
        self.last_event_ms = now_ms()

    def _global_batch_span(self, batch) -> tuple[int, int]:
        """(min, max) absolute event time over ALL ranks' batches."""
        base = batch.base_time_ms
        if batch.n:
            vt = batch.event_time[:batch.n]
            lo, hi = int(vt.min()) + base, int(vt.max()) + base
        else:
            lo, hi = np.iinfo(np.int64).max, np.iinfo(np.int64).min
        spans = _host_allgather(np.array([lo, hi], np.int64),
                                self.mesh.host_group)
        return int(spans[:, 0].min()), int(spans[:, 1].max())

    def process_chunk(self, lines: list[bytes]) -> int:
        return self.process_lines(lines)

    def _device_step(self, batch) -> None:
        self._step_local(
            [self._to_device(c) for c in (batch.ad_idx, batch.event_type,
                                          batch.event_time, batch.valid)],
            False)

    def fold_round(self, batches: list, steps: int) -> None:
        """Fold ``steps`` lockstep batches in ONE hoisted scan with NO host
        exchanges.  The caller has agreed the round globally (every rank
        calls with the same ``steps``; drains came from voted spans).
        Local batches short of ``steps`` are padded with all-invalid
        batches (no-ops in the fold; peers still fold real data there)."""
        if steps <= 0:
            return
        template = (batches[0] if batches
                    else self.encoder.encode([], self.batch_size))
        stacks = []
        for name in self.SCAN_COLUMNS:
            arrs = [getattr(b, name) for b in batches]
            arrs += [np.zeros_like(getattr(template, name))
                     ] * (steps - len(batches))
            stacks.append(self._to_device(np.stack(arrs)))
        self._scan_local(stacks, False)
        self.events_processed += sum(b.n for b in batches)
        self.last_event_ms = now_ms()

    def process_lines(self, lines: list[bytes]) -> int:
        """One lockstep step per call: at most one batch of lines (the
        caller paces steps; chunking like the base class would
        desynchronize collective call counts across ranks)."""
        if len(lines) > self.batch_size:
            raise ValueError(
                f"{len(lines)} lines exceed one lockstep batch "
                f"({self.batch_size}); the caller must pace steps")
        with self.tracer.span("encode"):
            batch = self.encoder.encode(lines, self.batch_size)
        self._fold(batch)
        return len(lines)

    def _drain_device(self) -> None:
        """Drain ONLY this rank's campaign shard, and write it only if this
        rank is the shard's elected owner replica.  Ranks own disjoint
        row ranges, so owners flush disjoint campaign sets; no collective
        is issued."""
        # This engine drains densely per shard; the base class's dirty-row
        # tracker is unused here and must not grow forever.
        self._dirty_rows.clear()
        local, wids, self.state = wc.flush_deltas(
            self.state, divisor_ms=self.divisor, lateness_ms=self.lateness)
        self._span_start = None
        # The counts are replicated over the data axis: elect exactly one
        # owner replica of each shard, spread over the replicas so the
        # writeback is balanced instead of landing on rank 0.
        n_rep = self.mesh.shape[DATA_AXIS]
        n_blocks = self.mesh.shape[CAMPAIGN_AXIS]
        block = self.mesh.campaign_index
        if self.mesh.data_index != (block * n_rep) // n_blocks:
            return
        local = local.cpu().numpy()
        wids = wids.cpu().numpy()
        base = self.encoder.base_time_ms or 0
        num = self.encoder.num_campaigns
        row0 = self._axes.c0
        ci, si = np.nonzero(local)
        for c, s in zip(ci.tolist(), si.tolist()):
            wid = int(wids[s])
            gc = row0 + c
            if wid < 0 or gc >= num:  # padding rows
                continue
            self._pending[(gc, base + wid * self.divisor)] += int(local[c, s])


def run_distributed_catchup(engine: DistributedWindowEngine, reader,
                            flush_every: int = 64,
                            max_steps: int | None = None,
                            vote_every: int = 8) -> dict:
    """Lockstep catchup over every rank's local reader, voting once per
    ``vote_every``-step ROUND instead of once per step.

    Each round: poll and encode up to ``vote_every`` local batches, then
    ONE host all-gather exchanges ``[has_more, n_batches, lo_0, hi_0,
    ...]`` per rank.  That vote settles (a) the round length (the most
    any rank has; short ranks pad with no-op batches), (b) termination
    (every rank dry), and (c) the drains, from the GLOBAL per-step spans;
    then the round folds in scanned dispatches with no further host
    traffic.  Returns ``{"events", "steps", "rounds", "votes",
    "vote_s"}``."""
    B = engine.batch_size
    group = engine.mesh.host_group
    NONE_LO, NONE_HI = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    stats = {"events": 0, "steps": 0, "rounds": 0, "votes": 0,
             "vote_s": 0.0}
    est_bytes = StreamRunner.EST_EVENT_BYTES
    block_mode = (engine.supports_block_ingest
                  and hasattr(reader, "poll_block"))
    carry = b""        # block-mode bytes beyond this round's k batches
    done_local = False
    while max_steps is None or stats["steps"] < max_steps:
        k = vote_every
        if max_steps is not None:
            k = min(k, max_steps - stats["steps"])
        batches = []
        if block_mode and not (done_local and not carry):
            # Records can be shorter than the byte estimate, so a read may
            # hold MORE than k batches: the surplus carries to the next
            # round (its bytes are already consumed from the reader).
            data = carry
            budget = B * k * est_bytes - len(carry)
            if not done_local and budget > 0:
                fresh = reader.poll_block(budget)
                if fresh:
                    data = carry + fresh
                else:
                    done_local = True
            batches, start = engine.encoder.carve_block(
                data, B, max_batches=k)
            carry = data[start:]
        elif not block_mode and not done_local:
            lines = reader.poll(max_records=B * k)
            if not lines:
                done_local = True
            for off in range(0, len(lines), B):
                b = engine.encoder.encode(lines[off:off + B], B)
                if b.n:
                    batches.append(b)
        # Vote payload: [has_more, n_batches, lo_0, hi_0, ...] -- PER-
        # BATCH spans, so every rank can place drains mid-round the same
        # way.  ``has_more`` is separate from the batch count: a poll of
        # only unparseable lines yields ZERO batches while the journal
        # still has data behind them.
        base = engine.encoder.base_time_ms or 0
        payload = np.empty(2 + 2 * k, np.int64)
        payload[0] = 0 if (done_local and not batches and not carry) else 1
        payload[1] = len(batches)
        payload[2::2], payload[3::2] = NONE_LO, NONE_HI
        for i, b in enumerate(batches):
            vt = b.event_time[:b.n]
            payload[2 + 2 * i] = int(vt.min()) + base
            payload[3 + 2 * i] = int(vt.max()) + base

        t0 = time.perf_counter()
        summary = _host_allgather(payload, group)
        stats["votes"] += 1
        stats["vote_s"] += time.perf_counter() - t0

        if int(summary[:, 0].max()) == 0:
            break  # every rank is dry
        round_steps = int(summary[:, 1].max())
        if round_steps == 0:
            continue  # someone is mid-journal but encoded nothing yet
        step_lo = summary[:, 2::2].min(axis=0)   # [k] global per-step
        step_hi = summary[:, 3::2].max(axis=0)

        # Group the round's steps into drain-separated segments: the same
        # arithmetic on the same voted data on every rank.
        seg_start = 0
        for i in range(round_steps):
            lo_i, hi_i = int(step_lo[i]), int(step_hi[i])
            if lo_i > hi_i:
                continue  # no rank had data at step i
            if engine.drain_due(lo_i, hi_i):
                engine.fold_round(batches[seg_start:i], i - seg_start)
                seg_start = i
                engine.apply_drain(lo_i)
            else:
                engine.note_span(lo_i)
        engine.fold_round(batches[seg_start:round_steps],
                          round_steps - seg_start)

        prev = stats["steps"]
        stats["steps"] += round_steps
        stats["rounds"] += 1
        # deterministic flush cadence: same step counts -> same flushes
        if stats["steps"] // flush_every != prev // flush_every:
            engine.flush()
    if carry:
        # max_steps exit with consumed-but-unfolded bytes: rewind the
        # reader so a resume replays them instead of skipping records
        reader.seek(reader.offset - len(carry))
    engine.flush()
    engine.drain_writes()  # flush() queues on the writer thread: block
    # until it landed, the function's contract being "flushed to Redis"
    stats["events"] = engine.events_processed
    return stats
