#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``streambench_tpu_torch``).

Drives the port's main path on one CUDA card and fails (non-zero exit, no
result line) when any phase fails:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: the three CUDA kernel libraries (``nvcc``, one per source)
   and the native host library (``g++``), all from the sources in this
   checkout, in parallel.
3. Kernels: the count kernel K1 (``csrc/count_cells.cu``) against its
   plain PyTorch version and a numpy count on the card, exact equality, at
   the main path's shapes and others (``CASES``: Zipf-skewed campaigns and
   ~30 % masked rows, a hot cell, views misaligned by 1 and 3 rows,
   config #5's step on its 256 MB plane, the sharded fold's per-shard
   plane of a four-shard config #5 layout ([250000, 64], three quarters
   of the rows out of shard and masked), and a 16.7M-row bandwidth
   case), each with the launch plan it took; device
   times from CUDA events over CUDA-graph replays and eager call times,
   beside the byte bound at 3.35 TB/s (1 B a row's mask, 8 B an unmasked
   row's campaign and slot, 8 B a touched cell), one ``index_add_`` call as a
   library yardstick, the launch floor (an empty kernel), and the share
   of a warp's rounds of atomics in which two rows hit one cell.  Then
   the decode kernel K2 (``csrc/decode_rows.cu``) against its plain
   PyTorch version on the card, exactly, in the cases of
   ``DECODE_CASES`` (a [8, 4096] group of generator rows; the stock
   catchup's own dispatch, 4096 rows of a half batch padded to one
   8192-row group; pad rows, unknown ads, every event type and times on
   both sides of a 10^9 boundary; ads that sit three or more probes deep
   in the join table; a paced block's dispatch, 10,700 rows in two
   8192-row groups; two table ads and an unknown one with one FNV-1a
   hash; rows at every start mod 16, across both ends of the buffer and
   over random bytes, through an aligned buffer and views 1 and 3 bytes
   into their storage; 100,000 ads, past the shared-memory tier; a full
   journal block, [8, 8192]; and a bandwidth case, [64, 8192]), each
   with the launch plan it took (tier, block size, shared bytes) and the
   rows predicted to take 16-byte loads, its device time over CUDA-graph
   replays, its eager call time, the plain version's device time, the
   byte bound (the join table's slots the lookups reach, each once; each
   row's bytes once; the probes' key reads, served from L2, reported
   apart), and the launch floor (no
   PyTorch call computes this function: no library time).  Last, the
   method table (``ops.methodbench``): the four ``apply_count`` arms
   timed with CUDA events at config #1's geometry (C = 100, W = 16; B =
   4096 and 8192) and config #5's (C = 1e6, W = 64, B = 8192), the arms
   whose operands would not fit marked as skipped.  Then the count-min
   kernel K3 (``csrc/cms_rows.cu``): its six entry points (update,
   query, the two-stage refresh, the hashed columns, and the fused
   ``cms_update_query`` and ``cms2_update_query``) against their plain
   PyTorch versions on the card, exactly, in the cases of ``CMS_CASES``
   (the session engine's step, D = 4, Wd = 2048, 8192 rows of Zipf(1.1)
   keys with a third masked; keys -1 and past 2^28; the two-stage pair
   at Ws = 256, with Zipf and with near-distinct keys; the wide update
   from 65,536 rows; a bandwidth case, 2^22 rows, D = 8, Wd = 2^20),
   each with its device time over
   CUDA-graph replays, eager time, the plain version's device time, the
   byte bound (1 B a row's mask, 4 B a hashed row's key, 4 B an
   unmasked row's weight, 4 B a distinct cell read and 4 B a changed
   cell written, 4 B out a queried row) and its share, and the launch
   floor; each fused entry timed in turns against the separate calls it
   replaces, on the device and per eager call; and ``index_add_``
   over precomputed columns as the update's yardstick (the scatter
   alone: no PyTorch call hashes); then the CMS
   method table at Wd = 2048 (``methodbench.measure_cms``: flat, rowloop,
   twostage, salsa).
4. End to end: BASELINE config #1 (``conf/benchmarkConf.yaml`` with the
   in-process Redis store): generate the catchup journal (5,000,000
   events by default), run ``AdAnalyticsEngine(device="cuda")`` under
   ``StreamRunner.run_catchup``, and require the generator's oracle
   (``gen.check_correct``) to find every window exact and the count
   kernel to have launched during the run; then replay the first
   1,000,000 events under ``torch.profiler`` for the device busy share,
   and once more to keep the rows of every K1 launch.
5. K1 on the main path's own rows: the launches kept in phase 4, held and
   timed as the cases of phase 3 are.
6. Large key space: BASELINE config #5's settings (1,000,000 campaigns x 1
   ad, a 64-slot ring, 8192-event batches, no scan groups) over a
   generated 1,000,000-event journal through ``StreamRunner.run_catchup``,
   oracle-exact, with the drains per branch of ``_drain_device`` (touched
   rows compacted on the card, whole-plane compaction, dense), the
   overflows of the compaction cap, K1's launches, the peak device memory
   and the ``drain`` span; the first drains run under
   ``torch.cuda.set_sync_debug_mode("error")``, so a drain that waits
   for the card fails the phase (``chip_drain_probe.py`` breaks the
   drains' host time down; this run is not instrumented past the check).
7. Exactly-once resume: the stock configuration with
   ``jax.sink.exactly_once: true`` and a checkpoint directory over a
   generated 1,000,000-event journal.  Engine A catches up part of it,
   checkpoints, flushes again after its last checkpoint and is abandoned
   without ``close()``; engine B resumes from the checkpoint on the same
   store and finishes.  B must detect the unfenced flush
   (``sink_unfenced_resumes``), reconcile windows absolute
   (``reconciled_windows``) and leave every window oracle-exact.  The
   same journal then runs once with the flag off, for the writer's cost
   per row without the fence.

8. Pipelined catchup: phase 4's journal again, with
   ``jax.ingest.pipeline: on`` and ``jax.encode.workers: 4``, through
   ``StreamRunner.run_catchup`` (read, encode and fold on three threads,
   the encode on a pool of four native encoders); every window must equal
   phase 4's oracle-checked rows, compared in full.  Its ev/s beside phase
   4's, the stage spans, the pipeline's telemetry and the host's cores.
9. Paced YSB through the port's harness, as users run it: ``python -m
   streambench_tpu_torch.harness TORCH_TEST`` in a fresh workdir (a RESP
   server process, the engine process on ``cuda`` with the pipeline on
   and four encode workers, the generator at 100,000 ev/s for 30 s over
   the file journal, ``-g`` stats, ``VERIFY=1``).  The engine must exit
   0 having folded exactly the events the generator emitted, none
   dropped, with every window in Redis equal to the oracle over the
   journal; the window latency (``updated.txt``) as p50/p90/p99/max.
10. Fake Kafka: the same composite with ``KAFKA_FAKE=1`` (the broker its
   own process, one partition), 10,000 ev/s for 15 s.
11. Observability: phase 9's composite at 100,000 ev/s for 15 s with every
   ported obs knob on (``METRICS_INTERVAL_MS=1000``, ``OBS_LIFECYCLE``,
   ``FLIGHTREC``, ``OBS_SPANS``, ``OBS_OCCUPANCY``, ``OBS_XFER``,
   ``OBS_DEVMEM``, ``OBS_CAPTURE``, ``SLO_P99_MS=15000``).  Besides phase
   9's checks: ``metrics.jsonl`` holds at least 20 records and ``python
   -m streambench_tpu_torch.obs attribution`` reads it; every written
   window carries all five latency segments, whose sums less what the
   clamping at 0 added equal the end-to-end latency's, with clamps only
   where a fold overtook a write in flight (flush, sink) and under one
   flush cycle a write; the lifecycle's largest end-to-end latency is
   ``updated.txt``'s, within one flush cycle; the span trace validates
   under ``obs trace`` and holds the encode, drain, sink, ingest-stage
   and fold-dispatch spans; ``flight_sigterm.jsonl`` exists; the
   ``torch.profiler`` one-shot's trace holds K1's kernel; occupancy
   sampled one dispatch in 32 with a busy ratio in (0, 1] and no library
   build after warmup; the packed wire shipped 8 bytes per row; the
   close line carries the SLO verdict.  It prints the segments' p50 and
   p99, the busy ratio beside the one-shot capture's busy share (the
   union of its device events over its window) and phase 4's profiler
   busy share, the peak
   device memory, K1's launches, and the window latency beside phase
   9's.

12. Device-decode catchup: phase 4's journal again with
   ``jax.decode.device: on`` (the host probes raw blocks, K2 decodes them,
   K1 counts), once serial and once with the ingest pipeline on; every
   window must equal phase 4's oracle-checked rows, compared in full, and
   no generator row may fall back to the host encoder.  Its ev/s beside
   phases 4 and 8, the ``decode_probe`` and ``device_decode`` spans, K1's
   and K2's launches.  The A/B winners go to the method cache, one per
   ingest mode, under ``cuda/devdecode/serial`` and
   ``cuda/devdecode/pipelined``: the device wins only if its run is exact
   and faster than the host encode's in the same mode, phase 4's serial
   and phase 8's pipelined (``$STREAMBENCH_TORCH_METHOD_CACHE``, here a
   file under ``build/``).
13. Paced decode: phase 9's composite with ``DECODE_DEVICE=on``, 100,000
   ev/s for 15 s, ``VERIFY=1``; the window latency beside phase 9's and
   K2's launches from the engine's stats line.

14. Supervised chaos: the chaos layer (``streambench_tpu_torch.chaos``) on
   the card.  Each run's attempts come from a factory that builds a fresh
   engine on ``cuda``, a fault-wrapped reader and a runner, under a
   ``Supervisor`` (``max_no_progress_restarts=8``): (a) config #1 with
   ``jax.sink.exactly_once: true``, 1,000,000 events, the reference's
   exactly-once acceptance plan (seed 1234: sink faults with an outage
   and partial applies, torn/truncated/corrupt journal reads, crashes at
   batch 5, flush 1, batch 2, checkpoint 1), every window exact; (b) the
   same journal at-least-once with ``jax.decode.device: on`` (K2, then
   K1) under the at-least-once acceptance plan, within the bound, with
   only the rows the journal faults damaged falling back to the host
   encoder; (c) config #5's key space (phase 6's deployment, seed 7)
   under a script with a checkpoint crash, within the bound, each restart
   allocating the 256 MB plane and restoring a 256 MB snapshot; (d) the
   in-process fake Kafka, three partitions, 200,000 events, broker
   faults (produce errors, connection drops, a down window) and three
   crashes under exactly-once: oracle-exact, the delivery ledger
   balanced (consumed = delivered + redelivered; delivered = acked plus
   the records the replay segments re-read).  Each run prints its
   attempts, crashes, restarts, backoff, replay segments, the injector's
   counters, K1's launches (and K2's in (b)), per restart the time to
   recover (crash to the next attempt's first folded batch: the
   supervisor's progress check and backoff, engine construction,
   ``resume()`` with its host-to-device restore, the first fold), the
   snapshot and save ms of each checkpoint, and the device memory
   allocated at each restart's first fold and after the run.  Device
   memory must not grow with the crashes: after the run, and at every
   restart, it may exceed the live engine's by at most one crashed
   engine's.

15. Sketch engines: BASELINE configs #2 and #3 on one generated journal
   of 1,000,000 events of the stock topology (seed 61, the in-process
   store): (a) ``HLLDistinctEngine`` (R = 128): its windows are the
   golden's (exact distinct users per campaign and 10 s window over
   views), the estimates' mean relative error under 0.1, none dropped,
   no K1 launch; and against the same engine run on the CPU over the
   same journal, every Redis row within 1 and the registers left after
   ``close()`` bit-identical, window by window; (b)
   ``SlidingTDigestEngine`` (10 s windows, 1 s slide, a 2048-slot ring)
   with the sliced fold, K1 counting into the ``[1000, 2048]`` class
   plane, its host clock held 1 s past the journal's last view so that
   real latencies reach the digest: every window equal to the golden
   (each view in the 10 windows covering it), none dropped, K1 launched,
   the latency quantiles positive and ordered, the digest's weight the
   views folded, 300 ``_quantiles`` fields, and against the same engine
   on the CPU under the same clock, the digest's weight per campaign
   equal and the quantiles within one histogram bin (2^-5); (c) the
   same with ``jax.sliding.sliced: off``, its windows equal to (b)'s,
   its quantiles held as (b)'s; (d) per family, an engine that
   snapshots after every flush is abandoned at 500,000 events and a
   fresh one resumes on the same store, its windows equal to (a)'s and
   (b)'s.  Each run's ev/s (and with ``close()``), its spans, the host
   ms of the fold per batch, K1's launches.  Phase 3 holds K1 on the
   sliced plane (a half batch with a quarter of its rows masked and
   negative, and a full batch).

16. BASELINE config #4, session windows + count-min heavy hitters, as
   the reference benchmark deploys it (``bench.py:1199-1214``) at its
   paced 100,000 ev/s: a 5 s gap, 400,000 users (max(50,000, 4 x rate)),
   a 2^20-user session state (12 MB on the card), CMS D = 4, Wd = 2048,
   top 16 from a 128-slot ring.  Its journal is 3,000,000 events of the
   stock topology, 100 to a millisecond (30 s of the stream), written
   with the generator's ``EventSource`` over ``make_ids(400,000)``, then
   a tail of 20,000 events of 2,000 new users from gap + lateness + 1 s
   past the body, whose watermark expires every session of the body; the
   engines' host clock is held 1 s past its last event.  (a)
   ``SessionCMSEngine(device="cuda")`` with the fixed sketch under
   ``StreamRunner.run_catchup``, draining only where the catchup ends:
   that drain closes each body user's last session by time expiry, each
   in the latency bin the journal gives; every click of a user within
   capacity in a closed session (after ``close()``), ``dropped`` = the
   journal's overflow, each reported heavy hitter's estimate at least its
   exact clicks, ``<hashtable>_hh`` holding the report, K3's fused
   update and query (``cms_update_query``) and its query launched, K1
   not; and against the same engine on the CPU over
   the same journal, drained at the same point, the session arrays,
   sketch, ring, counters and latency histogram bit-identical and the
   heavy hitters equal.  (b) ``jax.cms.mode: salsa``, held as (a), and
   its plane widened somewhere (``salsa.stats`` merged pairs).  (c)
   ``jax.cms.stages: 2`` on the first 1,000,000 events: every user's
   small-stage estimate at least its exact clicks, the fused two-stage
   entry (``cms2_update_query``) launched, and held against the CPU as
   (a).  (d) An engine that
   drains each second of wall clock and snapshots after every drain is
   abandoned half way; a fresh one resumes, its drains expire what (a)'s
   did, and its state equals (a)'s.  Each run's
   ev/s (with ``close()`` and without), spans, host ms of the fold a
   batch and K3's launches per entry point; one run under
   ``torch.profiler`` gives the device operations one eager batch
   launches (X5).

17. BASELINE #5 in the reference's shape: ``parallel.ShardedWindowEngine``
   on a ``(1, 1)`` mesh of one rank (a world-size-1 NCCL group: every
   gather and sum of the fold still runs through NCCL) over phase 6's
   journal, with phase 6's configuration, twice: plain, and with the
   per-shard skew tracker attached (``jax.obs.shard``).  Each run must
   fold all 1,000,000 events, drop none, take ``rows_compact`` drains
   and launch K1; the plain run must leave every window equal to phase
   6's oracle-checked store, and the tracker's routed rows must be the
   views phase 6 counted.  Its ev/s
   (and with ``close()``) beside phase 6's, and the collectives one
   dispatch issues, by kind and bytes, from the engine's own counter
   (``collective_report``), each bracketed by CUDA events, and the NCCL
   kernels' device time and the c10d calls' host time a dispatch under
   ``torch.profiler``.

Each kernel's launches are counted over each of phases 4, 6-17, from 0
just before the phase's run to just after it (phases 9-11 and 13 run the
engine in its own process, which reports them in its stats line).  The
line before the nvidia-smi line is ``{"kernels": [...]}``; the last line
is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--events N] [--out FILE]
    python3 chip_smoke.py --only-sketches  # phases 1-3 and 15 alone
    python3 chip_smoke.py --only-session   # phases 1-3 and 16 alone
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import random
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
import uuid
import weakref

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PROFILE_EVENTS = 1_000_000         # events replayed under torch.profiler
SYNC_CHECKED_DRAINS = 8            # config #5 drains under sync-debug
LARGE_EVENTS = 1_000_000           # config #5's dataset, bench.py:1227-1230
# bench.py's config #5 row (1238-1247): 1e6 campaigns x 1 ad, W = 64, no
# scan groups, the stock 8192-event batch
CONFIG5 = {"jax.window.slots": 64, "jax.scan.batches": 1,
           "jax.batch.size": 8192, "jax.num.campaigns": 1_000_000,
           "jax.ads.per.campaign": 1}
# phases 9, 10 and 13: (rate ev/s, seconds) of the paced load
PACED_LOAD = (100_000, 30)
KAFKA_LOAD = (10_000, 15)
PACED_DECODE_LOAD = (100_000, 15)
# phase 11: the paced load and the harness's obs knobs
OBS_LOAD = (100_000, 15)
OBS_ENV = {"METRICS_INTERVAL_MS": "1000", "OBS_LIFECYCLE": "1",
           "FLIGHTREC": "1", "OBS_SPANS": "1", "OBS_OCCUPANCY": "1",
           "OBS_XFER": "1", "OBS_DEVMEM": "1", "OBS_CAPTURE": "1",
           "SLO_P99_MS": "15000"}
# spans the phase 11 trace must hold; the fold's dispatch shows as
# device_step (one batch) or device_scan (a group), whichever the
# paced batching produced
OBS_TRACE_SPANS = ("encode", "drain", "redis_flush", "ingest_read",
             "ingest_encode")
OBS_DISPATCH_SPANS = ("device_step", "device_scan")
FLUSH_MS = 1000                    # jax.flush.interval.ms, the default the harness keeps
# K2's cases: (label, groups, rows per group, kind); "generator" = the
# generator's rows at config #1, 10 ms apart; "halfbatch" = 4096 of them
# padded with 4096 pad rows to one group, as the stock catchup's span
# guard dispatches them; "adversarial" = a quarter pad rows, one ad in
# seven unknown, every event type, times within 5 s of a 10^9 boundary;
# "deep" = only ads that sit 3 or more probes deep in the join table;
# "paced" = PACED_BLOCK_ROWS generator rows in two 8192-row groups with
# the pad tail a paced block's dispatch carries (phase 13's shape);
# "collision" = the table holds COLLIDING_ADS, and rows of both and of
# COLLIDING_UNKNOWN; "edgesK" = rows at every start mod 16, rows crossing
# either end of the buffer, rows of random bytes (one with an all-zero ad
# span) and pad rows, through a buffer view K bytes into its storage;
# "bigtable" = generator rows over 100,000 ads (T = 262,144: the global
# tier); "tiled" = one 8192-row block of generator rows tiled `groups`
# times, each copy's starts offset by the block's length
PACED_BLOCK_ROWS = 10_700
DECODE_CASES = (
    ("a scan group of generator rows, [8, 4096]", 8, 4096, "generator"),
    ("main path: the stock catchup's dispatch, 4096 rows of a half batch "
     "in one 8192-row group", 1, 8192, "halfbatch"),
    ("pad rows, unknown ads, every event type, times across a 10^9 "
     "boundary", 2, 4096, "adversarial"),
    ("ads 3 or more probes deep in the join table", 1, 4096, "deep"),
    ("paced path: a paced block's dispatch, %d rows in two 8192-row "
     "groups" % PACED_BLOCK_ROWS, 2, 8192, "paced"),
    ("two table ads and an unknown ad with one FNV-1a hash", 1, 4096,
     "collision"),
    ("every start mod 16, both buffer ends, random bytes; 16-byte-aligned "
     "buffer", 1, 4096, "edges0"),
    ("the same through a view 1 byte into its storage (byte path)", 1, 4096,
     "edges1"),
    ("the same through a view 3 bytes into its storage (byte path)", 1,
     4096, "edges3"),
    ("100,000 ads in 262,144 slots (global tier)", 1, 8192, "bigtable"),
    ("a full journal block of generator rows, [8, 8192]", 8, 8192,
     "generator"),
    ("bandwidth (not a main-path shape): [64, 8192], one block tiled", 64,
     8192, "tiled"),
)
# Two uuid4 strings with one FNV-1a 32-bit hash (0x20fe7885), found among
# the 2^17 of make_ids(1 << 17, random.Random(1)) by sorting their hashes,
# and a third with the same hash that no table holds (a seeded uuid4 whose
# last ten hex digits were solved for it, meeting in the middle)
COLLIDING_ADS = ("3fdb86b0-7a3f-49f5-bd16-bf8507541a9c",
                 "96559ca1-dba2-4688-b602-c94a1502eb22")
COLLIDING_UNKNOWN = "940eee3c-ba6f-475c-ae84-49715a2a4143"
# phase 14: runs (a)-(c) at phase 7's and phase 6's size, run (d) over
# the in-process fake Kafka; the sink retry of the reference's chaos
# tests, so a faulted write is retried within milliseconds
CHAOS_EVENTS = 1_000_000
CHAOS_KAFKA_EVENTS = 200_000
CHAOS_KAFKA_TAIL = 1_024            # produced through the armed cluster
CHAOS_RUNS = ("xo", "decode", "config5", "kafka")
CHAOS_SINK_RETRY = {"jax.sink.retry.base.ms": 1, "jax.sink.retry.cap.ms": 4}
# runs (a) and (b) flush every 100 ms: a card attempt takes about a second,
# so at the 1 Hz default the plan's 60 faulted sink ops (its 6-op outage
# included) would all fall inside close()'s 8 bounded retries instead of
# mid-run, where the reference's slower CPU runs meet them
CHAOS_FLUSH = {"jax.flush.interval.ms": 100}
# the acceptance crash script of tests/test_chaos_recovery.py:70-80
CHAOS_SCRIPT = (("batch", 5), ("flush", 1), ("batch", 2), ("checkpoint", 1))
# config #5's script: a crash before any snapshot, one right after a
# snapshot, one after the resume (8192-event batches, ~40 a second)
CHAOS_CONFIG5_SCRIPT = (("batch", 30), ("checkpoint", 1), ("batch", 40))
CHAOS_KAFKA_SCRIPT = (("batch", 3), ("flush", 1), ("batch", 2))
# run (d) reads three partitions round-robin, a third of a dispatch from
# each in turn: at the stock 65,536-event dispatch one slice spans ~655 s
# of event time and the lagging partitions fall past the 60 s lateness
# (dropped), so (d) dispatches 3 x 1,024 events (a slice spans ~31 s).  A
# dispatch that is a multiple of the partition count also keeps every
# slice whole: a 1-record remainder slice makes a reconnect's rewind
# redeliver one record per fetch, which a 12 % drop rate never finishes
CHAOS_KAFKA_BATCH = {"jax.batch.size": 1024, "jax.scan.batches": 3}
# the method table's geometries: (C, W, B)
METHOD_GEOMETRIES = ((100, 16, 4096), (100, 16, 8192),
                     (1_000_000, 64, 8192))
REPO = os.path.dirname(os.path.abspath(__file__))
CASES = (
    # (label, B, C, W, inputs): "zipf" = Zipf(1.2) campaigns, uniform
    # slots, ~30 % masked; "hot" = every unmasked row on one cell;
    # "offsetK" = zipf inputs read through views K rows into their buffers;
    # "config5" = config #5's generator rows: campaigns uniform (one ad
    # each), event times 10 ms apart (the ring slots of ~9 consecutive
    # 10 s windows), a third of them views
    ("main path: one step of the stock catchup (8192-row batch halved by "
     "the span guard)", 4096, 100, 16, "zipf"),
    ("one full micro-batch", 8192, 100, 16, "zipf"),
    ("one full scan group", 65536, 100, 16, "zipf"),
    ("ragged, non-power-of-two", 300, 7, 5, "zipf"),
    ("BASELINE #5 key space (global-memory path)", 8192, 1_000_000, 16,
     "zipf"),
    ("config #5 step: one 8192-event batch of the large-key-space catchup",
     8192, 1_000_000, 64, "config5"),
    # the sharded fold's per-shard plane (M16): shard 0 of config #5's key
    # space over a four-shard campaign axis, [250000, 64]
    ("per-shard plane of a four-shard config #5 layout [250000, 64]: "
     "three quarters of the rows out of shard", 8192, 250_000, 64,
     "shard4"),
    ("hot cell: every unmasked row on one cell", 4096, 100, 16, "hot"),
    ("misaligned views, 1 row in", 4096, 100, 16, "offset1"),
    ("misaligned views, 3 rows in", 4096, 100, 16, "offset3"),
    ("bandwidth (not a main-path shape): 16.7M rows, 151 MB of input",
     16_777_216, 100, 16, "zipf"),
    # the sliced sliding fold's plane (BASELINE #3: C = 100, S = 10,
    # W = 2048): rows campaign * S + lateness class
    ("sliced sliding plane [C*S, W] = [1000, 2048], half batch: a "
     "quarter of the rows masked, with negative rows", 4096, 1000, 2048,
     "sliced_masked"),
    ("sliced sliding plane [1000, 2048], one full micro-batch", 8192,
     1000, 2048, "sliced"),
)
# the phase 15 dataset: the stock topology (conf/benchmarkConf.yaml),
# 1,000,000 events 10 ms apart, its own seed (run (d) crashes half way)
SKETCH_EVENTS = 1_000_000
SKETCH_SEED = 61
SLIDE_CLASSES = 10                 # S = 10 s / 1 s
# K3's cases: (label, rows, D, Wd, Ws of the two-stage refresh or None,
# keys); "zipf" = measure_cms's Zipf(1.1) keys capped at 2^28, "edge" =
# the same with a third of the keys -1 and a third past 2^28 (up to the
# int32 end), "distinct" = distinct keys below 400,000 (phase 16's
# interned users); weights 1-7 and a third of the rows masked in every
# case
CMS_CASES = (
    ("main path: the session engine's step, D = 4, Wd = 2048, 8192 rows",
     8192, 4, 2048, None, "zipf"),
    ("keys -1 and past 2^28", 8192, 4, 2048, None, "edge"),
    ("the two-stage refresh, Ws = 256", 8192, 4, 2048, 256, "zipf"),
    ("the engine's closed sessions: near-distinct users, the two-stage "
     "pair at Ws = 256", 8192, 4, 2048, 256, "distinct"),
    ("the wide update from 65,536 rows (4 rows a thread, the hot-key "
     "table) on the engine's planes", 1 << 16, 4, 2048, 256, "zipf"),
    ("bandwidth (not a main-path shape): 2^22 rows, D = 8, Wd = 2^20",
     1 << 22, 8, 1 << 20, None, "zipf"),
)
CMS_METHOD_WIDTH = 2048            # the CMS method table's plane
# phase 16: BASELINE #4 as bench.py:1199-1214 deploys it at its paced
# rate of 100,000 ev/s: a 5 s gap, max(50,000, 4 x rate) users, the
# session state sized 1 << max(16, bit_length(2 * users - 1)); the
# journal holds 30 s of the stream, 100 events a millisecond, then a tail
# of SESSION_TAIL_EVENTS events of SESSION_TAIL_USERS users not seen
# before, starting gap + lateness + 1 s past the body, so that every
# session of the body expires by the watermark inside the run
SESSION_EVENTS = 3_000_000
SESSION_TAIL_EVENTS = 20_000
SESSION_TAIL_USERS = 2_000
SESSION_RATE = 100_000
SESSION_USERS = max(50_000, 4 * SESSION_RATE)
SESSION_GAP_MS = 5_000
SESSION_SEED = 16
SESSION_TWO_STAGE_EVENTS = 1_000_000
SESSION_PROFILE_EVENTS = 200_000
SESSION_RUNS = ("fixed", "salsa", "two_stage", "resume")

def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    import torch

    print(f"[device] nvidia-smi: {smi}", flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    return smi


def phase_build() -> list[str]:
    from streambench_tpu_torch import native
    from streambench_tpu_torch.ops import _build

    results: dict = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            results[name] = (time.perf_counter() - t0, None)
        except BaseException as e:      # reported and re-raised below
            results[name] = (time.perf_counter() - t0, e)

    threads = [threading.Thread(target=run, args=(n, f)) for n, f in
               (("count kernel K1 (nvcc)", _build.count_cells_lib),
                ("decode kernel K2 (nvcc)", _build.decode_rows_lib),
                ("count-min kernel K3 (nvcc)", _build.cms_rows_lib),
                ("native host library (g++)", native.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (secs, err) in results.items():
        print(f"[build] {name}: {secs:.2f} s", flush=True)
        if err is not None:
            raise err
    from streambench_tpu_torch.utils.build import BUILD_DIR

    ptxas = []
    for log in sorted(os.listdir(BUILD_DIR)):
        if (log.startswith(("libcount_cells", "libdecode_rows",
                            "libcms_rows"))
                and log.endswith(".log")):
            with open(os.path.join(BUILD_DIR, log)) as f:
                ptxas += [line.strip() for line in f.read().splitlines()
                          if "spill" in line or "ptxas" in line and (
                              "entry function" in line or "Used" in line)]
    for line in ptxas:
        print(f"[build] {line}", flush=True)
    return ptxas


def _device_ms(fn, reps: int = 100) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed between CUDA events (no host launch cost inside)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                # warm-up outside the graph
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def _call_ms(fn, reps: int = 200) -> float:
    """Time per eager call (host launch included), between CUDA events."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _inputs(rng, B: int, C: int, W: int, kind: str):
    """numpy (campaign, slot, mask) of ``kind`` (see CASES) and the offset
    of the views the kernel reads them through."""
    import numpy as np

    offset = int(kind[6:]) if kind.startswith("offset") else 0
    n = B + offset
    if kind == "hot":
        camp = np.full(n, C // 2, np.int32)
        slot = np.full(n, W - 1, np.int32)
    elif kind in ("config5", "shard4"):
        # "shard4": campaigns over the whole key space of four shards, as
        # the sharded fold passes them (``campaign - c0``, here c0 = 0),
        # masked to the rows of this shard as its ``in_shard`` does
        shards = 4 if kind == "shard4" else 1
        camp = rng.integers(0, shards * C, n, dtype=np.int32)
        t0 = int(rng.integers(0, 10_000_000))
        slot = ((t0 + 10 * np.arange(n)) // 10_000 % W).astype(np.int32)
        return camp, slot, (rng.random(n) < 1 / 3) & (camp < C), offset
    elif kind.startswith("sliced"):
        # generator rows 10 ms apart: 1 s buckets on the 2048-slot ring,
        # lateness class S - 1 but for a tenth of the rows; a third are
        # views.  "sliced_masked": a quarter of the rows are not counted
        # and carry campaign -1, so a negative row, as the fold makes it
        S = SLIDE_CLASSES
        camp = rng.integers(0, C // S, n).astype(np.int32)
        d = np.where(rng.random(n) < 0.9, S - 1,
                     rng.integers(0, S, n)).astype(np.int32)
        t0 = int(rng.integers(0, 10_000_000))
        slot = ((t0 + 10 * np.arange(n)) // 1_000 % W).astype(np.int32)
        if kind == "sliced_masked":
            mask = rng.random(n) >= 0.25
            camp = np.where(mask, camp, -1).astype(np.int32)
        else:
            mask = rng.random(n) < 1 / 3
        return (camp * S + d).astype(np.int32), slot, mask, offset
    else:
        camp = ((rng.zipf(1.2, n) - 1) % C).astype(np.int32)
        slot = rng.integers(0, W, n, dtype=np.int32)
    mask = rng.random(n) >= 0.3
    return camp, slot, mask, offset


def empty_launch() -> None:
    """One empty kernel on the current stream (the launch floor)."""
    import torch

    from streambench_tpu_torch.ops import _build

    _build.launch("empty", _build.count_cells_lib().sb_empty_launch,
                  torch.cuda.current_device())


def _call_ms_in_turns(fns: dict, rounds: int = 5, reps: int = 200) -> dict:
    """Median ``_call_ms`` of each of ``fns`` over ``rounds`` rounds run in
    turns, so host noise falls on all of them alike."""
    import statistics

    times: dict = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(_call_ms(fn, reps))
    return {name: statistics.median(t) for name, t in times.items()}


def _repeat_rounds(cells, head: int) -> tuple[int, int]:
    """Of a launch's rounds of atomics (the 32 threads of a warp, one row
    of each thread's run of 4 vector-loaded rows), how many add twice to
    one cell, and how many add at all; ``cells`` holds each row's cell,
    or -1 where the row does not count."""
    import numpy as np

    body = cells[head:]
    body = body[:body.size // 128 * 128]
    rounds = np.sort(body.reshape(-1, 32, 4).transpose(0, 2, 1)
                     .reshape(-1, 32), axis=1)
    repeat = (rounds[:, 1:] == rounds[:, :-1]) & (rounds[:, 1:] >= 0)
    return int(repeat.any(axis=1).sum()), int((rounds[:, -1] >= 0).sum())


def _kernel_case(label: str, C: int, W: int, kind: str, steps: list,
                 base_np, floor: dict) -> dict:
    """K1 against its plain version and a numpy count, exactly, over
    ``steps``: ``(campaign, slot, mask)`` on the card, launched one after
    another into one ``[C, W]`` plane that starts at ``base_np``.  Times
    and the byte bound are per launch."""
    import numpy as np
    import torch

    from streambench_tpu_torch.ops.count import (count_cells,
                                                 count_cells_plain,
                                                 device_limits, launch_plan)

    camp, slot, mask = steps[0]
    plan = launch_plan(camp.shape[0], C, W, (camp.data_ptr() % 16,
                                             slot.data_ptr() % 16,
                                             mask.data_ptr() % 16),
                       *device_limits(camp.get_device()))
    base = torch.from_numpy(base_np).to(camp.device)
    got, want = base.clone(), base.clone()
    for step in steps:
        count_cells(got, *step)
        count_cells_plain(want, *step)
    torch.cuda.synchronize()
    host = base_np.reshape(-1).astype(np.int64)
    rows = nbytes = touched = masked = repeat = rounds = 0
    for c, s, m in steps:
        c, s, m = c.cpu().numpy(), s.cpu().numpy(), m.cpu().numpy()
        cells = np.where(m, c.astype(np.int64) * W + s, -1)
        host += np.bincount(cells[m], minlength=C * W)
        n_touched = int(np.unique(cells[m]).size)
        n_masked = int((~m).sum())
        # bytes the function must move for THIS data: each row's mask
        # (1 B), the campaign and slot of each unmasked row (4 + 4 B; a
        # masked row needs neither), each counts cell it touches read and
        # written (4 + 4 B)
        rows += c.size
        nbytes += c.size + (c.size - n_masked) * 8 + n_touched * 8
        touched += n_touched
        masked += n_masked
        r, n = _repeat_rounds(cells, plan.head)
        repeat += r
        rounds += n
    diff = max(int((got.long() - want.long()).abs().max().item()),
               int(np.abs(got.cpu().numpy().reshape(-1) - host).max()))

    launches = len(steps)
    scratch = base.clone()
    flats = [(torch.where(m, c.long() * W + s.long(), C * W),
              torch.ones(c.shape[0], dtype=torch.int32, device=c.device))
             for c, s, m in steps]
    padded = torch.zeros(C * W + 1, dtype=torch.int32, device=camp.device)

    def kernel():
        for step in steps:
            count_cells(scratch, *step)

    def plain():
        for step in steps:
            count_cells_plain(scratch, *step)

    def library():
        for flat, ones in flats:
            padded.index_add_(0, flat, ones)

    reps = max(1, 100 // launches)
    kernel_ms = _device_ms(kernel, reps) / launches
    plain_ms = _device_ms(plain, reps) / launches
    library_ms = _device_ms(library, reps) / launches
    calls = _call_ms_in_turns({"kernel": kernel, "library": library},
                              reps=max(1, 200 // launches))
    bound_ms = nbytes / launches / HBM_BYTES_PER_S * 1e3
    case = {
        "case": label, "shape": {"B": camp.shape[0], "C": C, "W": W},
        "inputs": kind, "launches_held": launches, "rows": rows,
        "plan": plan._asdict(), "masked_rows": masked,
        "touched_cells": touched, "rounds_with_repeat": repeat,
        "rounds_adding": rounds,
        "repeat_share": repeat / rounds if rounds else 0.0,
        "max_abs_diff": diff,
        "kernel_ms": kernel_ms, "kernel_call_ms": calls["kernel"] / launches,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call_ms": calls["library"] / launches,
        "bound_ms": bound_ms, "bound_bytes": nbytes / launches,
        "bound_share": bound_ms / kernel_ms, **floor,
    }
    print(f"[kernels] {json.dumps(case)}", flush=True)
    if diff:
        raise AssertionError(f"count_cells disagrees with its plain version "
                             f"at {label!r}: max |diff| {diff}")
    return case


def phase_kernels() -> tuple[list[dict], dict]:
    """K1's cases."""
    import numpy as np
    import torch

    floor = {"launch_floor_ms": _device_ms(empty_launch),
             "launch_floor_call_ms": _call_ms_in_turns(
                 {"floor": empty_launch})["floor"]}
    print(f"[kernels] {json.dumps(floor)}", flush=True)
    rng = np.random.default_rng(1234)
    out = []
    for label, B, C, W, kind in CASES:
        camp_np, slot_np, mask_np, off = _inputs(rng, B, C, W, kind)
        base_np = rng.integers(0, 50, (C, W), dtype=np.int32)
        step = tuple(torch.from_numpy(a).cuda()[off:]
                     for a in (camp_np, slot_np, mask_np))
        out.append(_kernel_case(label, C, W, kind, [step], base_np, floor))
    return out, floor


def _event_line(rng, users, t: int, event_type: str, ad: str) -> str:
    """One event in the generator's wire format (``gen.EventSource``)."""
    return ('{"user_id": "%s", "page_id": "%s", "ad_id": "%s", '
            '"ad_type": "%s", "event_type": "%s", "event_time": "%d", '
            '"ip_address": "1.2.3.4"}'
            % (rng.choice(users), rng.choice(users), ad,
               rng.choice(("banner", "modal", "sponsored-search", "mail",
                           "mobile")), event_type, t))


def _decode_inputs(seed: int, groups: int, B: int, kind: str) -> dict:
    """numpy inputs of one K2 case (see DECODE_CASES): the byte buffer
    (``storage[offset:]``), ``[groups, B]`` starts and lens, the join
    table (config #1's 100 campaigns x 10 ads; 100,000 ads for
    "bigtable"; with COLLIDING_ADS for "collision") with its used mask,
    and the base time, as ``DeviceDecoder`` makes them; every generated
    row passes the host probe."""
    import numpy as np

    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.encode.encoder import EventEncoder
    from streambench_tpu_torch.ops import devdecode
    from streambench_tpu_torch.utils.ids import make_ids

    rng = random.Random(seed)
    n_ads = 100_000 if kind == "bigtable" else 1000
    campaigns = make_ids(100, rng)
    ads = make_ids(n_ads, rng)
    users = make_ids(100, rng)
    table_ads = ads + list(COLLIDING_ADS) if kind == "collision" else ads
    mapping = {ad: campaigns[i * 100 // n_ads % 100]
               for i, ad in enumerate(table_ads)}
    enc = EventEncoder(mapping)
    keys, vals, probes, used = devdecode.build_ad_table(
        [a.encode() for a in enc.ads], enc.join_table[:-1], with_used=True)
    rows = groups * B
    edges = kind.startswith("edges")
    real = {"halfbatch": rows // 2, "adversarial": rows - rows // 4,
            "paced": PACED_BLOCK_ROWS, "tiled": B}.get(kind, rows)
    if edges:
        real = rows - EDGE_ROWS
    t0 = 1_700_000_000_000
    if edges or kind in ("generator", "halfbatch", "paced", "bigtable",
                         "tiled"):
        src = gen.EventSource(ads=ads, user_ids=users, page_ids=users,
                              rng=rng)
        lines = [src.event_at(t0 + 10 * i) for i in range(real)]
    else:
        pool = ads
        if kind == "deep":
            # each ad's depth: the probes its own lookup takes
            T = vals.shape[0]
            depth = {}
            for a in ads:
                h = devdecode.fnv1a32(a.encode())
                p = 0
                while bytes(keys[(h + p) & (T - 1)]) != a.encode():
                    p += 1
                depth[a] = p + 1
            pool = [a for a in ads if depth[a] >= 3]
            if probes < 3 or not pool:
                raise AssertionError(f"no ad 3 probes deep (bound "
                                     f"{probes})")
        boundary = 1_723_000_000_000          # a multiple of 10^9
        lines = []
        for i in range(real):
            if kind == "collision" and i % 4 < 3:
                ad = (*COLLIDING_ADS, COLLIDING_UNKNOWN)[i % 4]
            elif kind == "adversarial" and i % 7 == 0:
                ad = str(uuid.UUID(int=rng.getrandbits(128), version=4))
            else:
                ad = rng.choice(pool)
            lines.append(_event_line(
                rng, users, boundary + rng.randint(-5_000, 5_000),
                ("view", "click", "purchase")[i % 3], ad))
    data = ("\n".join(lines) + "\n").encode()
    starts, lens, times, ok = devdecode.probe_block(data)
    if not ok.all() or starts.size != real:
        raise AssertionError(f"{kind}: the probe accepted {int(ok.sum())} "
                             f"of {real} rows")
    base = int(times[0]) - int(times[0]) % 10_000 - 60_000
    buf = np.frombuffer(data, np.uint8).copy()
    s = np.zeros(rows, np.int32)
    l = np.zeros(rows, np.int32)
    if kind == "adversarial":
        # pad rows spread among the real ones
        at = np.sort(np.random.default_rng(seed).choice(rows, real,
                                                        replace=False))
    elif kind == "tiled":
        buf = np.tile(buf, groups)
        starts = (starts[None, :] + len(data) * np.arange(
            groups, dtype=np.int64)[:, None]).reshape(-1)
        lens = np.tile(lens, groups)
        at = np.arange(rows)
    else:
        at = np.arange(real)
    s[at], l[at] = starts, lens
    offset = 0
    storage = buf
    if edges:
        if np.unique(starts % 16).size != 16:
            raise AssertionError("the generator rows miss a start mod 16")
        buf, es, el = _edge_rows(buf, seed)
        s[real:], l[real:] = es, el
        offset = int(kind[5:])
        storage = np.concatenate([np.full(offset, 0xEE, np.uint8), buf])
    return {"buf": buf, "storage": storage, "offset": offset,
            "starts": s.reshape(groups, B), "lens": l.reshape(groups, B),
            "keys": keys, "vals": vals, "used": used, "probes": probes,
            "base": base}


EDGE_ROWS = 96      # the edge rows and pad rows that end an "edgesK" case


def _edge_rows(buf, seed: int):
    """``buf`` grown by 4,096 random bytes, 400 zero bytes and random bytes
    up to a length of 7 mod 16, and ``EDGE_ROWS`` (start, len) rows after
    the generator's: spans crossing the buffer's start (negative starts,
    one below -cap) and its end (starts within 150 B of cap, and past it),
    rows in the random bytes, one whose ad span is all zero, then pad
    rows."""
    import numpy as np

    nrng = np.random.default_rng(seed)
    n0 = buf.size
    zs = n0 + 4096                          # the zero bytes' start
    pad = 100 + (7 - (zs + 400 + 100)) % 16
    buf = np.concatenate([buf, nrng.integers(0, 256, 4096, dtype=np.uint8),
                          np.zeros(400, np.uint8),
                          nrng.integers(0, 256, pad, dtype=np.uint8)])
    cap = buf.size
    rows = [(-1, 250), (-36, 260), (-113, 255), (-130, 270), (-149, 250),
            (-200, 300), (-cap + 5, 250), (-cap - 20, 260)]
    rows += [(cap - d, 250 + d % 7) for d in (150, 149, 148, 140, 120, 100,
                                              62, 40, 27, 16, 1, 0, -5)]
    rows += [(zs - 100, 300)]               # the ad span all zero
    rows += [(int(a), int(b)) for a, b in zip(
        nrng.integers(n0, n0 + 4096 - 400, 40),
        nrng.integers(245, 400, 40))]
    rows += [(0, 0)] * (EDGE_ROWS - len(rows))
    st, ln = zip(*rows)
    return buf, np.asarray(st, np.int32), np.asarray(ln, np.int32)


def _vector_rows(case: dict, aligned: bool) -> int:
    """The rows K2 should read with 16-byte loads, predicted from the
    kernel's condition (``csrc/decode_rows.cu``; the kernel counts
    nothing): real rows whose ad and tail spans lie in ``[0, cap & ~15)``
    of a 16-byte aligned buffer; every other row reads its bytes one at a
    time."""
    import numpy as np

    s = case["starts"].reshape(-1).astype(np.int64)
    e = s + case["lens"].reshape(-1)
    cap16 = case["buf"].size & ~15
    ok = ((case["lens"].reshape(-1) > 0) & (s + 113 >= 0)
          & (s + 149 <= cap16) & (e - 62 >= 0) & (e - 27 <= cap16))
    return int(ok.sum()) if aligned else 0


def _decode_bytes(case: dict) -> tuple[int, dict]:
    """The bytes K2 must move from and to memory for THIS case's rows,
    each input read once: the join table's slots that the rows' lookups
    reach (36 B of key and 4 B of value a slot, each distinct slot once; a
    lookup walks its chain to the matching slot or the first unused one,
    at most ``probes`` slots), a pad row's length (4 B: its start is never
    read), a real row's start and length (8 B), 36 ad bytes, 4 event-type
    bytes and 13 digits, and every row's four outputs (10 B).  The slots
    the lookups inspect, counted with repeats (``probes_taken``, 36 B of
    key each in ``l2_key_bytes``: the most key bytes the lookups compare,
    served from L2), are reported apart.  Returns the bytes and what was
    counted."""
    import numpy as np

    s, l = case["starts"].reshape(-1), case["lens"].reshape(-1)
    real = l > 0
    buf, keys, used = case["buf"], case["keys"], case["used"]
    at = s[real][:, None].astype(np.int64) + 113 + np.arange(36)[None, :]
    at = np.clip(np.where(at < 0, at + buf.size, at), 0, buf.size - 1)
    ad = buf[at].astype(np.uint64)           # JAX's gather rule
    h = np.full(ad.shape[0], 2166136261, np.uint64)
    for i in range(36):
        h = ((h ^ ad[:, i]) * np.uint64(16777619)) & np.uint64(0xFFFFFFFF)
    T = keys.shape[0]
    found = np.zeros(ad.shape[0], bool)
    done = np.zeros(ad.shape[0], bool)
    taken = np.zeros(ad.shape[0], np.int64)
    reached = np.zeros(T, bool)
    for p in range(case["probes"]):
        slot = ((h + np.uint64(p)) & np.uint64(T - 1)).astype(np.int64)
        live = ~done
        taken += live
        reached[slot[live]] = True
        hit = live & used[slot] & (keys[slot] == ad).all(axis=1)
        found |= hit
        done |= hit | ~used[slot]
    n = int(real.sum())
    slots = int(reached.sum())
    nbytes = (slots * (36 + 4) + (s.size - n) * 4 + n * (8 + 36 + 4 + 13)
              + s.size * 10)
    return nbytes, {"real_rows": n, "pad_rows": int(s.size - n),
                    "table_slots_reached": slots,
                    "table_bytes": slots * (36 + 4),
                    "l2_key_bytes": int(taken.sum()) * 36,
                    "probes_bound": case["probes"],
                    "probes_taken": int(taken.sum()),
                    "max_probes_taken": int(taken.max()) if n else 0,
                    "unknown_ads": int(n - found.sum())}


def _decode_sectors(case: dict, nbytes: int) -> int:
    """``nbytes``, the bound's bytes, with each real row's three spans (36
    ad bytes, the event type's last 4, the 13 digits) counted instead as
    the 32-byte sectors of ``buf`` they touch under the gather rule, each
    distinct sector once: what the card fetches, at its sector
    granularity, to read those bytes."""
    import numpy as np

    s = case["starts"].reshape(-1).astype(np.int64)
    l = case["lens"].reshape(-1)
    real = l > 0
    s, e = s[real], s[real] + l[real]
    cap = case["buf"].size
    at = np.concatenate([s[:, None] + 113 + np.arange(36)[None, :],
                         e[:, None] - 62 + np.arange(4)[None, :],
                         e[:, None] - 40 + np.arange(13)[None, :]], axis=1)
    at = np.clip(np.where(at < 0, at + cap, at), 0, cap - 1)
    sectors = np.unique((at // 32).astype(np.int32))
    return nbytes - at.size + 32 * sectors.size


def _decode_case(label: str, groups: int, B: int, kind: str, seed: int,
                 floor: dict) -> dict:
    """K2 against its plain version on the card, every output in full
    (the two agree on pad rows too), the plan it took, and its times
    beside the bound."""
    import numpy as np
    import torch

    from streambench_tpu_torch.ops.count import device_limits
    from streambench_tpu_torch.ops.decode import (decode_plan, decode_rows,
                                                  decode_rows_plain,
                                                  slot_meta)

    case = _decode_inputs(seed, groups, B, kind)
    base = case["base"]
    buf = torch.from_numpy(case["storage"]).cuda()[case["offset"]:]
    args = (buf, *(torch.from_numpy(case[k]).cuda()
                   for k in ("starts", "lens", "keys", "vals")),
            case["probes"], base // 1_000_000_000, base % 1_000_000_000)
    meta = torch.from_numpy(slot_meta(case["keys"], case["vals"],
                                      case["used"]).view(np.int32)).cuda()
    sms, _ = device_limits(buf.get_device())
    plan = decode_plan(case["keys"].shape[0], buf.shape[0],
                       buf.data_ptr() % 16, groups * B, sms=sms)
    got = decode_rows(*args, meta=meta)
    want = decode_rows_plain(*args)
    torch.cuda.synchronize()
    diff = 0
    for name, a, b in zip(("campaign", "is_view", "rel", "valid"), got,
                          want):
        if a.shape != (groups, B) or a.dtype != b.dtype:
            raise AssertionError(f"decode_rows {name}: {a.dtype} "
                                 f"{tuple(a.shape)} at {label!r}")
        diff = max(diff, int((a.long() - b.long()).abs().max().item()))
    valid = got[3].cpu().numpy()
    if not np.array_equal(valid, case["lens"] > 0):
        raise AssertionError(f"decode_rows valid rows wrong at {label!r}")
    nbytes, counted = _decode_bytes(case)
    sector_bytes = _decode_sectors(case, nbytes)
    kernel_ms = _device_ms(lambda: decode_rows(*args, meta=meta))
    plain_ms = _device_ms(lambda: decode_rows_plain(*args),
                          reps=max(1, min(20, 20 * 16384 // (groups * B))))
    call_ms = _call_ms_in_turns(
        {"kernel": lambda: decode_rows(*args, meta=meta)})
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {
        "case": label, "shape": {"groups": groups, "B": B}, "inputs": kind,
        "plan": plan._asdict(), "table_slots": int(case["keys"].shape[0]),
        "buf_offset": case["offset"],
        "predicted_vector_rows": _vector_rows(case, plan.vector),
        **counted, "views": int(got[1].sum().item()),
        "max_abs_diff": diff, "kernel_ms": kernel_ms,
        "kernel_call_ms": call_ms["kernel"], "plain_ms": plain_ms,
        "library_ms": None, "bound_ms": bound_ms, "bound_bytes": nbytes,
        "bound_share": bound_ms / kernel_ms,
        # the same bytes at the card's 32-byte sector granularity: the
        # least time any kernel reading these rows from HBM could take
        "sector_bytes": sector_bytes,
        "sector_bound_ms": sector_bytes / HBM_BYTES_PER_S * 1e3, **floor,
    }
    print(f"[decode] {json.dumps(out)}", flush=True)
    if diff:
        raise AssertionError(f"decode_rows disagrees with its plain "
                             f"version at {label!r}: max |diff| {diff}")
    return out


def phase_decode_kernels(floor: dict) -> list[dict]:
    return [_decode_case(label, groups, B, kind, 100 + i, floor)
            for i, (label, groups, B, kind) in enumerate(DECODE_CASES)]


def phase_method_table() -> list[dict]:
    """The four ``apply_count`` arms at config #1's and #5's geometries
    (``ops.methodbench``, CUDA events); an arm that errs or disagrees
    fails the phase, one whose operands would not fit is skipped."""
    from streambench_tpu_torch.ops import methodbench

    tables = []
    for C, W, B in METHOD_GEOMETRIES:
        t = methodbench.measure_methods(num_campaigns=C, window_slots=W,
                                        batch_size=B, device="cuda")
        print(f"[methods] {json.dumps(t)}", flush=True)
        bad = {m: v for m, v in t["methods"].items() if "error" in v}
        if bad or not t["winner"]:
            raise AssertionError(f"method table at C={C} W={W} B={B}: "
                                 f"{bad}")
        tables.append(t)
    return tables


def _capture_steps(cfg, mapping, campaigns, broker, events: int):
    """The plane's ``(C, W)`` and the ``(campaign, slot, count_mask)`` of
    every K1 launch, cloned, while a fresh engine and store fold the first
    ``events`` of the journal."""
    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.redis_schema import as_redis
    from streambench_tpu_torch.ops import windowcount

    steps, planes = [], set()
    count_cells = windowcount.count_cells

    def keep(counts, campaign, slot, count_mask):
        planes.add(tuple(counts.shape))
        steps.append((campaign.clone(), slot.clone(), count_mask.clone()))
        return count_cells(counts, campaign, slot, count_mask)

    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                               redis=as_redis(make_store()), device="cuda")
    reader = broker.reader(cfg.kafka_topic)
    windowcount.count_cells = keep
    try:
        StreamRunner(engine, reader).run_catchup(max_events=events)
    finally:
        windowcount.count_cells = count_cells
        engine.close()
        reader.close()
    if len(planes) != 1 or not steps:
        raise AssertionError(f"kept {len(steps)} launches on planes {planes}")
    return planes.pop(), steps


def _profile_catchup(cfg, mapping, campaigns, broker, events: int,
                     s_per_event: float) -> dict:
    """Where the device time goes: the first ``events`` of the journal
    again, through a fresh engine and store, under ``torch.profiler``.
    The busy share is device time over wall time; the profiler slows the
    host, so it is also given against the unprofiled run's wall time for
    the same number of events (``s_per_event``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.redis_schema import as_redis

    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                               redis=as_redis(make_store()), device="cuda")
    reader = broker.reader(cfg.kafka_topic)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = StreamRunner(engine, reader).run_catchup(max_events=events)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    engine.close()
    reader.close()
    # device-side events only (kernels, memcpys, memsets): the host ops
    # that launched them carry the same time again
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[2])
    device_s = sum(r[2] for r in rows) / 1e6
    return {
        "events": stats.events, "profiled_wall_s": wall_s,
        "device_s": device_s,
        "busy_share_profiled": device_s / wall_s,
        "busy_share_vs_unprofiled": device_s / (s_per_event * stats.events),
        "top_device": [{"name": k[:80], "calls": c, "device_ms": t / 1e3}
                       for k, c, t in rows[:8]],
    }


def _config(workdir: str, keys: dict | None = None):
    """The fork's ``conf/benchmarkConf.yaml`` with the in-process Redis
    store and ``keys`` (config names as the file spells them) set, written
    into ``workdir`` and loaded as the CLI loads it."""
    import yaml

    from streambench_tpu_torch.config import find_and_read_config_file

    with open(os.path.join(REPO, "conf", "benchmarkConf.yaml")) as f:
        conf = yaml.safe_load(f)
    conf["redis.host"] = ":inprocess:"
    conf.update(keys or {})
    conf_path = os.path.join(workdir, "benchmarkConf.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(conf, f)
    return find_and_read_config_file(conf_path)


def _workdir(name: str) -> str:
    workdir = os.path.join(REPO, "build", name)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    return workdir


def _oracle(r, workdir: str, divisor_ms: int) -> dict:
    """``gen.check_correct`` over the store; raises unless every window
    the journal holds is in the store with its exact count."""
    from streambench_tpu_torch.datagen import gen

    logs: list[str] = []
    t0 = time.perf_counter()
    correct, differ, missing = gen.check_correct(r, workdir, divisor_ms,
                                                 log=logs.append)
    out = {"windows_checked": correct + differ + missing,
           "correct": correct, "differ": differ, "missing": missing,
           "check_correct_s": time.perf_counter() - t0}
    if differ or missing or not correct:
        raise AssertionError(f"oracle: correct={correct} differ={differ} "
                             f"missing={missing}: {logs[:5]}")
    return out


def _generate(workdir: str, cfg, events: int, seed: int, store: bool = True,
              **setup):
    """The generator's dataset (ids, map, broker topic, oracle journal) in
    ``workdir``, and (``store``) an in-process store seeded with the
    campaigns."""
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.journal import FileBroker
    from streambench_tpu_torch.io.redis_schema import as_redis, seed_campaigns

    broker = FileBroker(os.path.join(workdir, "broker"))
    t0 = time.perf_counter()
    gen.do_setup(None, cfg, broker=broker, events_num=events,
                 rng=random.Random(seed), workdir=workdir, **setup)
    mapping = gen.load_ad_mapping_file(
        os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE))
    campaigns = gen.load_ids(workdir)[0]
    r = None
    if store:
        r = as_redis(make_store())
        seed_campaigns(r, campaigns)
    return broker, mapping, campaigns, r, time.perf_counter() - t0


def phase_end_to_end(events: int) -> tuple[dict, tuple, list]:
    import torch

    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.ops.count import count_cells

    workdir = _workdir("smoke")
    try:
        cfg = _config(workdir)
        broker, mapping, campaigns, r, gen_s = _generate(
            workdir, cfg, events, 42, num_campaigns=cfg.jax_num_campaigns,
            ads_per_campaign=cfg.jax_ads_per_campaign)
        print(f"[e2e] generated {events} events in {gen_s:.2f} s",
              flush=True)

        # as the engine CLI does: build and run every device path once on
        # a throwaway engine before the measured run
        warm = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                                 device="cuda")
        warm.warmup()
        warm.close()
        engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                                   redis=r, device="cuda")
        if engine.method != "kernel":
            raise AssertionError(f"engine chose {engine.method!r} on cuda")
        reader = broker.reader(cfg.kafka_topic)
        runner = StreamRunner(engine, reader)

        count_cells.launches = 0          # main path starts here
        t0 = time.perf_counter()
        stats = runner.run_catchup()
        run_s = time.perf_counter() - t0
        engine.close()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = count_cells.launches   # main path ends here
        reader.close()

        result = {
            "events": stats.events, "batches": stats.batches,
            "flushes": stats.flushes,
            "windows_written": stats.windows_written,
            "dropped": engine.dropped,
            "run_catchup_s": run_s, "catchup_with_close_s": total_s,
            "events_per_s": stats.events / run_s,
            "events_per_s_with_close": stats.events / total_s,
            "count_cells_launches": launches, "generate_s": gen_s,
            "stages": engine.tracer.as_dict(),
        }
        print(f"[e2e] {json.dumps(result)}", flush=True)
        result.update(_oracle(r, workdir, cfg.jax_time_divisor_ms))
        print(f"[e2e] oracle {result['windows_checked']} windows exact in "
              f"{result['check_correct_s']:.2f} s", flush=True)
        if stats.events != events:
            raise AssertionError(f"folded {stats.events} of {events}")
        if engine.dropped:
            raise AssertionError(f"{engine.dropped} events dropped")
        if launches <= 0:
            raise AssertionError("the count kernel never launched on the "
                                 "main path")
        result["profile"] = _profile_catchup(
            cfg, mapping, campaigns, broker, min(events, PROFILE_EVENTS),
            run_s / max(stats.events, 1))
        print(f"[profile] {json.dumps(result['profile'])}", flush=True)
        plane, steps = _capture_steps(cfg, mapping, campaigns, broker,
                                      min(events, PROFILE_EVENTS))
        pipelined = phase_pipelined_catchup(workdir, broker, mapping,
                                            campaigns, r, result)
        decode = phase_decode_catchup(workdir, broker, mapping, campaigns,
                                      r, result, pipelined)
        return result, plane, steps, pipelined, decode
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _store_windows(r) -> dict:
    """``(campaign, window_ts) -> seen_count`` of every window in a store:
    one HGETALL per campaign, one HGET per window."""
    out = {}
    for campaign in r.execute("SMEMBERS", "campaigns"):
        fields = r.execute("HGETALL", campaign) or []
        for ts, key in zip(fields[::2], fields[1::2]):
            if ts != "windows":
                out[(campaign, int(ts))] = int(
                    r.execute("HGET", key, "seen_count"))
    return out


def phase_pipelined_catchup(workdir: str, broker, mapping, campaigns,
                            serial_store, serial: dict) -> dict:
    """Phase 8: phase 4's journal through the staged ingest pipeline and
    the encode pool (see the module doc)."""
    import torch

    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.redis_schema import as_redis, seed_campaigns
    from streambench_tpu_torch.ops.count import count_cells

    cfg = _config(workdir, {"jax.ingest.pipeline": "on",
                            "jax.encode.workers": 4})
    r = as_redis(make_store())
    seed_campaigns(r, campaigns)
    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns, redis=r,
                               device="cuda")
    if engine._encode_pool is None:
        raise AssertionError("the encode pool was not built")
    reader = broker.reader(cfg.kafka_topic)
    runner = StreamRunner(engine, reader)
    if not runner._pipeline_on():
        raise AssertionError("the ingest pipeline is not on")

    count_cells.launches = 0              # this path starts here
    t0 = time.perf_counter()
    stats = runner.run_catchup()
    run_s = time.perf_counter() - t0
    engine.close()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = count_cells.launches       # this path ends here
    reader.close()
    result = {
        "events": stats.events, "batches": stats.batches,
        "flushes": stats.flushes, "windows_written": stats.windows_written,
        "dropped": engine.dropped, "run_catchup_s": run_s,
        "catchup_with_close_s": total_s,
        "events_per_s": stats.events / run_s,
        "events_per_s_with_close": stats.events / total_s,
        "serial_events_per_s": serial["events_per_s"],
        "serial_events_per_s_with_close": serial["events_per_s_with_close"],
        "count_cells_launches": launches,
        "serial_count_cells_launches": serial["count_cells_launches"],
        "pipeline": runner._pipeline.telemetry(),
        "cpu_count": os.cpu_count(),
        "sched_affinity": len(os.sched_getaffinity(0)),
        "stages": engine.tracer.as_dict(),
    }
    print(f"[pipeline] {json.dumps(result)}", flush=True)
    t0 = time.perf_counter()
    got, want = _store_windows(r), _store_windows(serial_store)
    result["windows_compared"] = len(want)
    result["compare_s"] = time.perf_counter() - t0
    if got != want or not want:
        diff = [k for k in set(got) | set(want) if got.get(k) != want.get(k)]
        raise AssertionError(f"pipelined windows differ from phase 4's at "
                             f"{len(diff)} of {len(want)}: {diff[:5]}")
    print(f"[pipeline] {len(want)} windows equal phase 4's oracle-checked "
          f"rows ({result['compare_s']:.2f} s)", flush=True)
    if stats.events != serial["events"] or engine.dropped:
        raise AssertionError(f"folded {stats.events} of {serial['events']}, "
                             f"dropped {engine.dropped}")
    if launches <= 0:
        raise AssertionError("the count kernel never launched on the "
                             "pipelined path")
    return result


def phase_decode_catchup(workdir: str, broker, mapping, campaigns,
                         serial_store, serial: dict,
                         pipelined: dict) -> dict:
    """Phase 12: phase 4's journal with device decode on, serial and
    pipelined (see the module doc)."""
    import torch

    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.redis_schema import as_redis, seed_campaigns
    from streambench_tpu_torch.ops import devdecode, methodbench
    from streambench_tpu_torch.ops.count import count_cells
    from streambench_tpu_torch.ops.decode import decode_rows

    want = _store_windows(serial_store)
    out: dict = {}
    for mode in ("off", "on"):
        name = "pipelined" if mode == "on" else "serial"
        cfg = _config(workdir, {"jax.decode.device": "on",
                                "jax.ingest.pipeline": mode})
        r = as_redis(make_store())
        seed_campaigns(r, campaigns)
        warm = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                                 device="cuda")
        warm.warmup()
        warm.close()
        engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                                   redis=r, device="cuda")
        if engine._devdecode is None or engine.method != "kernel":
            raise AssertionError(f"decode {engine._devdecode}, method "
                                 f"{engine.method!r} on cuda")
        reader = broker.reader(cfg.kafka_topic)
        runner = StreamRunner(engine, reader)
        if runner._pipeline_on() != (mode == "on"):
            raise AssertionError(f"ingest pipeline is not {mode}")
        count_cells.launches = 0          # this path starts here
        decode_rows.launches = 0
        t0 = time.perf_counter()
        stats = runner.run_catchup()
        run_s = time.perf_counter() - t0
        engine.close()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        k1, k2 = count_cells.launches, decode_rows.launches   # ends here
        reader.close()
        stages = engine.tracer.as_dict()
        res = {
            "events": stats.events, "flushes": stats.flushes,
            "windows_written": stats.windows_written,
            "dropped": engine.dropped, "run_catchup_s": run_s,
            "catchup_with_close_s": total_s,
            "events_per_s": stats.events / run_s,
            "events_per_s_with_close": stats.events / total_s,
            "phase4_events_per_s": serial["events_per_s"],
            "phase8_events_per_s": pipelined["events_per_s"],
            "device_decode": engine._devdecode.telemetry(),
            "count_cells_launches": k1, "decode_rows_launches": k2,
            "events_per_decode_launch": stats.events / max(k2, 1),
            "spans": {k: stages.get(k) for k in
                      ("decode_probe", "device_decode", "encode", "drain",
                       "redis_flush")},
            "stages": stages,
        }
        if mode == "on":
            res["pipeline"] = runner._pipeline.telemetry()
        print(f"[decode_{name}] {json.dumps(res)}", flush=True)
        t0 = time.perf_counter()
        got = _store_windows(r)
        res["windows_compared"] = len(want)
        res["compare_s"] = time.perf_counter() - t0
        if got != want or not want:
            diff = [k for k in set(got) | set(want)
                    if got.get(k) != want.get(k)]
            raise AssertionError(f"decode ({name}) windows differ from "
                                 f"phase 4's at {len(diff)} of "
                                 f"{len(want)}: {diff[:5]}")
        print(f"[decode_{name}] {len(want)} windows equal phase 4's "
              f"oracle-checked rows ({res['compare_s']:.2f} s)", flush=True)
        if stats.events != serial["events"] or engine.dropped:
            raise AssertionError(f"folded {stats.events} of "
                                 f"{serial['events']}, dropped "
                                 f"{engine.dropped}")
        if res["device_decode"]["rows_fallback"]:
            raise AssertionError(f"generator rows fell back to the host "
                                 f"encoder: {res['device_decode']}")
        if k1 <= 0 or k2 <= 0:
            raise AssertionError(f"K1 launched {k1} and K2 {k2} times on "
                                 f"the decode path")
        out[name] = res
    # bench.py's A/B rule, per ingest mode (the serial loop against phase
    # 4, the pipeline against phase 8): the device wins only if it is
    # oracle-exact (it is, or the phase has failed above) and faster than
    # the host encode
    out["ab"] = {}
    for name, host in (("serial", serial), ("pipelined", pipelined)):
        ab = {"off_events_per_s": host["events_per_s"],
              "on_events_per_s": out[name]["events_per_s"],
              "on_oracle": "exact",
              "fallback_rows": out[name]["device_decode"]["rows_fallback"],
              "winner": ("device" if out[name]["events_per_s"]
                         > host["events_per_s"] else "host"),
              "device": torch.cuda.get_device_name(0)}
        key = devdecode.ab_key("cuda", name == "pipelined")
        methodbench.record(key, ab)
        out["ab"][key] = ab
        print(f"[decode] A/B {name}: host {ab['off_events_per_s']} ev/s, "
              f"device {ab['on_events_per_s']} ev/s -> {key} "
              f"{ab['winner']}", flush=True)
    out["method_cache"] = methodbench.cache_path()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _percentiles(values) -> dict:
    import numpy as np

    a = np.asarray(values, dtype=np.float64)
    return {"rows": int(a.size), "p50_ms": float(np.percentile(a, 50)),
            "p90_ms": float(np.percentile(a, 90)),
            "p99_ms": float(np.percentile(a, 99)), "max_ms": float(a.max())}


def phase_paced(tag: str, load: tuple[int, int], check=None,
                **env_extra) -> dict:
    """Phases 9-11: the harness composite ``TORCH_TEST`` in a fresh
    workdir (see the module doc); every process it starts is stopped.
    ``check(workdir, stats)`` (phase 11) reads the run's artifacts before
    the workdir goes; its result joins the phase's under ``"obs"``."""
    rate, seconds = load
    workdir = _workdir(f"smoke_{tag}")
    harness = [sys.executable, "-m", "streambench_tpu_torch.harness"]
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1",
               WORKDIR=workdir, REDIS_PORT=str(_free_port()),
               TOPIC="ad-events", LOAD=str(rate), TEST_TIME=str(seconds),
               DEVICE="cuda", INGEST_PIPELINE="on", ENCODE_WORKERS="4",
               STOP_STATS_GRACE="5", VERIFY="1")
    env.update(env_extra)

    def log(name: str) -> str:
        try:
            with open(os.path.join(workdir, "logs", f"{name}.log")) as f:
                return f.read()
        except OSError:
            return ""

    try:
        t0 = time.perf_counter()
        p = subprocess.run([*harness, "TORCH_TEST"], cwd=REPO, env=env,
                           capture_output=True, text=True,
                           timeout=seconds + 420)
        wall_s = time.perf_counter() - t0
        engine_log, load_log = log("engine"), log("load")
        if p.returncode:
            raise AssertionError(
                f"TORCH_TEST exited {p.returncode}: {p.stdout[-1500:]} "
                f"{p.stderr[-1500:]} engine.log: {engine_log[-2500:]}")
        lines = engine_log.splitlines()
        stats = json.loads([ln for ln in lines if ln.startswith("{")][-1])
        emitted = int(load_log.split("emitted ")[-1].split()[0])
        behind = [float(ln.split(":")[1].strip()[:-2])
                  for ln in load_log.splitlines()
                  if ln.startswith("Falling behind by:")]
        with open(os.path.join(workdir, "verify.json")) as f:
            verify = json.load(f)
        with open(os.path.join(workdir, "updated.txt")) as f:
            updated = [int(v) for v in f.read().split()]
        with open(os.path.join(workdir, "seen.txt")) as f:
            seen_rows = len(f.read().split())
        result = {
            "load_ev_per_s": rate, "test_time_s": seconds,
            "harness_wall_s": wall_s, "engine_stats": stats,
            "emitted": emitted, "emitted_per_s": emitted / seconds,
            "falling_behind_lines": len(behind),
            "falling_behind_max_ms": max(behind, default=0.0),
            "falling_behind_first_ms": behind[:5],
            "pacing": [ln for ln in load_log.splitlines()
                       if ln.startswith(("pacing:", "formatter:"))],
            "engine_up": [ln for ln in lines if "engine up:" in ln],
            "flush_stalls": [ln for ln in lines
                             if ln.startswith("flush stalls:")],
            "ingest_pipeline": [json.loads(ln.split(":", 1)[1]) for ln in lines
                                if ln.startswith("ingest pipeline:")],
            "verify": verify, "seen_rows": seen_rows,
            "window_latency": _percentiles(updated) if updated else None,
            "count_cells_launches": stats["kernel_launches"]["count_cells"],
            "decode_rows_launches": stats["kernel_launches"]["decode_rows"],
            # the engine's stage spans and latency deciles (its stderr)
            "engine_report": [ln for ln in lines if ln.startswith(
                ("  ", "trace", "latency report"))][:40],
        }
        print(f"[{tag}] {json.dumps(result)}", flush=True)
        if stats["events"] != emitted or stats["dropped"]:
            raise AssertionError(f"engine folded {stats['events']} of "
                                 f"{emitted} emitted, dropped "
                                 f"{stats['dropped']}")
        if not seen_rows or not updated:
            raise AssertionError("seen.txt is empty")
        if (verify["windows_differ"] or verify["windows_missing"]
                or verify["windows_extra"] or not verify["windows_correct"]
                or verify["journal_events"] != emitted):
            raise AssertionError(f"windows do not match the journal: "
                                 f"{verify}")
        if result["count_cells_launches"] <= 0:
            raise AssertionError("the count kernel never launched in the "
                                 "engine process")
        decode = env.get("DECODE_DEVICE", "off") == "on"
        up = " ".join(result["engine_up"])
        if decode and ("decode=device" not in up
                       or result["decode_rows_launches"] <= 0):
            raise AssertionError(f"device decode did not run in the engine "
                                 f"process: {up}, K2 launches "
                                 f"{result['decode_rows_launches']}")
        if check is not None:
            result["obs"] = check(workdir, stats)
            print(f"[{tag}] obs {json.dumps(result['obs'])}", flush=True)
        return result
    finally:
        subprocess.run([*harness, "STOP_ALL"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=180)
        shutil.rmtree(workdir, ignore_errors=True)


def _obs_cli(*args: str) -> dict:
    """``python -m streambench_tpu_torch.obs ... --json``, which must
    exit 0; its JSON output."""
    p = subprocess.run([sys.executable, "-m", "streambench_tpu_torch.obs",
                        *args, "--json"], cwd=REPO, capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    if p.returncode:
        raise AssertionError(f"obs {args[0]} exited {p.returncode}: "
                             f"{p.stderr[-1500:]}")
    return json.loads(p.stdout)


def _trace_busy_share(doc: dict) -> dict:
    """The share of a Chrome trace's window in which the card ran
    anything: the union of its kernel, memcpy and memset events over the
    span from the first event of the trace to the end of its last."""
    spans, device = [], []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        spans.append((t0, t1))
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((t0, t1))
    if not spans:
        return {"window_us": 0.0, "device_us": 0.0, "busy_share": None}
    window = max(t1 for _, t1 in spans) - min(t0 for t0, _ in spans)
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(device):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return {"window_us": window, "device_us": busy,
            "device_events": len(device),
            "busy_share": busy / window if window > 0 else None}


def check_obs(workdir: str, stats: dict) -> dict:
    """Phase 11's checks on the artifacts of the obs-on paced run (see
    the module doc); returns what it read."""
    import glob

    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        records = [json.loads(ln) for ln in f if ln.strip()]
    if len(records) < 20:
        raise AssertionError(f"metrics.jsonl holds {len(records)} records")
    att = _obs_cli("attribution", os.path.join(workdir, "metrics.jsonl"))
    a = att["attribution"]
    if not a or not a.get("writes_observed"):
        raise AssertionError(f"no attributed window writes: {att}")
    segs, e2e = a["segments"], a["e2e_ms"]
    n = a["writes_observed"]
    counts = {k: v.get("count") for k, v in segs.items()}
    if (a["writes_untracked"] or e2e["count"] != n
            or set(counts) != {"ingest", "encode", "fold", "flush", "sink"}
            or any(c != n for c in counts.values())):
        raise AssertionError(f"window writes without all five segments: "
                             f"{n} observed, {a['writes_untracked']} "
                             f"untracked, counts {counts}, e2e "
                             f"{e2e['count']}")
    seg_sum = sum(v["sum"] for v in segs.values())
    # Each sample is clamped at 0, so the sums differ by exactly what the
    # clamping added (the close line's attribution_clamps); unclamped,
    # each write's segments telescope to its time_updated - window_ts.
    # Only a fold that lands while the window's write is in flight may
    # push a segment below 0 (flush, or sink for a second payload), by
    # at most that write's submit-to-landing time: under one flush cycle
    # in a run without a flush stall.
    clamps = stats["attribution_clamps"]
    seg_clamp = sum(clamps["segments_ms"].values())
    if abs((seg_sum - seg_clamp) - (e2e["sum"] - clamps["e2e_ms"])) > 0.01:
        raise AssertionError(
            f"segments sum to {seg_sum} ms less {seg_clamp} clamped, the "
            f"e2e to {e2e['sum']} less {clamps['e2e_ms']}: {clamps}")
    stray = {k: v for k, v in clamps["segments_ms"].items()
             if v and k not in ("flush", "sink")}
    if stray or clamps["e2e_ms"] or clamps["max_write_ms"] > FLUSH_MS:
        raise AssertionError(f"stamps out of order: {clamps}")
    # the lifecycle's e2e covers every write of a window, updated.txt the
    # last write of each (campaign, window): their maxima are one write
    with open(os.path.join(workdir, "updated.txt")) as f:
        updated_max = max(int(v) for v in f.read().split())
    if not 0 <= e2e["max"] - updated_max <= FLUSH_MS:
        raise AssertionError(f"lifecycle e2e max {e2e['max']} ms against "
                             f"updated.txt's {updated_max} ms")
    traces = glob.glob(os.path.join(workdir, "trace_*.json"))
    if len(traces) != 1:
        raise AssertionError(f"span traces: {traces}")
    tr = _obs_cli("trace", traces[0])
    names = set(tr["by_name"])
    missing = [s for s in OBS_TRACE_SPANS if s not in names]
    if missing or not names & set(OBS_DISPATCH_SPANS):
        what = missing or "a fold dispatch span"
        raise AssertionError(f"span trace lacks {what}: {sorted(names)}")
    if not os.path.exists(os.path.join(workdir, "flight_sigterm.jsonl")):
        raise AssertionError("no flight_sigterm.jsonl after "
                             "STOP_TORCH_PROCESSING")
    k1_events = 0
    capture_busy = []
    captures = glob.glob(os.path.join(workdir, "xprof_*", "trace.json"))
    for path in captures:
        with open(path) as f:
            doc = json.load(f)
        k1_events += sum(1 for e in doc.get("traceEvents", [])
                         if e.get("cat") == "kernel"
                         and "count_cells_kernel" in e.get("name", ""))
        capture_busy.append(_trace_busy_share(doc))
    if not k1_events:
        raise AssertionError(f"no K1 kernel in the profiler captures "
                             f"{captures}")
    occ = stats["occupancy"]
    steady = occ["compiles"]["compiles_steady"]
    if (occ["dispatches"] <= 0
            or occ["sampled"] != occ["dispatches"] // occ["sample_every"]
            or not 0 < occ["device_busy_ratio"] <= 1 or steady):
        raise AssertionError(f"occupancy: {occ}")
    packed = stats["xfer"]["formats"]["packed"]
    if packed["bytes_per_row"] != 8.0:
        raise AssertionError(f"packed wire: {packed}")
    if "pass" not in stats.get("slo", {}):
        raise AssertionError(f"no SLO verdict in the close line: "
                             f"{stats.get('slo')}")
    live = stats["devmem"].get("live") or {}
    return {
        "metrics_records": len(records),
        # the run's time series, for where a stall went
        "series": [{k: r.get(k) for k in ("kind", "uptime_ms", "events",
                                          "events_per_s", "stages",
                                          "pending_rows")}
                   for r in records],
        "segments": {k: {"p50_ms": v["p50"], "p99_ms": v["p99"],
                         "sum_ms": v["sum"]} for k, v in segs.items()},
        "e2e_ms": {"p50_ms": e2e["p50"], "p99_ms": e2e["p99"],
                   "sum_ms": e2e["sum"]},
        "segments_over_e2e_ms": seg_sum - e2e["sum"],
        "writes_observed": n,
        "spans": tr["by_name"], "spans_dropped": tr["spans_dropped"],
        "captures": stats["capture"], "k1_kernel_events": k1_events,
        "attribution_clamps": clamps, "e2e_max_ms": e2e["max"],
        "updated_max_ms": updated_max,
        # the card's busy share over each capture's window, from its
        # device events (the occupancy ratio samples event waits only)
        "capture_busy": capture_busy,
        "occupancy": occ, "xfer": stats["xfer"], "slo": stats["slo"],
        "devmem": {"state_bytes": stats["devmem"]["state_bytes"],
                   "peak_footprint_bytes":
                       stats["devmem"]["peak_footprint_bytes"],
                   "kernels": stats["devmem"]["kernels"],
                   "peak_allocated_bytes": live.get("peak_allocated_bytes"),
                   "reserved_bytes": live.get("reserved_bytes")},
    }


class Config5Data:
    """Config #5's dataset (1e6 campaigns x 1 ad, seed 7: the journal, its
    oracle files and the ids), generated once for phase 6 and phase 14's
    run (c); ``store()`` is a fresh in-process store seeded with the
    campaigns, ``config(keys)`` the configuration with ``keys`` set."""

    def __init__(self, events: int, keys: dict = CONFIG5,
                 name: str = "smoke_config5", seed: int = 7):
        self.workdir = _workdir(name)
        self.keys = keys
        self.events = events
        cfg = _config(self.workdir, keys)
        self.broker, self.mapping, self.campaigns, _, self.gen_s = _generate(
            self.workdir, cfg, events, seed, store=False,
            num_campaigns=cfg.jax_num_campaigns,
            ads_per_campaign=cfg.jax_ads_per_campaign)
        print(f"[config5] generated {events} events over "
              f"{len(self.campaigns)} campaigns in {self.gen_s:.2f} s",
              flush=True)

    def config(self, keys: dict | None = None):
        return _config(self.workdir, dict(self.keys, **(keys or {})))

    def store(self):
        """A fresh in-process store holding the campaign set, as
        ``seed_campaigns`` leaves it, in SADDs of 10,000 members: one
        command a campaign costs ~10 s a store at 1e6 campaigns."""
        from streambench_tpu_torch.io.fakeredis import make_store
        from streambench_tpu_torch.io.redis_schema import as_redis

        r = as_redis(make_store())
        for i in range(0, len(self.campaigns), 10_000):
            r.execute("SADD", "campaigns", *self.campaigns[i:i + 10_000])
        return r

    def remove(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def phase_large_key_space(data: Config5Data) -> tuple[dict, dict]:
    """BASELINE config #5's key space on one card (see the module doc).
    Returns the result and the store's windows, which phase 17 holds its
    rows against."""
    import torch

    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.ops.count import count_cells

    events, workdir = data.events, data.workdir
    broker, mapping, campaigns = data.broker, data.mapping, data.campaigns
    cfg = data.config()
    r = data.store()
    warm = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                             device="cuda")
    warm.warmup()
    warm.close()
    del warm
    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                               redis=r, device="cuda")
    if not (engine._track_dirty_rows() and engine._use_compact_drain()):
        raise AssertionError("config #5 did not select the "
                             "large-key-space drains")

    # the first drains dispatch under sync-debug "error": any wait for
    # the card inside them raises.  Then the engine's own method is
    # back, so the rest of the run is not instrumented.
    drain = engine._drain_device
    checked: list[dict] = []

    def drain_checked():
        before = dict(engine.drain_stats)
        torch.cuda.set_sync_debug_mode("error")
        try:
            drain()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked.append({k: v - before[k]
                        for k, v in engine.drain_stats.items()
                        if v != before[k]})
        if len(checked) >= SYNC_CHECKED_DRAINS:
            del engine._drain_device

    engine._drain_device = drain_checked
    reader = broker.reader(cfg.kafka_topic)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
    count_cells.launches = 0          # this path starts here
    t0 = time.perf_counter()
    stats = StreamRunner(engine, reader).run_catchup()
    run_s = time.perf_counter() - t0
    engine.close()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = count_cells.launches   # this path ends here
    reader.close()
    result = {
        "events": stats.events, "flushes": stats.flushes,
        "windows_written": stats.windows_written,
        "dropped": engine.dropped,
        "run_catchup_s": run_s, "catchup_with_close_s": total_s,
        "events_per_s": stats.events / run_s,
        "events_per_s_with_close": stats.events / total_s,
        "drains": dict(engine.drain_stats),
        "sync_checked_drains": checked,
        "count_cells_launches": launches,
        "memory_allocated_at_start_bytes": allocated_at_start,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "counts_plane_bytes": engine.state.counts.numel() * 4,
        "generate_s": data.gen_s, "stages": engine.tracer.as_dict(),
    }
    print(f"[config5] {json.dumps(result)}", flush=True)
    result.update(_oracle(r, workdir, cfg.jax_time_divisor_ms))
    print(f"[config5] oracle {json.dumps(result['windows_checked'])} "
          f"windows exact in {result['check_correct_s']:.2f} s",
          flush=True)
    if stats.events != events or engine.dropped:
        raise AssertionError(f"folded {stats.events} of {events}, "
                             f"dropped {engine.dropped}")
    if not any(c.get("rows_compact") for c in checked):
        raise AssertionError(f"no rows_compact drain ran under the "
                             f"sync check: {checked}")
    if launches <= 0:
        raise AssertionError("the count kernel never launched on the "
                             "config #5 path")
    t0 = time.perf_counter()
    windows = _store_windows(r)
    result["store_read_s"] = time.perf_counter() - t0
    return result, windows


def _plain_sink_catchup(workdir: str, broker, mapping, campaigns) -> dict:
    """The cost of the fence, beside it: the same journal through one
    engine with ``jax.sink.exactly_once`` off (the native bulk write)."""
    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.redis_schema import as_redis, seed_campaigns

    cfg = _config(workdir)
    r = as_redis(make_store())
    seed_campaigns(r, campaigns)
    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns, redis=r,
                               device="cuda")
    t0 = time.perf_counter()
    with broker.reader(cfg.kafka_topic) as reader:
        stats = StreamRunner(engine, reader).run_catchup()
        engine.close()
    return {"events": stats.events, "s_with_close": time.perf_counter() - t0,
            "windows_written": engine.windows_written,
            "stages": engine.tracer.as_dict()}


def phase_exactly_once_resume(events: int) -> dict:
    """A crash in the replay window, resumed exactly (see the module
    doc)."""
    import torch

    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.ops.count import count_cells

    workdir = _workdir("smoke_xo")
    try:
        cfg = _config(workdir, {"jax.sink.exactly_once": True})
        broker, mapping, campaigns, r, gen_s = _generate(
            workdir, cfg, events, 43, num_campaigns=cfg.jax_num_campaigns,
            ads_per_campaign=cfg.jax_ads_per_campaign)
        ckpt = Checkpointer(os.path.join(workdir, "ckpt"))
        count_cells.launches = 0          # this path starts here
        t0 = time.perf_counter()
        a = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns, redis=r,
                              device="cuda")
        reader_a = broker.reader(cfg.kafka_topic)
        StreamRunner(a, reader_a, checkpointer=ckpt).run_catchup(
            max_events=events * 2 // 5)
        snap_seq = ckpt.load().meta["sink_seq"]
        # flushed and landed after the last checkpoint, never covered
        StreamRunner(a, reader_a).run_catchup(max_events=events // 5)
        a.drain_writes()
        a_events, a_written = a.events_processed, a.windows_written
        a_stages = a.tracer.as_dict()
        a._writer.close()                 # stop its thread; no close()
        reader_a.close()
        del a
        a_s = time.perf_counter() - t0

        b = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns, redis=r,
                              device="cuda")
        reader_b = broker.reader(cfg.kafka_topic)
        runner_b = StreamRunner(b, reader_b, checkpointer=ckpt)
        if not runner_b.resume():
            raise AssertionError("engine B found no checkpoint")
        resumed_at = b.events_processed
        t0 = time.perf_counter()
        stats = runner_b.run_catchup()
        b.close()
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t0
        launches = count_cells.launches   # this path ends here
        reader_b.close()
        faults = b.faults.snapshot()
        result = {
            "events": b.events_processed, "a_events": a_events,
            "a_snapshot_sink_seq": snap_seq, "b_resumed_at": resumed_at,
            "b_events": stats.events, "a_s": a_s,
            "b_s_with_close": b_s, "a_windows_written": a_written,
            "b_windows_written": b.windows_written, "stages_a": a_stages,
            "sink_unfenced_resumes": faults.get("sink_unfenced_resumes", 0),
            "reconciled_windows": faults.get("reconciled_windows", 0),
            "faults": faults, "count_cells_launches": launches,
            "generate_s": gen_s, "stages_b": b.tracer.as_dict(),
        }
        print(f"[xo] {json.dumps(result)}", flush=True)
        result.update(_oracle(r, workdir, cfg.jax_time_divisor_ms))
        print(f"[xo] oracle {result['windows_checked']} windows exact in "
              f"{result['check_correct_s']:.2f} s", flush=True)
        if b.events_processed != events or b.dropped:
            raise AssertionError(f"folded {b.events_processed} of {events}, "
                                 f"dropped {b.dropped}")
        if not (result["sink_unfenced_resumes"] > 0
                and result["reconciled_windows"] > 0):
            raise AssertionError(f"the resume did not reconcile: {faults}")
        if launches <= 0:
            raise AssertionError("the count kernel never launched on the "
                                 "exactly-once path")
        result["plain_sink"] = _plain_sink_catchup(workdir, broker, mapping,
                                                   campaigns)
        print(f"[xo] the same journal, exactly-once off: "
              f"{json.dumps(result['plain_sink'])}", flush=True)
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


class _ChaosProbe:
    """Phase 14's instruments around one supervised run, holding no
    engine (weak references only, so a crashed engine can be freed).

    It stands in for the injector's crash scheduler (``point``,
    ``reset``): a crash it passes on stamps the crash
    time and keeps the dying engine's decode telemetry, and the first
    ``batch`` point of each attempt (a fold committed) waits for the card
    and stamps the first fold, the device memory allocated and the
    engines still alive.  ``attach`` times one attempt's construction,
    ``resume()`` (its ``restore`` apart) and each checkpoint's snapshot
    and save."""

    def __init__(self, scheduler, device: str):
        from streambench_tpu_torch.chaos import EngineCrash

        self._crash = EngineCrash
        self._sched = scheduler
        self._cuda = device == "cuda"
        self.attempts: list[dict] = []
        self.checkpoints: list[dict] = []
        self.crashed_decode: list[dict] = []
        self._engines: list = []          # weakref.ref per attempt
        self._crash_t: float | None = None

    def _sync(self) -> None:
        if self._cuda:
            import torch

            torch.cuda.synchronize()

    def _allocated(self) -> int:
        if not self._cuda:
            return 0
        import torch

        return torch.cuda.memory_allocated()

    # -- the scheduler surface the runner and the supervisor call ------
    def reset(self) -> None:
        self._sched.reset()

    def point(self, kind: str) -> None:
        att = self.attempts[-1]
        if kind == "batch" and "first_fold_t" not in att:
            self._sync()
            att["first_fold_t"] = time.perf_counter()
            gc.collect()
            att["allocated_bytes"] = self._allocated()
            att["engines_alive"] = sum(r() is not None
                                       for r in self._engines)
        try:
            self._sched.point(kind)
        except self._crash:
            self._crash_t = time.perf_counter()
            att["crash_at"] = kind
            eng = self._engines[-1]()
            if eng is not None and eng._devdecode is not None:
                self.crashed_decode.append(
                    dict(eng._devdecode.telemetry(),
                         bad_lines=int(eng.encoder.bad_lines)))
            raise

    # -- one attempt ----------------------------------------------------
    def attach(self, build):
        """``build() -> (engine, runner)``, timed and instrumented."""
        t0 = time.perf_counter()
        att = {"since_crash_ms": (None if self._crash_t is None
                                  else (t0 - self._crash_t) * 1e3)}
        engine, runner = build()
        self._sync()
        t1 = time.perf_counter()
        att["construct_ms"] = (t1 - t0) * 1e3
        att["crash_t"] = self._crash_t
        self.attempts.append(att)
        self._engines.append(weakref.ref(engine))
        restore, resume = engine.restore, runner.resume
        snapshot, save = engine.snapshot, runner.checkpointer.save

        def timed_restore(snap):
            r0 = time.perf_counter()
            restore(snap)
            self._sync()
            att["restore_ms"] = (time.perf_counter() - r0) * 1e3
            att["snapshot_bytes"] = int(snap.counts.nbytes)

        def timed_resume():
            r0 = time.perf_counter()
            ok = resume()
            att["resume_ms"] = (time.perf_counter() - r0) * 1e3
            att["resume_end_t"] = time.perf_counter()
            return ok

        def timed_snapshot(offset):
            r0 = time.perf_counter()
            snap = snapshot(offset)
            self.checkpoints.append({
                "attempt": len(self.attempts),
                "snapshot_ms": (time.perf_counter() - r0) * 1e3,
                "counts_bytes": int(snap.counts.nbytes)})
            return snap

        def timed_save(snap):
            r0 = time.perf_counter()
            save(snap)
            self.checkpoints[-1]["save_ms"] = (
                (time.perf_counter() - r0) * 1e3)

        engine.restore, runner.resume = timed_restore, timed_resume
        engine.snapshot = timed_snapshot
        runner.checkpointer.save = timed_save
        return runner

    def report(self) -> list[dict]:
        """Per attempt: its timings, and for each restart the time to
        recover, crash to first fold, in parts."""
        out = []
        for i, att in enumerate(self.attempts, 1):
            rec = {"attempt": i, "crash_at": att.get("crash_at"),
                   "construct_ms": att["construct_ms"],
                   "resume_ms": att.get("resume_ms"),
                   "restore_ms": att.get("restore_ms"),
                   "snapshot_bytes": att.get("snapshot_bytes"),
                   "allocated_at_first_fold_bytes":
                       att.get("allocated_bytes"),
                   "engines_alive_at_first_fold": att.get("engines_alive")}
            fold_t = att.get("first_fold_t")
            if fold_t is not None and "resume_end_t" in att:
                rec["first_fold_ms"] = (fold_t - att["resume_end_t"]) * 1e3
            if att["crash_t"] is not None:
                rec["recover"] = {
                    "progress_check_and_backoff_ms": att["since_crash_ms"],
                    "construct_ms": att["construct_ms"],
                    "resume_ms": att.get("resume_ms"),
                    "first_fold_ms": rec.get("first_fold_ms"),
                    "total_ms": (None if fold_t is None
                                 else (fold_t - att["crash_t"]) * 1e3)}
            out.append(rec)
        return out


def _chaos_supervise(tag: str, plan, device: str, build) -> tuple:
    """One supervised catchup for phase 14: ``build(inj) -> (engine,
    runner)`` makes a fresh attempt (engine on ``device``, wrapped
    reader, checkpointer); the probe stands in for the crash scheduler.
    Returns (stats, injector, supervisor, probe, record)."""
    from streambench_tpu_torch.chaos import FaultInjector, Supervisor
    from streambench_tpu_torch.ops.count import count_cells
    from streambench_tpu_torch.ops.decode import decode_rows

    inj = FaultInjector(plan)
    probe = _ChaosProbe(inj.scheduler, device)

    def make_runner():
        runner = probe.attach(lambda: build(inj))
        runner.crash_points = probe
        return runner

    gc.collect()
    base = probe._allocated()
    sup = Supervisor(make_runner, max_no_progress_restarts=8, seed=1)
    count_cells.launches = 0              # this path starts here
    decode_rows.launches = 0
    t0 = time.perf_counter()
    st = sup.run(catchup=True)
    if not st.completed:
        raise AssertionError(f"[chaos_{tag}] the supervised run gave up: "
                             f"{st.errors}")
    engine = sup.runner.engine
    engine.close()
    probe._sync()
    run_s = time.perf_counter() - t0
    k1, k2 = count_cells.launches, decode_rows.launches   # ends here
    gc.collect()
    after = probe._allocated()
    attempts = probe.report()
    record = {
        "device": device, "attempts": st.attempts, "crashes": st.crashes,
        "restarts": st.restarts, "gave_up": st.gave_up,
        "backoff_ms_total": st.backoff_ms_total,
        "replay_segments": st.replay_segments, "errors": st.errors,
        "carried_windows": len(st.carried),
        "injector": inj.counters.snapshot(),
        "run_faults": st.stats.faults, "events": engine.events_processed,
        "dropped": engine.dropped, "supervised_s": run_s,
        "count_cells_launches": k1, "decode_rows_launches": k2,
        "per_attempt": attempts, "checkpoints": probe.checkpoints,
        "allocated_before_bytes": base, "allocated_after_bytes": after,
    }
    if device == "cuda":
        # one engine's device footprint: attempt 1 at its first fold
        first = next(a["allocated_at_first_fold_bytes"] for a in attempts
                     if a["allocated_at_first_fold_bytes"] is not None)
        footprint = first - base
        record["engine_footprint_bytes"] = footprint
        limit = base + 2 * footprint
        grown = [a["attempt"] for a in attempts
                 if (a["allocated_at_first_fold_bytes"] or 0) > limit]
        if after > limit or grown:
            raise AssertionError(
                f"[chaos_{tag}] device memory grows with the crashes: "
                f"{after} B after the run, attempts {grown} past "
                f"{limit} B (base {base} + 2 x {footprint})")
        if k1 <= 0:
            raise AssertionError(f"[chaos_{tag}] K1 never launched")
    return st, inj, sup, probe, record


def _chaos_verdict(v) -> dict:
    return {"ok": v.ok, "windows": v.windows, "exact": v.exact,
            "within_bound": v.within_bound, "max_overcount": v.max_overcount,
            "undercounts": v.undercounts[:3], "overcounts": v.overcounts[:3]}


def _chaos_journal_runs(events: int, device: str) -> dict:
    """Phase 14 (a) and (b): config #1's journal, exactly-once under the
    reference's exactly-once plan, then at-least-once with device decode
    under its at-least-once plan.  The close-time latency dump
    (``redis.hashtable``) is off in both, as in the reference's
    exactly-once tests: it is diagnostics, not counts, and on the faulted
    sink it would draw plan indices meant for the writeback."""
    from streambench_tpu_torch.chaos import (
        FaultPlan,
        check_at_least_once,
        check_exactly_once,
    )
    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.redis_schema import as_redis, seed_campaigns

    workdir = _workdir("smoke_chaos")
    out: dict = {}
    try:
        cfg0 = _config(workdir)
        broker, mapping, campaigns, _, gen_s = _generate(
            workdir, cfg0, events, 44, num_campaigns=cfg0.jax_num_campaigns,
            ads_per_campaign=cfg0.jax_ads_per_campaign)
        topic = broker.topic_path(cfg0.kafka_topic)
        for tag, keys, plan_kw in (
                ("xo", {"jax.sink.exactly_once": True,
                        "redis.hashtable": ""},
                 dict(sink_rate=0.12, sink_ops=60, sink_outage=(5, 6),
                      sink_partial_rate=0.08, journal_rate=0.4,
                      journal_polls=12)),
                ("decode", {"jax.decode.device": "on",
                            "redis.hashtable": ""},
                 dict(sink_rate=0.25, sink_ops=30, sink_outage=(5, 6),
                      journal_rate=0.4, journal_polls=12))):
            cfg = _config(workdir, dict(CHAOS_SINK_RETRY, **CHAOS_FLUSH,
                                        **keys))
            base = FaultPlan.generate(1234, **plan_kw)
            plan = FaultPlan(seed=1234, sink_faults=base.sink_faults,
                             journal_faults=base.journal_faults,
                             crashes=CHAOS_SCRIPT)
            r = as_redis(make_store())
            seed_campaigns(r, campaigns)
            ckpt_dir = os.path.join(workdir, f"ckpt_{tag}")

            def build(inj, cfg=cfg, r=r, ckpt_dir=ckpt_dir):
                eng = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                                        redis=inj.wrap_redis(r),
                                        device=device)
                return eng, StreamRunner(
                    eng, inj.wrap_reader(broker.reader(cfg.kafka_topic)),
                    checkpointer=Checkpointer(ckpt_dir))

            st, inj, sup, probe, rec = _chaos_supervise(tag, plan, device,
                                                        build)
            rec["generate_s"] = gen_s
            t0 = time.perf_counter()
            if tag == "xo":
                v = check_exactly_once(r, workdir)
                good = v.ok and v.exact == v.windows > 0
            else:
                v = check_at_least_once(r, workdir, topic,
                                        st.replay_segments, st.carried)
                good = v.ok and v.windows > 0
            rec["verdict"] = _chaos_verdict(v)
            rec["check_s"] = time.perf_counter() - t0
            if tag == "decode":
                # the rows the journal faults damaged: a torn page or a
                # corrupt copy per fault served (a truncation damages none)
                served = [k for i, k in plan.journal_faults.items()
                          if i < inj._journal_idx]
                final = dict(sup.runner.engine._devdecode.telemetry(),
                             bad_lines=int(sup.runner.engine.encoder
                                           .bad_lines))
                tel = probe.crashed_decode + [final]
                rec["device_decode"] = {
                    "per_attempt": tel,
                    "rows_fallback": sum(t["rows_fallback"] for t in tel),
                    "bad_lines": sum(t["bad_lines"] for t in tel),
                    "damaged_rows_served": sum(k != "truncated"
                                               for k in served),
                    "journal_faults_served": served}
            print(f"[chaos_{tag}] {json.dumps(rec)}", flush=True)
            if not good:
                raise AssertionError(f"[chaos_{tag}] {v.summary()}")
            if rec["events"] != events or rec["dropped"]:
                raise AssertionError(f"[chaos_{tag}] folded {rec['events']} "
                                     f"of {events}, dropped {rec['dropped']}")
            if st.crashes < 3:
                raise AssertionError(f"[chaos_{tag}] {st.crashes} crashes")
            if tag == "decode":
                dd = rec["device_decode"]
                if not (dd["rows_fallback"] == dd["bad_lines"]
                        == dd["damaged_rows_served"]):
                    raise AssertionError(f"[chaos_decode] rows fell back "
                                         f"beyond the journal damage: {dd}")
                if device == "cuda" and rec["decode_rows_launches"] <= 0:
                    raise AssertionError("[chaos_decode] K2 never launched")
            out[tag] = rec
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _chaos_config5(data: Config5Data, device: str) -> dict:
    """Phase 14 (c): config #5's key space (phase 6's dataset) under a
    crash script with a checkpoint crash.  The store is not wrapped: the
    plan has no sink faults, so the native bulk writeback stays."""
    from streambench_tpu_torch.chaos import FaultPlan, check_at_least_once
    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner

    cfg = data.config(CHAOS_SINK_RETRY)
    r = data.store()
    ckpt_dir = os.path.join(data.workdir, "ckpt_chaos")

    def build(inj):
        eng = AdAnalyticsEngine(cfg, data.mapping, campaigns=data.campaigns,
                                redis=r, device=device)
        return eng, StreamRunner(
            eng, inj.wrap_reader(data.broker.reader(cfg.kafka_topic)),
            checkpointer=Checkpointer(ckpt_dir))

    plan = FaultPlan(seed=7, crashes=CHAOS_CONFIG5_SCRIPT)
    st, _, _, _, rec = _chaos_supervise("config5", plan, device, build)
    t0 = time.perf_counter()
    v = check_at_least_once(r, data.workdir,
                            data.broker.topic_path(cfg.kafka_topic),
                            st.replay_segments, st.carried)
    rec["verdict"] = _chaos_verdict(v)
    rec["check_s"] = time.perf_counter() - t0
    print(f"[chaos_config5] {json.dumps(rec)}", flush=True)
    if not (v.ok and v.windows > 0):
        raise AssertionError(f"[chaos_config5] {v.summary()}")
    if rec["events"] != data.events or rec["dropped"]:
        raise AssertionError(f"[chaos_config5] folded {rec['events']} of "
                             f"{data.events}, dropped {rec['dropped']}")
    if st.crashes < 3 or not any(a["crash_at"] == "checkpoint"
                                 for a in rec["per_attempt"]):
        raise AssertionError(f"[chaos_config5] crashes {st.errors}")
    return rec


def _chaos_kafka(events: int, device: str) -> dict:
    """Phase 14 (d): the in-process fake Kafka, three partitions, broker
    faults and a crash script under exactly-once."""
    from streambench_tpu_torch.chaos import (
        FaultPlan,
        check_exactly_once,
        check_kafka_edge,
    )
    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.io import fakekafka, kafka
    from streambench_tpu_torch.metrics import FaultCounters

    workdir = _workdir("smoke_chaos_kafka")
    try:
        cfg = _config(workdir, dict(CHAOS_SINK_RETRY, **CHAOS_KAFKA_BATCH,
                                    **{"jax.sink.exactly_once": True,
                                       "redis.hashtable": ""}))
        broker, mapping, campaigns, r, gen_s = _generate(
            workdir, cfg, events, 45, num_campaigns=cfg.jax_num_campaigns,
            ads_per_campaign=cfg.jax_ads_per_campaign)
        values = list(broker.read_all(cfg.kafka_topic))
        topic = cfg.kafka_topic
        base = FaultPlan.generate(1234, kafka_produce_rate=0.08,
                                  kafka_conn_drop_rate=0.12,
                                  kafka_ops=8_000, kafka_down=((20, 28),))
        plan = FaultPlan(seed=1234, kafka_faults=base.kafka_faults,
                         kafka_down=base.kafka_down,
                         crashes=CHAOS_KAFKA_SCRIPT)
        counters = FaultCounters()
        cl = fakekafka.FakeCluster()
        cl.create_topic(topic, 3)
        head = len(values) - CHAOS_KAFKA_TAIL
        for i, v in enumerate(values[:head]):
            cl.append(topic, i % 3, v)
        kb = kafka.KafkaBroker(fakekafka.INPROC,
                               clients=fakekafka.clients(cl),
                               counters=counters)
        ckpt_dir = os.path.join(workdir, "ckpt")
        holder: dict = {}

        def build(inj):
            if "armed" not in holder:
                # the tail through the armed cluster, by a real writer:
                # produce faults and the down window land on it
                cl.attach_chaos(inj)
                for p in range(3):
                    w = kafka.KafkaWriter(
                        fakekafka.INPROC, topic, p,
                        clients=fakekafka.clients(cl), counters=counters,
                        retry_base_ms=0.01, retry_cap_ms=0.05)
                    w.append_many(values[head + p::3])
                    w.flush()
                    w.close()
                holder["armed"] = True
                if cl.total_records() != len(values):
                    raise AssertionError("the broker lost acked records")
            eng = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                                    redis=r, device=device)
            return eng, StreamRunner(eng, kb.multi_reader(topic),
                                     checkpointer=Checkpointer(ckpt_dir))

        st, inj, _, _, rec = _chaos_supervise("kafka", plan, device, build)
        rec["generate_s"] = gen_s
        v = check_exactly_once(r, workdir)
        rec["verdict"] = _chaos_verdict(v)
        replayed = sum(sum(hi) - sum(lo) for lo, hi in st.replay_segments)
        kv = check_kafka_edge(counters, sent=len(values) + replayed,
                              require_redeliveries=True, windows=v)
        snap = counters.snapshot()
        rec["ledger"] = {"produced": snap.get("kafka_produced", 0),
                         "acked_records": len(values),
                         "replayed_records": replayed,
                         "consumed": kv.consumed,
                         "delivered": kv.delivered,
                         "redelivered": kv.redelivered,
                         "produce_retries": kv.produce_retries,
                         "consume_retries": kv.consume_retries,
                         "broker_down_ms": kv.broker_down_ms,
                         "violations": kv.violations,
                         "cluster": cl.counters.snapshot()}
        print(f"[chaos_kafka] {json.dumps(rec)}", flush=True)
        if not (kv.ok and v.exact == v.windows > 0):
            raise AssertionError(f"[chaos_kafka] {kv.summary()}")
        if rec["events"] != events or rec["dropped"] or st.crashes < 1:
            raise AssertionError(f"[chaos_kafka] folded {rec['events']} "
                                 f"of {events}, dropped {rec['dropped']}, "
                                 f"{st.crashes} crashes")
        return rec
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_chaos(config5: Config5Data, events: int = CHAOS_EVENTS,
                kafka_events: int = CHAOS_KAFKA_EVENTS,
                device: str = "cuda") -> dict:
    """Phase 14: supervised chaos (see the module doc).  ``device`` and
    the sizes are arguments so the phase can be rehearsed on the CPU at a
    small size; the smoke runs it on ``cuda`` at full size."""
    t0 = time.perf_counter()
    out = _chaos_journal_runs(events, device)
    out["config5"] = _chaos_config5(config5, device)
    out["kafka"] = _chaos_kafka(kafka_events, device)
    out["phase_s"] = time.perf_counter() - t0
    summary = []
    for k in CHAOS_RUNS:
        recover = [a["recover"]["total_ms"] for a in out[k]["per_attempt"]
                   if a.get("recover")]
        summary.append(f"{k}: {out[k]['crashes']} crashes, time to recover "
                       f"ms {recover}")
    print(f"[chaos] {'; '.join(summary)}; {out['phase_s']:.1f} s",
          flush=True)
    return out


# ----------------------------------------------------------------------
# Phase 15: the sketch engines (BASELINE configs #2 and #3) on the card.

# a view in the generator's wire format: its user, ad and event time
_VIEW_RE = re.compile(rb'"user_id": "([^"]*)"[^}]*?"ad_id": "([^"]*)"[^}]*?'
                      rb'"event_type": "view", "event_time": "(-?\d+)"')


def _journal_views(data: Config5Data):
    """``(campaign index, event time ms, user index)`` numpy columns of
    every view in the dataset's journal (the generator's own copy), by
    one regex pass over its bytes; and the campaign names."""
    import numpy as np

    from streambench_tpu_torch.datagen import gen

    with open(os.path.join(data.workdir, gen.KAFKA_JSON_FILE), "rb") as f:
        blob = f.read()
    names = data.campaigns
    index = {c: i for i, c in enumerate(names)}
    ad_campaign = {a.encode(): index[c] for a, c in data.mapping.items()}
    users: dict = {}
    camp, t, user = [], [], []
    for u, ad, ts in _VIEW_RE.findall(blob):
        camp.append(ad_campaign[ad])
        t.append(int(ts))
        user.append(users.setdefault(u, len(users)))
    if not camp:
        raise AssertionError("no view found in the sketch journal")
    return (np.asarray(camp, np.int64), np.asarray(t, np.int64),
            np.asarray(user, np.int64), names)


def _golden_distinct(views) -> dict:
    """Exact distinct users per (campaign, 10 s window) over views."""
    import numpy as np

    camp, t, user, names = views
    triples = np.unique(np.stack([camp, t // 10_000, user], 1), axis=0)
    cw, n = np.unique(triples[:, :2], axis=0, return_counts=True)
    return {(names[int(c)], int(w) * 10_000): int(k)
            for (c, w), k in zip(cw, n)}


def _golden_sliding(views) -> dict:
    """Each view counted in the 10 sliding windows (10 s, 1 s slide)
    covering it: ``(campaign, window start ms) -> views``."""
    import numpy as np

    camp, t, _, names = views
    starts = (t[:, None] // 1000 - np.arange(10)[None, :]) * 1000
    pairs = np.stack([np.repeat(camp, 10), starts.reshape(-1)], 1)
    uk, n = np.unique(pairs, axis=0, return_counts=True)
    return {(names[int(c)], int(w)): int(k) for (c, w), k in zip(uk, n)}


def _sketch_engine(kind: str, cfg, data: Config5Data, r, device: str):
    from streambench_tpu_torch.engine.sketches import (
        HLLDistinctEngine,
        SlidingTDigestEngine,
    )

    cls = HLLDistinctEngine if kind == "hll" else SlidingTDigestEngine
    return cls(cfg, data.mapping, campaigns=data.campaigns, redis=r,
               device=device)


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _sketch_catchup(tag: str, kind: str, data: Config5Data, device: str,
                    keys: dict | None = None) -> tuple:
    """One timed catchup of the dataset through a fresh sketch engine on
    the card, after a warm engine ran every device path once (as the
    CLI does).  Returns (result, store, engine)."""
    from streambench_tpu_torch.engine import StreamRunner
    from streambench_tpu_torch.ops.count import count_cells

    cfg = data.config(keys)
    warm = _sketch_engine(kind, cfg, data, None, device)
    warm.warmup()
    warm.close()
    del warm
    r = data.store()
    engine = _sketch_engine(kind, cfg, data, r, device)
    reader = data.broker.reader(cfg.kafka_topic)
    _sync(device)
    count_cells.launches = 0              # this path starts here
    t0 = time.perf_counter()
    stats = StreamRunner(engine, reader).run_catchup()
    run_s = time.perf_counter() - t0
    engine.close()
    _sync(device)
    total_s = time.perf_counter() - t0
    launches = count_cells.launches       # this path ends here
    reader.close()
    stages = engine.tracer.as_dict()
    fold_ms = sum(stages.get(k, {}).get("total_ms", 0.0)
                  for k in ("device_step", "device_scan"))
    steps = -(-stats.events // engine.batch_size)
    result = {
        "engine": type(engine).__name__, "events": stats.events,
        "flushes": stats.flushes, "windows_written": stats.windows_written,
        "dropped": engine.dropped, "run_catchup_s": run_s,
        "catchup_with_close_s": total_s,
        "events_per_s": stats.events / run_s,
        "events_per_s_with_close": stats.events / total_s,
        "count_cells_launches": launches, "stages": stages,
        "window_slots": engine.W, "batch_size": engine.batch_size,
        "fold_host_ms_per_batch": fold_ms / max(steps, 1),
    }
    if kind != "hll":
        result["sliced"] = engine.sliced
    print(f"[sketch_{tag}] {json.dumps(result)}", flush=True)
    if stats.events != data.events or engine.dropped:
        raise AssertionError(f"[sketch_{tag}] folded {stats.events} of "
                             f"{data.events}, dropped {engine.dropped}")
    return result, r, engine


def _sketch_resume(tag: str, kind: str, data: Config5Data,
                   device: str) -> tuple:
    """Phase 15 (d): engine A catches up half the journal with
    a snapshot after every flush (its run ends with a flush and a
    snapshot that covers it) and is abandoned without ``close()``;
    engine B resumes from the newest snapshot on the same store and
    finishes.  Returns (result, store)."""
    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.engine import StreamRunner
    from streambench_tpu_torch.ops.count import count_cells

    cfg = data.config()
    ckdir = os.path.join(data.workdir, f"ckpt_{tag}")
    shutil.rmtree(ckdir, ignore_errors=True)
    r = data.store()
    count_cells.launches = 0              # this path starts here
    t0 = time.perf_counter()
    a = _sketch_engine(kind, cfg, data, r, device)
    reader = data.broker.reader(cfg.kafka_topic)
    StreamRunner(a, reader, checkpointer=Checkpointer(ckdir),
                 checkpoint_interval_ms=0).run_catchup(
                     max_events=data.events // 2)
    a.drain_writes()
    crashed_at = a.events_processed
    reader.close()
    del a                                 # the crash: no close()
    gc.collect()
    b = _sketch_engine(kind, cfg, data, r, device)
    reader = data.broker.reader(cfg.kafka_topic)
    runner = StreamRunner(b, reader, checkpointer=Checkpointer(ckdir),
                          checkpoint_interval_ms=0)
    t1 = time.perf_counter()
    if not runner.resume():
        raise AssertionError(f"[sketch_{tag}] no snapshot to resume from")
    resume_ms = (time.perf_counter() - t1) * 1e3
    resumed_at = b.events_processed
    stats = runner.run_catchup()
    b.close()
    reader.close()
    launches = count_cells.launches       # this path ends here
    result = {"crashed_at_events": crashed_at,
              "resumed_at_events": resumed_at, "resume_ms": resume_ms,
              "events_after_resume": stats.events,
              "events": b.events_processed, "dropped": b.dropped,
              "count_cells_launches": launches,
              "run_s": time.perf_counter() - t0}
    print(f"[sketch_{tag}] {json.dumps(result)}", flush=True)
    if (resumed_at != crashed_at or b.events_processed != data.events
            or b.dropped or not stats.events):
        raise AssertionError(f"[sketch_{tag}] resume: {result}")
    return result, r


def _windows_equal(tag: str, got: dict, want: dict, what: str) -> None:
    if got != want:
        diff = [k for k in set(got) | set(want) if got.get(k) != want.get(k)]
        raise AssertionError(
            f"[sketch_{tag}] windows differ from {what} at {len(diff)} of "
            f"{len(want)}: {[(k, got.get(k), want.get(k)) for k in diff[:3]]}")


@contextlib.contextmanager
def _sketch_clock(ms: int):
    """The sketch engines' host clock (``engine.sketches.now_ms``, which
    the latency samples read) held at ``ms``."""
    from streambench_tpu_torch.engine import sketches

    real = sketches.now_ms
    sketches.now_ms = lambda: ms
    try:
        yield
    finally:
        sketches.now_ms = real


def _hll_end_state(engine) -> dict:
    """An HLL engine's state after ``close()``: each open window's
    ``[C, R]`` registers by window id (which slot a window claims depends
    on when the wall-clock flushes freed slots), the watermark and
    ``dropped``."""
    st = engine.state
    regs = st.registers.cpu().numpy()
    wids = st.window_ids.cpu().numpy()
    return {"registers": {int(w): regs[:, i] for i, w in enumerate(wids)
                          if w >= 0},
            "watermark": int(st.watermark), "dropped": int(st.dropped)}


def _hll_against_cpu(got: dict, end: dict, ref: dict, ref_end: dict
                     ) -> dict:
    """Run (a) against the same engine on the CPU: the same Redis rows,
    each within 1 (a float32 estimate may truncate to the next integer),
    and the same registers, watermark and ``dropped``."""
    import numpy as np

    if set(got) != set(ref):
        raise AssertionError(f"[sketch_hll] windows {len(got)} != the CPU "
                             f"run's {len(ref)}")
    diff = np.asarray([abs(got[k] - ref[k]) for k in ref])
    if diff.max() > 1:
        k = max(ref, key=lambda k: abs(got[k] - ref[k]))
        raise AssertionError(f"[sketch_hll] {k}: {got[k]} against the CPU "
                             f"run's {ref[k]}")
    regs, ref_regs = end["registers"], ref_end["registers"]
    if (set(regs) != set(ref_regs)
            or not all(np.array_equal(regs[w], ref_regs[w]) for w in regs)
            or end["watermark"] != ref_end["watermark"]
            or end["dropped"] != ref_end["dropped"]):
        raise AssertionError(
            f"[sketch_hll] state after close() differs from the CPU run's:"
            f" windows {sorted(regs)} vs {sorted(ref_regs)}, watermark "
            f"{end['watermark']} vs {ref_end['watermark']}")
    return {"cpu_rows_max_abs_diff": int(diff.max()),
            "cpu_rows_differing": int((diff > 0).sum()),
            "cpu_open_windows_equal": len(regs),
            "cpu_registers_set": int(sum((r > 0).sum()
                                         for r in regs.values()))}


def _quantiles_against_cpu(tag: str, q, weights, ref_q, ref_w) -> float:
    """Quantiles within one histogram bin (2^-5 relative) of the CPU
    run's, and the digest's weight per campaign equal."""
    import numpy as np

    err = float(np.max(np.abs(q - ref_q) / np.maximum(np.abs(ref_q), 1e-3)))
    if not np.array_equal(weights, ref_w) or err > 2.0 ** -5:
        raise AssertionError(
            f"[sketch_{tag}] quantiles off the CPU run's by {err}; weights "
            f"{weights.sum()} vs {ref_w.sum()}")
    return err


def _sketch_ops_check(device: str) -> dict:
    """The sketch ops on ``device`` against the same ops on the CPU, on
    one seeded input: HLL steps (negative user ids, unknown ads, masked
    and late rows) with registers and ring bit-identical and estimates
    within rtol 1e-6; sliced sliding steps and drains (K1 on the card)
    bit-identical; the t-digest's histogram fold, absorb, per-batch
    update and quantiles on lognormal latency-like values, weights exact
    and quantiles within 2^-5."""
    import numpy as np
    import torch

    from streambench_tpu_torch.ops import hll, sliding, tdigest

    rng = np.random.default_rng(SKETCH_SEED)
    C, W, R, B, N = 100, 16, 128, 4096, 8
    jt = np.concatenate([np.arange(C * 10) % C, [-1]]).astype(np.int32)
    out: dict = {}

    def both(fn):
        return fn("cpu"), fn(device)

    def hll_run(dev):
        st = hll.init_state(C, W, R, device=dev)
        g = np.random.default_rng(1)
        for k in range(N):
            cols = (g.integers(-2, jt.size + 2, B).astype(np.int32),
                    g.integers(-2**31, 2**31, B).astype(np.int32),
                    g.integers(-1, 3, B).astype(np.int32),
                    (k * 20_000 + g.integers(-70_000, 20_000, B)
                     ).astype(np.int32), g.random(B) < 0.9)
            st = hll.step(st, torch.from_numpy(jt).to(dev),
                          *(torch.from_numpy(c).to(dev) for c in cols))
        est, wids, st = hll.flush(st)
        return [t.cpu().numpy() for t in (*st, est, wids)]

    a, b = both(hll_run)
    if not all(np.array_equal(x, y) for x, y in zip(a[:4], b[:4])):
        raise AssertionError("[sketch_ops] HLL state differs from the CPU's")
    est_err = float(np.max(np.abs(a[4] - b[4]) / np.maximum(a[4], 1e-6)))
    if est_err > 1e-6:
        raise AssertionError(f"[sketch_ops] HLL estimates off by {est_err}")
    out["hll"] = {"registers_equal": True, "estimate_max_rel_err": est_err,
                  "registers_set": int((a[0] > 0).sum())}

    def sliced_run(dev):
        S, Ws = SLIDE_CLASSES, 2048
        st = sliding.init_sliced(C, Ws, S, device=dev)
        g = np.random.default_rng(2)
        outs = []
        method = "kernel" if dev != "cpu" else "scatter"
        for k in range(N):
            cols = (g.integers(-2, jt.size + 2, B).astype(np.int32),
                    g.integers(-1, 3, B).astype(np.int32),
                    (k * 40_000 + g.integers(-75_000, 5_000, B)
                     ).astype(np.int32), g.random(B) < 0.9)
            st = sliding.step_sliced(
                st, torch.from_numpy(jt).to(dev),
                *(torch.from_numpy(c).to(dev) for c in cols), method=method)
            if k % 3 == 2:
                win, wid, st = sliding.flush_sliced(st)
                outs += [win.cpu().numpy(), wid.cpu().numpy()]
        return outs + [t.cpu().numpy() for t in st]

    a, b = both(sliced_run)
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("[sketch_ops] sliced fold differs from the "
                             "CPU's")
    out["sliced"] = {"equal": True, "dropped": int(a[-1]),
                     "drained_views": int(sum(x.sum() for x in a[0:-4:2]))}

    def digest_run(dev):
        g = np.random.default_rng(3)
        d = tdigest.init_state(C, 64, device=dev)
        hn, hw = tdigest.hist_init(C, device=dev)
        for _ in range(N):
            key = torch.from_numpy(g.integers(-1, C + 1, B).astype(
                np.int32)).to(dev)
            val = torch.from_numpy((g.lognormal(7.0, 1.0, B) - 100.0
                                    ).astype(np.float32)).to(dev)
            m = torch.from_numpy(g.random(B) < 0.8).to(dev)
            d = tdigest.update(d, key, val, m)
            hn, hw = tdigest.fold_hist(hn, hw, key, val,
                                       m.to(torch.float32), C)
        d = tdigest.absorb_hist(d, hn, hw)
        q = tdigest.quantile(d, torch.tensor([0.5, 0.9, 0.99]))
        return d.weights.cpu().numpy(), q.cpu().numpy()

    (wa, qa), (wb, qb) = both(digest_run)
    q_err = float(np.max(np.abs(qa - qb) / np.maximum(np.abs(qa), 1e-3)))
    if not np.array_equal(wa.sum(1), wb.sum(1)) or q_err > 2.0 ** -5:
        raise AssertionError(f"[sketch_ops] t-digest: weights "
                             f"{wa.sum()} vs {wb.sum()}, quantiles off by "
                             f"{q_err}")
    out["tdigest"] = {"weight_total": float(wb.sum()),
                      "quantile_max_rel_err": q_err,
                      "p50_p90_p99_median_ms": np.median(qb, 0).tolist()}
    print(f"[sketch_ops] {json.dumps(out)}", flush=True)
    return out


def phase_sketches(events: int = SKETCH_EVENTS,
                   device: str = "cuda") -> dict:
    """Phase 15: BASELINE configs #2 and #3 on the card (module doc).
    ``device`` and the size are arguments so the phase can be rehearsed
    on the CPU at a small size; the smoke runs it on ``cuda``."""
    import numpy as np

    t0 = time.perf_counter()
    out: dict = {"ops": _sketch_ops_check(device)}
    data = Config5Data(events, keys={}, name="smoke_sketch",
                       seed=SKETCH_SEED)
    out.update(events=events, generate_s=data.gen_s)
    try:
        views = _journal_views(data)
        out["views"] = int(views[0].size)

        # (a) BASELINE #2: HLL distinct users per (campaign, 10 s window)
        hll_res, r, hll_eng = _sketch_catchup("hll", "hll", data, device)
        t1 = time.perf_counter()
        golden = _golden_distinct(views)
        got = _store_windows(r)
        if set(got) != set(golden):
            raise AssertionError(
                f"[sketch_hll] windows {len(got)} != golden {len(golden)}")
        err = np.asarray([abs(got[k] - n) / n for k, n in golden.items()])
        hll_res.update(windows=len(got), mean_rel_err=float(err.mean()),
                       max_rel_err=float(err.max()),
                       check_s=time.perf_counter() - t1,
                       registers=hll_eng.registers)
        if not err.mean() < 0.1:
            raise AssertionError(f"[sketch_hll] mean relative error "
                                 f"{err.mean()} >= 0.1")
        if hll_res["count_cells_launches"] != 0:
            raise AssertionError("[sketch_hll] K1 launched on the HLL path")
        ref_res, ref_r, ref_eng = _sketch_catchup("hll_cpu", "hll", data,
                                                  "cpu")
        t1 = time.perf_counter()
        hll_res.update(_hll_against_cpu(
            got, _hll_end_state(hll_eng), _store_windows(ref_r),
            _hll_end_state(ref_eng)),
            cpu_catchup_with_close_s=ref_res["catchup_with_close_s"],
            cpu_check_s=time.perf_counter() - t1)
        out["hll"] = hll_res
        hll_windows = got
        del hll_eng, r, ref_eng, ref_r

        # (b) BASELINE #3, the sliced fold (K1 on the [C*S, W] plane),
        # and (c) the same with jax.sliding.sliced: off (S claims a
        # batch), both behind a host clock 1 s past the last view
        clock = int(views[1].max()) + 1_000
        with _sketch_clock(clock):
            ref_res, _, ref_eng = _sketch_catchup("sliced_cpu", "sliding",
                                                  data, "cpu")
            ref_q = ref_eng.quantiles()
            ref_w = ref_eng.digest.weights.sum(1).cpu().numpy()
            del ref_eng
            sl_res, r, sl_eng = _sketch_catchup("sliced", "sliding", data,
                                                 device)
        t1 = time.perf_counter()
        golden = _golden_sliding(views)
        got = _store_windows(r)
        _windows_equal("sliced", got, golden, "the sliding golden")
        q = sl_eng.quantiles()
        table = r.hgetall(f"{sl_eng.cfg.redis_hashtable}_quantiles")
        weights = sl_eng.digest.weights.sum(1).cpu().numpy()
        weight = float(weights.sum())
        sl_res.update(
            windows=len(got), check_s=time.perf_counter() - t1,
            quantile_fields=len(table), digest_weight=weight,
            max_latency_ms=clock - int(views[1].min()),
            quantiles_ms={"p50_median": float(np.median(q[:, 0])),
                          "p90_median": float(np.median(q[:, 1])),
                          "p99_median": float(np.median(q[:, 2])),
                          "p50_min": float(q[:, 0].min()),
                          "p99_max": float(q[:, 2].max())},
            cpu_quantile_max_rel_err=_quantiles_against_cpu(
                "sliced", q, weights, ref_q, ref_w),
            cpu_catchup_with_close_s=ref_res["catchup_with_close_s"],
            counts_plane=list(sl_eng.state.counts.shape))
        if not sl_eng.sliced or (device == "cuda"
                                 and sl_res["count_cells_launches"] <= 0):
            raise AssertionError(f"[sketch_sliced] sliced={sl_eng.sliced}, "
                                 f"K1 launches "
                                 f"{sl_res['count_cells_launches']}")
        if not ((q[:, 0] > 0).all() and (q[:, 0] <= q[:, 1] + 1e-3).all()
                and (q[:, 1] <= q[:, 2] + 1e-3).all()):
            raise AssertionError("[sketch_sliced] quantiles not positive "
                                 "or out of order")
        if weight != views[0].size or len(table) != 3 * len(data.campaigns):
            raise AssertionError(
                f"[sketch_sliced] digest weight {weight} against "
                f"{views[0].size} views; {len(table)} quantile fields")
        out["sliced"] = sl_res
        sliced_windows = got
        del sl_eng, r, golden

        with _sketch_clock(clock):
            un_res, r, un_eng = _sketch_catchup(
                "unsliced", "sliding", data, device,
                {"jax.sliding.sliced": "off"})
        t1 = time.perf_counter()
        _windows_equal("unsliced", _store_windows(r), sliced_windows,
                       "run (b)'s")
        un_res.update(
            check_s=time.perf_counter() - t1,
            cpu_quantile_max_rel_err=_quantiles_against_cpu(
                "unsliced", un_eng.quantiles(),
                un_eng.digest.weights.sum(1).cpu().numpy(), ref_q, ref_w))
        if un_eng.sliced:
            raise AssertionError("[sketch_unsliced] ran the sliced fold")
        out["unsliced"] = un_res
        del un_eng, r

        # (d) checkpoint resume, one per family
        res_h, r = _sketch_resume("hll_resume", "hll", data, device)
        _windows_equal("hll_resume", _store_windows(r), hll_windows,
                       "run (a)'s")
        res_s, r = _sketch_resume("sliced_resume", "sliding", data,
                                  device)
        _windows_equal("sliced_resume", _store_windows(r), sliced_windows,
                       "run (b)'s")
        if device == "cuda" and res_s["count_cells_launches"] <= 0:
            raise AssertionError("[sketch_sliced_resume] K1 never launched")
        out["resume"] = {"hll": res_h, "sliced": res_s}
    finally:
        data.remove()
    out["phase_s"] = time.perf_counter() - t0
    print(f"[sketch] ev/s: hll {out['hll']['events_per_s']}, sliced "
          f"{out['sliced']['events_per_s']} (K1 "
          f"{out['sliced']['count_cells_launches']} launches), unsliced "
          f"{out['unsliced']['events_per_s']}; fold host ms a batch sliced "
          f"{out['sliced']['fold_host_ms_per_batch']}, unsliced "
          f"{out['unsliced']['fold_host_ms_per_batch']}; HLL mean rel err "
          f"{out['hll']['mean_rel_err']}, rows off the CPU run's by at most "
          f"{out['hll']['cpu_rows_max_abs_diff']}; quantiles off the CPU "
          f"run's by {out['sliced']['cpu_quantile_max_rel_err']}; "
          f"{out['phase_s']:.1f} s",
          flush=True)
    return out


# ----------------------------------------------------------------------
# K3: the count-min kernel (phase 3) and BASELINE #4 (phase 16)

def _cms_inputs(rng, B: int, kind: str):
    """numpy (keys, weights, mask) of one K3 case (see CMS_CASES): the
    method table's batch (``methodbench.cms_batch``), then the case's
    edge or distinct keys and mask."""
    from streambench_tpu_torch.ops.methodbench import cms_batch

    keys, weights = cms_batch(rng, B)
    if kind == "edge":
        keys[::3] = -1
        keys[1::3] = rng.integers(2**28 + 1, 2**31, keys[1::3].size)
    elif kind == "distinct":
        keys = rng.permutation(SESSION_USERS)[:B].astype(keys.dtype)
    return keys, weights, rng.random(B) >= 1 / 3


def _distinct(flat) -> int:
    """Distinct values of an index tensor (on the card)."""
    import torch

    return int(torch.unique(flat).numel())


def _device_ms_in_turns(fns: dict, rounds: int = 3, reps: int = 100
                        ) -> dict:
    """Median ``_device_ms`` of each of ``fns`` over ``rounds`` rounds run
    in turns (a, b, ..., then b, a, ...), so that drift falls on all."""
    import statistics

    times: dict = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(_device_ms(fns[name], reps))
    return {name: statistics.median(t) for name, t in times.items()}


def _cms_diff(*pairs) -> int:
    """The largest |a - b| over pairs of int tensors (or ints)."""
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


def _cms_case(label: str, B: int, D: int, Wd: int, Ws, kind: str,
              seed: int, floor: dict) -> dict:
    """K3's entry points against their plain versions on the card,
    exactly (and the update against a numpy count where the case is
    small): the update, the query, the columns, the refresh (two-stage
    cases) and the fused entry points, ``cms_update_query`` always and
    ``cms2_update_query`` where the case has a small stage; device times
    over CUDA-graph replays, eager times, the byte bounds of this data
    and their shares, the launch floor, and ``index_add_`` over
    precomputed columns as the update's yardstick (the scatter alone: no
    PyTorch call hashes).  Each fused entry is timed in turns against the
    separate calls it replaces, on the device and per eager call."""
    import numpy as np
    import torch

    from streambench_tpu_torch.ops import cmsrows
    from streambench_tpu_torch.ops.salsa import oracle_cols_np

    rng = np.random.default_rng(seed)
    keys_np, w_np, m_np = _cms_inputs(rng, B, kind)
    base_np = rng.integers(0, 50, (D, Wd)).astype(np.int32)
    k, w, m = (torch.from_numpy(a).cuda() for a in (keys_np, w_np, m_np))
    base = torch.from_numpy(base_np).cuda()
    small_np = (rng.integers(0, 400, (D, Ws)).astype(np.int32) if Ws
                else None)
    diffs = {}

    def seven():
        return torch.tensor(7, dtype=torch.int32, device="cuda")

    # update: the kernel and the plain version from one plane
    tk, totk = base.clone(), seven()
    tp, totp = base.clone(), seven()
    cmsrows.cms_update(tk, totk, k, w, m)
    cmsrows.cms_update_plain(tp, totp, k, w, m)
    diffs["update"] = _cms_diff((tk, tp), (totk, totp))
    if B <= 8192:
        want = base_np.astype(np.int64)
        cols_np = oracle_cols_np(keys_np, D, Wd)
        for d in range(D):
            np.add.at(want[d], cols_np[d][m_np], w_np[m_np])
        diffs["update_numpy"] = int(np.abs(tk.cpu().numpy() - want).max())
    diffs["query"] = _cms_diff((cmsrows.cms_query(tk, k),
                                cmsrows.cms_query_plain(tk, k)))
    cols = cmsrows.cms_cols(k, D, Wd)
    diffs["cols"] = _cms_diff((cols, cmsrows.row_cols_plain(k, D, Wd)))
    # the fused pair: plane, total and estimates
    fk, ftk, fp, ftp = base.clone(), seven(), base.clone(), seven()
    est_k = cmsrows.cms_update_query(fk, ftk, k, w, m)
    est_p = cmsrows.cms_update_query_plain(fp, ftp, k, w, m)
    diffs["update_query"] = _cms_diff((fk, fp), (ftk, ftp), (est_k, est_p))
    if Ws:
        sk = torch.from_numpy(small_np).cuda()
        sp = sk.clone()
        cmsrows.cms_refresh_small(tk, sk, k, m)
        cmsrows.cms_refresh_small_plain(tk, sp, k, m)
        diffs["refresh_small"] = _cms_diff((sk, sp))
        # the fused triple: fat plane, small stage, total and estimates
        fk, ftk, fp, ftp = base.clone(), seven(), base.clone(), seven()
        sk, sp = (torch.from_numpy(small_np).cuda() for _ in range(2))
        est_k = cmsrows.cms2_update_query(fk, sk, ftk, k, w, m)
        est_p = cmsrows.cms2_update_query_plain(fp, sp, ftp, k, w, m)
        diffs["update2_query"] = _cms_diff((fk, fp), (sk, sp), (ftk, ftp),
                                           (est_k, est_p))
    torch.cuda.synchronize()

    # the bytes this data needs: every row's mask byte, the key of a row
    # that is hashed (the update's: an unmasked row's; the query's: every
    # row's) and the weight of an unmasked row, each distinct cell the
    # rows reach read once and each changed cell written once, 4 B out a
    # queried row, 8 B of total
    rows = torch.arange(D, device="cuda", dtype=torch.int64)[:, None]
    flat = rows * Wd + cols.long()
    touched = _distinct(flat[:, m])
    gathered = _distinct(flat)
    live = B - int((~m_np).sum())
    nbytes = {"update": B + 8 * live + 8 * touched + 8,
              "query": 8 * B + 4 * gathered,
              "cols": 4 * B + 4 * D * B,
              "update_query": 9 * B + 4 * live + 4 * gathered
                              + 4 * touched + 8}
    if Ws:
        sflat = rows * Ws + cmsrows.row_cols_plain(k, D, Ws).long()
        s_touched = _distinct(sflat[:, m])
        nbytes["refresh_small"] = B + 4 * live + 4 * touched + 8 * s_touched
        nbytes["update2_query"] = (9 * B + 4 * live + 8 * touched
                                   + 4 * _distinct(sflat) + 4 * s_touched
                                   + 8)

    scratch = base.clone()
    stot = torch.zeros((), dtype=torch.int32, device="cuda")
    small = torch.zeros((D, Ws or 64), dtype=torch.int32, device="cuda")
    fns = {
        "update": (lambda: cmsrows.cms_update(scratch, stot, k, w, m),
                   lambda: cmsrows.cms_update_plain(scratch, stot, k, w, m)),
        "query": (lambda: cmsrows.cms_query(scratch, k),
                  lambda: cmsrows.cms_query_plain(scratch, k)),
        "cols": (lambda: cmsrows.cms_cols(k, D, Wd),
                 lambda: cmsrows.row_cols_plain(k, D, Wd)),
        "update_query": (
            lambda: cmsrows.cms_update_query(scratch, stot, k, w, m),
            lambda: cmsrows.cms_update_query_plain(scratch, stot, k, w, m)),
    }
    if Ws:
        fns["refresh_small"] = (
            lambda: cmsrows.cms_refresh_small(scratch, small, k, m),
            lambda: cmsrows.cms_refresh_small_plain(scratch, small, k, m))
        fns["update2_query"] = (
            lambda: cmsrows.cms2_update_query(scratch, small, stot, k, w, m),
            lambda: cmsrows.cms2_update_query_plain(scratch, small, stot, k,
                                                    w, m))
    lib_flat = torch.where(m[None, :], flat, D * Wd).reshape(-1)
    lib_w = w.expand(D, -1).reshape(-1).contiguous()
    padded = torch.zeros(D * Wd + 1, dtype=torch.int32, device="cuda")

    def library():
        padded.index_add_(0, lib_flat, lib_w)

    reps = max(1, 100 * 8192 // B)
    entries = {}
    for name, (kernel, plain) in fns.items():
        kernel_ms = _device_ms(kernel, reps)
        entries[name] = {
            "kernel_ms": kernel_ms,
            "kernel_call_ms": _call_ms(kernel, max(1, 2 * reps)),
            "plain_ms": _device_ms(plain, max(1, reps // 10)),
            "bound_bytes": nbytes[name],
            "bound_ms": nbytes[name] / HBM_BYTES_PER_S * 1e3,
            "max_abs_diff": diffs[name]}
        entries[name]["bound_share"] = entries[name]["bound_ms"] / kernel_ms

    # each fused entry in turns against the launches it replaces
    def pair():
        cmsrows.cms_update(scratch, stot, k, w, m)
        cmsrows.cms_query(scratch, k)

    def triple():
        cmsrows.cms_update(scratch, stot, k, w, m)
        cmsrows.cms_refresh_small(scratch, small, k, m)
        cmsrows.cms_query(small, k)

    turns = {"update_query": {"fused": fns["update_query"][0],
                              "update + query": pair}}
    if Ws:
        turns["update2_query"] = {"fused": fns["update2_query"][0],
                                  "update + refresh + query": triple}
    for name, arms in turns.items():
        entries[name]["device_ms_in_turns"] = _device_ms_in_turns(arms,
                                                                  reps=reps)
        entries[name]["call_ms_in_turns"] = _call_ms_in_turns(
            arms, rounds=3, reps=max(1, 2 * reps))
    library_ms = _device_ms(library, reps)
    calls = _call_ms_in_turns({"kernel": fns["update"][0],
                               "library": library}, reps=max(1, 2 * reps))
    case = {
        "case": label, "shape": {"B": B, "D": D, "Wd": Wd, "Ws": Ws},
        "inputs": kind,
        "plan": cmsrows.launch_plan(B, entry="cms_update")._asdict(),
        "masked_rows": int((~m_np).sum()), "touched_cells": touched,
        "gathered_cells": gathered, "entries": entries,
        "max_abs_diff": max(diffs.values()), "diffs": diffs,
        "library_ms": library_ms, "library_what": "index_add_ over "
        "precomputed columns (the scatter alone: no PyTorch call hashes)",
        "update_call_ms_in_turns": calls["kernel"],
        "library_call_ms": calls["library"], **floor}
    print(f"[cms_kernels] {json.dumps(case)}", flush=True)
    print(f"[cms_kernels] {label}: " + "; ".join(
        f"{n} {e['kernel_ms']:.6f} ms, bound {e['bound_ms']:.3g} ms, share "
        f"{e['bound_share']:.4f}" for n, e in entries.items()), flush=True)
    if case["max_abs_diff"]:
        raise AssertionError(f"K3 disagrees with its plain version at "
                             f"{label!r}: {diffs}")
    return case


def phase_cms_kernels(floor: dict) -> list[dict]:
    return [_cms_case(label, B, D, Wd, Ws, kind, 200 + i, floor)
            for i, (label, B, D, Wd, Ws, kind) in enumerate(CMS_CASES)]


def phase_cms_method_table() -> dict:
    """The count-min method table at Wd = 2048 (``ops.methodbench``, CUDA
    events): every arm must agree with ``flat`` and time."""
    from streambench_tpu_torch.ops import methodbench

    t = methodbench.measure_cms(width=CMS_METHOD_WIDTH, device="cuda")
    print(f"[methods_cms] {json.dumps(t)}", flush=True)
    bad = {m: v for m, v in t["methods"].items() if "error" in v}
    if bad or not t["winner"]:
        raise AssertionError(f"CMS method table: {bad}")
    return t


_SESSION_RE = re.compile(rb'"user_id": "([^"]*)"[^}]*?"event_type": '
                         rb'"([a-z]+)"')


class SessionData:
    """Phase 16's journal: the stock topology (100 campaigns x 10 ads),
    ``events`` events of ``users`` users ``rate / 1000`` to a millisecond
    (the body), then ``tail`` events of ``tail_users`` new users at the
    same rate from gap + lateness + 1 s past the body's last event (the
    tail: its watermark expires every session of the body), written with
    the generator's own pieces (``gen.EventSource`` over ``make_ids``);
    and its truth: each event's user (by first appearance), time and
    whether it is a click."""

    def __init__(self, events: int, users: int, rate: int = SESSION_RATE,
                 seed: int = SESSION_SEED, name: str = "smoke_session",
                 cms_width: int = 2048, tail: int = SESSION_TAIL_EVENTS,
                 tail_users: int = SESSION_TAIL_USERS):
        import numpy as np

        from streambench_tpu_torch.datagen import gen
        from streambench_tpu_torch.io.journal import FileBroker
        from streambench_tpu_torch.utils.ids import make_ids

        t0 = time.perf_counter()
        self.workdir = _workdir(name)
        self.body, self.events = events, events + tail
        self.users, self.cms_width = users, cms_width
        self.capacity = 1 << max(16, (2 * users - 1).bit_length())
        self.lateness = self.config().jax_allowed_lateness_ms
        rng = random.Random(seed)
        self.campaigns = make_ids(100, rng)
        ads = make_ids(1000, rng)
        gen.write_ids(self.campaigns, ads, self.workdir)
        self.mapping = gen.write_ad_mapping_file(self.campaigns, ads,
                                                 self.workdir)
        page_ids = make_ids(100, rng)
        src = gen.EventSource(ads=ads, user_ids=make_ids(users, rng),
                              page_ids=page_ids, rng=rng)
        tail_src = gen.EventSource(ads=ads, user_ids=make_ids(tail_users, rng),
                                   page_ids=page_ids, rng=rng)
        self.start = 1_700_000_000_000
        per_ms = rate // 1000
        self.body_end = self.start + (events - 1) // per_ms
        tail_start = self.body_end + SESSION_GAP_MS + self.lateness + 1_000
        self.times = np.concatenate([
            self.start + np.arange(events, dtype=np.int64) // per_ms,
            tail_start + np.arange(tail, dtype=np.int64) // per_ms])
        self.broker = FileBroker(os.path.join(self.workdir, "broker"))
        path = os.path.join(self.workdir, gen.KAFKA_JSON_FILE)
        with open(path, "wb") as journal, self.broker.writer(
                self.config().kafka_topic, append=False) as topic:
            for lo in range(0, self.events, 100_000):
                hi = min(lo + 100_000, self.events)
                for s, e, source in ((lo, min(hi, events), src),
                                     (max(lo, events), hi, tail_src)):
                    if s >= e:
                        continue
                    ts = self.times[s:e]
                    blob = source.events_blob_at(ts)
                    if blob is None:
                        blob = "".join(source.event_at(int(t)) + "\n"
                                       for t in ts).encode()
                    journal.write(blob)
                    topic.append_bytes(blob)
        self.end = int(self.times[-1])
        with open(path, "rb") as f:
            pairs = _SESSION_RE.findall(f.read())
        if len(pairs) != self.events:
            raise AssertionError(f"parsed {len(pairs)} of {self.events} "
                                 f"events")
        index: dict = {}
        self.user = np.fromiter((index.setdefault(u, len(index))
                                 for u, _ in pairs), np.int64, self.events)
        self.click = np.fromiter((e == b"click" for _, e in pairs), bool,
                                 self.events)
        self.names = list(index)
        if np.isin(self.user[events:], self.user[:events]).any():
            raise AssertionError("a tail user was seen in the body")
        self.gen_s = time.perf_counter() - t0
        print(f"[session] generated {self.events} events ({events} of the "
              f"body, {tail} of the tail) of {len(index)} users (capacity "
              f"{self.capacity}) in {self.gen_s:.2f} s", flush=True)

    def config(self, keys: dict | None = None):
        return _config(self.workdir, keys)

    def exact_clicks(self, n: int) -> dict:
        """Exact clicks by user name over the first ``n`` events, users
        within capacity only."""
        import numpy as np

        u = self.user[:n][self.click[:n]]
        counts = np.bincount(u, minlength=len(self.names))
        return {self.names[i].decode(): int(c)
                for i, c in enumerate(counts)
                if c and i < self.capacity}

    def overflow(self, n: int) -> int:
        """Events of the first ``n`` whose user falls past capacity."""
        return int((self.user[:n] >= self.capacity).sum())

    def expiry(self, clock: int) -> tuple:
        """The time-expired closures of a run over the whole journal that
        drains once the tail is in, under the host clock ``clock``: one
        for each user of the body within capacity (no such user comes
        back), ending at the user's last event; its latency is ``clock``
        less that end + gap + lateness.  Returns (count, histogram over
        the engine's latency bins)."""
        import numpy as np

        from streambench_tpu_torch.engine.sketches import (LAT_BIN_MS,
                                                           LAT_BINS)

        u = self.user[:self.body]
        last = np.full(len(self.names), -1, np.int64)
        np.maximum.at(last, u, self.times[:self.body])
        ends = last[:min(self.capacity, len(last))]
        ends = ends[ends >= 0]
        lat = np.maximum(clock - (ends + SESSION_GAP_MS + self.lateness), 0)
        bins = np.minimum(lat // LAT_BIN_MS, LAT_BINS - 1)
        return int(ends.size), np.bincount(bins, minlength=LAT_BINS)

    def remove(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def _session_engine(data: SessionData, cfg, r, device: str):
    from streambench_tpu_torch.engine.sketches import SessionCMSEngine

    return SessionCMSEngine(cfg, data.mapping, campaigns=data.campaigns,
                            redis=r, gap_ms=SESSION_GAP_MS,
                            user_capacity=data.capacity, cms_depth=4,
                            cms_width=data.cms_width, top_k=16,
                            device=device)


def _session_state(engine) -> dict:
    """Every piece of a session engine's state, as numpy arrays."""
    import numpy as np
    import torch

    def leaves(x):
        out = []
        for v in x:
            out += leaves(v) if isinstance(v, tuple) else [v]
        return out

    names = (["session_" + f for f in engine.state._fields]
             + [f"sketch_{i}" for i in range(len(leaves(engine.cms)))]
             + ["ring_keys", "ring_ests", "lat_hist"])
    tensors = (list(engine.state) + leaves(engine.cms)
               + list(engine.topk) + [engine.lat_hist])
    out = {n: t.cpu().numpy() if isinstance(t, torch.Tensor)
           else np.asarray(t) for n, t in zip(names, tensors)}
    out["counters"] = np.asarray([engine.sessions_closed,
                                  engine.session_clicks], np.int64)
    return out


def _states_equal(tag: str, got: dict, want: dict, what: str) -> int:
    import numpy as np

    bad = [k for k in want if got[k].dtype != want[k].dtype
           or not np.array_equal(got[k], want[k])]
    if bad or set(got) != set(want):
        raise AssertionError(f"[session_{tag}] state differs from {what} "
                             f"in {bad}")
    return len(want)


def _session_run(tag: str, data: SessionData, device: str,
                 keys: dict | None = None, max_events: int | None = None,
                 ckdir: str | None = None, resume: bool = False,
                 close: bool = True,
                 flush_interval_ms: int | None = None) -> tuple:
    """One catchup of ``data`` through a fresh session engine (after a warm
    one ran every device path, as the CLI does), under the fixed clock;
    K3's launches counted from just before the run to just after
    ``close()``.  ``flush_interval_ms`` overrides the runner's cadence.
    Each drain's closures and latency bins are recorded (``drains``: a
    host read after each).  Returns (result, engine, store)."""
    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.engine import StreamRunner
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.redis_schema import as_redis
    from streambench_tpu_torch.ops import cmsrows
    from streambench_tpu_torch.ops.count import count_cells

    cfg = data.config(keys)
    warm = _session_engine(data, cfg, None, device)
    warm.warmup()
    warm.close()
    del warm
    r = as_redis(make_store())
    engine = _session_engine(data, cfg, r, device)
    reader = data.broker.reader(cfg.kafka_topic)
    runner_kw = ({} if ckdir is None else
                 {"checkpointer": Checkpointer(ckdir),
                  "checkpoint_interval_ms": 0})
    if flush_interval_ms is not None:
        runner_kw["flush_interval_ms"] = flush_interval_ms
    runner = StreamRunner(engine, reader, **runner_kw)
    resume_ms = None
    if resume:
        t1 = time.perf_counter()
        if not runner.resume():
            raise AssertionError(f"[session_{tag}] no snapshot to resume")
        resume_ms = (time.perf_counter() - t1) * 1e3
    resumed_at = engine.events_processed
    drains = _watch_drains(engine)
    _sync(device)
    cmsrows.reset_launches()               # this path starts here
    count_cells.launches = 0
    t0 = time.perf_counter()
    stats = runner.run_catchup(max_events=max_events)
    _sync(device)
    run_s = time.perf_counter() - t0
    if close:
        engine.close()
    _sync(device)
    total_s = time.perf_counter() - t0
    launches = cmsrows.launches()          # this path ends here
    k3 = cmsrows.kernel_launches()
    k1 = count_cells.launches
    reader.close()
    stages = engine.tracer.as_dict()
    fold_ms = sum(stages.get(n, {}).get("total_ms", 0.0)
                  for n in ("device_step", "device_scan"))
    steps = -(-stats.events // engine.batch_size)
    result = {
        "device": device, "cms_mode": engine.cms_mode,
        "cms_stages": engine.cms_stages, "events": stats.events,
        "events_total": engine.events_processed,
        "resumed_at_events": resumed_at, "resume_ms": resume_ms,
        "flushes": stats.flushes, "dropped": engine.dropped,
        "sessions_closed": engine.sessions_closed,
        "session_clicks": engine.session_clicks,
        "run_catchup_s": run_s, "catchup_with_close_s": total_s,
        "events_per_s": stats.events / run_s,
        "events_per_s_with_close": stats.events / total_s,
        "fold_host_ms_per_batch": fold_ms / max(steps, 1),
        "cms_rows_launches": launches,
        "cms_rows_launches_total": k3,
        "count_cells_launches": k1, "stages": stages,
        "drains": len(drains), "expired": sum(c for c, _ in drains),
        "drains_closing": sum(1 for c, _ in drains if c),
        "batch_size": engine.batch_size, "scan_batches":
            engine.scan_batches, "user_capacity": engine.user_capacity}
    print(f"[session_{tag}] {json.dumps(result)}", flush=True)
    return result, engine, r


def _watch_drains(engine) -> list:
    """Wrap ``engine._drain_device`` so that each drain appends (sessions
    it closed, its latency-bin counts) to the returned list, also kept as
    ``engine.drains``."""
    inner = engine._drain_device
    out = engine.drains = []

    def hist():                            # a copy: updated in place
        return engine.lat_hist.cpu().numpy().astype("int64")

    def drain() -> None:
        closed, before = engine.sessions_closed, hist()
        inner()
        out.append((engine.sessions_closed - closed, hist() - before))

    engine._drain_device = drain
    return out


def _expiry_check(tag: str, data: SessionData, res: dict, engine,
                  clock: int) -> dict:
    """The drains of a run over the whole journal closed every session of
    the body by time expiry, each in the latency bin the journal gives."""
    import numpy as np

    want, want_hist = data.expiry(clock)
    got_hist = sum((h for _, h in engine.drains), np.zeros_like(want_hist))
    same_bins = bool(np.array_equal(got_hist, want_hist))
    out = {"expired_want": want, "expired_bins_equal": same_bins,
           "expired_latency_bins": [int(b) for b in
                                    np.flatnonzero(want_hist)[[0, -1]]]}
    if want <= 0 or res["expired"] != want or not same_bins:
        raise AssertionError(f"[session_{tag}] drains closed "
                             f"{res['expired']} sessions, the journal "
                             f"expires {want}; bins equal: {same_bins}")
    return out


def _session_checks(tag: str, data: SessionData, res: dict, engine, r,
                    want_entries: tuple, device: str) -> dict:
    """The run against the journal: every click of a user within capacity
    in some closed session, ``dropped`` the journal's overflow, each
    reported heavy hitter's estimate at least the user's exact clicks,
    ``_hh`` holding the report; on the card, K3 launched through each of
    ``want_entries`` and K1 not at all."""
    n = engine.events_processed
    exact = data.exact_clicks(n)
    hh = engine.heavy_hitters()
    table = r.hgetall(f"{engine.cfg.redis_hashtable}_hh")
    out = {"journal_clicks": sum(exact.values()),
           "journal_overflow": data.overflow(n), "heavy_hitters": hh[:5],
           "hh_rows": len(table),
           "hh_min_margin": min((est - exact.get(u, 0) for u, est in hh),
                                default=None)}
    print(f"[session_{tag}] checks {json.dumps(out)}", flush=True)
    if res["session_clicks"] != out["journal_clicks"]:
        raise AssertionError(f"[session_{tag}] clicks {res['session_clicks']}"
                             f" != the journal's {out['journal_clicks']}")
    if res["dropped"] != out["journal_overflow"]:
        raise AssertionError(f"[session_{tag}] dropped {res['dropped']} != "
                             f"the journal's overflow "
                             f"{out['journal_overflow']}")
    if not hh or len(table) != len(hh) or out["hh_min_margin"] < 0:
        raise AssertionError(f"[session_{tag}] heavy hitters {hh[:5]}, "
                             f"{len(table)} _hh rows")
    if {u: str(e) for u, e in hh} != table:
        raise AssertionError(f"[session_{tag}] _hh rows differ from the "
                             f"report")
    if device == "cuda":
        zero = [e for e in want_entries if res["cms_rows_launches"][e] <= 0]
        if zero or res["count_cells_launches"]:
            raise AssertionError(f"[session_{tag}] K3 launches "
                                 f"{res['cms_rows_launches']}, K1 "
                                 f"{res['count_cells_launches']}")
    return out


def _session_profile(data: SessionData, device: str) -> dict:
    """X5's first number: the device operations (kernels, copies, memsets)
    one eager batch of the session fold launches, from ``torch.profiler``
    over the first SESSION_PROFILE_EVENTS events (one drain at the end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from streambench_tpu_torch.engine import StreamRunner
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.redis_schema import as_redis

    cfg = data.config()
    engine = _session_engine(data, cfg, as_redis(make_store()), device)
    engine.warmup()
    reader = data.broker.reader(cfg.kafka_topic)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        stats = StreamRunner(engine, reader, flush_interval_ms=10**9
                             ).run_catchup(max_events=SESSION_PROFILE_EVENTS)
        _sync(device)
    reader.close()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda x: -x[1])
    launch_calls = sum(e.count for e in prof.key_averages()
                       if e.key in ("cudaLaunchKernel",
                                    "cudaLaunchKernelExC"))
    batches = -(-stats.events // engine.batch_size)
    ops = sum(c for _, c, _ in rows)
    out = {"events": stats.events, "batches": batches,
           "device_ops": ops, "device_ops_per_batch": ops / batches,
           "launch_calls": launch_calls,
           "launch_calls_per_batch": launch_calls / batches,
           "k3_device_ops": sum(c for k, c, _ in rows if "cms_" in k),
           "device_ms": sum(t for _, _, t in rows) / 1e3,
           "top_device_ops": [{"name": k[:80], "count": c,
                               "device_ms": t / 1e3}
                              for k, c, t in rows[:10]]}
    print(f"[session_profile] {json.dumps(out)}", flush=True)
    return out


def phase_session(events: int = SESSION_EVENTS, users: int = SESSION_USERS,
                  device: str = "cuda",
                  two_stage_events: int = SESSION_TWO_STAGE_EVENTS,
                  cms_width: int = 2048) -> dict:
    """Phase 16: BASELINE config #4 on the card (module doc).  ``device``,
    the sizes and the sketch's width are arguments so the phase can be
    rehearsed on the CPU at a small size (a narrow sketch, so that SALSA
    widens cells there too); the smoke runs it on ``cuda`` at Wd =
    2048."""
    from streambench_tpu_torch.ops import salsa

    t0 = time.perf_counter()
    data = SessionData(events, users, cms_width=cms_width)
    out: dict = {"events": data.events, "body_events": events,
                 "users": users, "user_capacity": data.capacity,
                 "gap_ms": SESSION_GAP_MS, "generate_s": data.gen_s}
    # the engines' host clock, 1 s past the journal's last event
    clock = data.end + 1_000
    # (a) and (b) drain only where the catchup ends (no wall-clock
    # drain), on the card and on the CPU alike: that drain expires every
    # session of the body (the tail's watermark has passed them all)
    once = 10**9
    try:
        with _sketch_clock(clock):
            # (a) the fixed sketch, on the card and on the CPU
            res, eng, r = _session_run("fixed", data, device,
                                       flush_interval_ms=once)
            res.update(_session_checks("fixed", data, res, eng, r,
                                       ("cms_update_query", "cms_update",
                                        "cms_query"),
                                       device))
            res.update(_expiry_check("fixed", data, res, eng, clock))
            state_a, hh_a = _session_state(eng), eng.heavy_hitters()
            ref, ref_eng, _ = _session_run("fixed_cpu", data, "cpu",
                                           flush_interval_ms=once)
            res["cpu_expired"] = ref["expired"]
            res["cpu_equal_arrays"] = _states_equal(
                "fixed", state_a, _session_state(ref_eng), "the CPU run's")
            if ref_eng.heavy_hitters() != hh_a:
                raise AssertionError("[session_fixed] _hh differs from the "
                                     "CPU run's")
            res["cpu_catchup_with_close_s"] = ref["catchup_with_close_s"]
            out["fixed"] = res
            del eng, ref_eng

            # (b) jax.cms.mode: salsa, held as (a)
            keys = {"jax.cms.mode": "salsa"}
            res, eng, r = _session_run("salsa", data, device, keys,
                                       flush_interval_ms=once)
            res.update(_session_checks(
                "salsa", data, res, eng, r,
                ("cms_cols",), device), salsa=salsa.stats(eng.cms),
                sketch_summary=eng.sketch_summary())
            res.update(_expiry_check("salsa", data, res, eng, clock))
            ref, ref_eng, _ = _session_run("salsa_cpu", data, "cpu", keys,
                                           flush_interval_ms=once)
            res["cpu_equal_arrays"] = _states_equal(
                "salsa", _session_state(eng), _session_state(ref_eng),
                "the CPU run's")
            if ref_eng.heavy_hitters() != eng.heavy_hitters():
                raise AssertionError("[session_salsa] _hh differs from the "
                                     "CPU run's")
            if res["salsa"]["merged_pairs"] <= 0:
                raise AssertionError(f"[session_salsa] no merge: "
                                     f"{res['salsa']}")
            res["cpu_catchup_with_close_s"] = ref["catchup_with_close_s"]
            out["salsa"] = res
            del eng, ref_eng

            # (c) jax.cms.stages: 2 on the first events: the small stage
            # reads at least every user's exact clicks; held as (a)
            keys = {"jax.cms.stages": 2}
            res, eng, r = _session_run(
                "two_stage", data, device, keys,
                max_events=two_stage_events, flush_interval_ms=once)
            res.update(_session_checks(
                "two_stage", data, res, eng, r,
                ("cms2_update_query", "cms_update", "cms_refresh_small",
                 "cms_query"), device))
            res.update(_small_stage_check(data, eng))
            ref, ref_eng, _ = _session_run(
                "two_stage_cpu", data, "cpu", keys,
                max_events=two_stage_events, flush_interval_ms=once)
            res["cpu_equal_arrays"] = _states_equal(
                "two_stage", _session_state(eng), _session_state(ref_eng),
                "the CPU run's")
            if ref_eng.heavy_hitters() != eng.heavy_hitters():
                raise AssertionError("[session_two_stage] _hh differs from "
                                     "the CPU run's")
            res["cpu_catchup_with_close_s"] = ref["catchup_with_close_s"]
            out["two_stage"] = res
            del eng, ref_eng

            # (d) resume: abandoned half way, resumed from its snapshot;
            # both halves drain every second of wall clock, so its state
            # equal to (a)'s also shows that where a drain falls does not
            # change the result
            ckdir = os.path.join(data.workdir, "ckpt")
            a_res, a, _ = _session_run("resume_a", data, device,
                                       max_events=events // 2, ckdir=ckdir,
                                       close=False)
            a.drain_writes()
            del a                          # the crash: no close()
            gc.collect()
            res, eng, r = _session_run("resume", data, device, ckdir=ckdir,
                                       resume=True)
            res["crashed_at_events"] = a_res["events_total"]
            res["expired_before_crash"] = a_res["expired"]
            res["equal_arrays"] = _states_equal(
                "resume", _session_state(eng), state_a, "run (a)'s")
            if a_res["expired"] + res["expired"] != out["fixed"]["expired"]:
                raise AssertionError(f"[session_resume] drains expired "
                                     f"{a_res['expired']} + {res['expired']}"
                                     f" sessions, (a) "
                                     f"{out['fixed']['expired']}")
            if (eng.heavy_hitters() != hh_a
                    or res["events_total"] != data.events):
                raise AssertionError(f"[session_resume] {res['events_total']}"
                                     f" events; heavy hitters differ")
            out["resume"] = res
            del eng
            out["profile"] = _session_profile(data, device)
    finally:
        data.remove()
    out["phase_s"] = time.perf_counter() - t0
    f, s = out["fixed"], out["salsa"]
    print(f"[session] ev/s: fixed {f['events_per_s']} "
          f"({f['events_per_s_with_close']} with close), salsa "
          f"{s['events_per_s']}, two-stage "
          f"{out['two_stage']['events_per_s']}; fold host ms a batch "
          f"{f['fold_host_ms_per_batch']}; K3 launches "
          f"{f['cms_rows_launches']} (two-stage "
          f"{out['two_stage']['cms_rows_launches']}); expired by drains "
          f"{f['expired']} "
          f"(salsa {s['expired']}); salsa merged pairs "
          f"{s['salsa']['merged_pairs']}; device ops a batch {out['profile']['device_ops_per_batch']}; "
          f"{out['phase_s']:.1f} s", flush=True)
    return out


def _small_stage_check(data: SessionData, engine) -> dict:
    """Every interned user's small-stage (and fat) estimate is at least
    its exact clicks over the events folded."""
    import numpy as np
    import torch

    from streambench_tpu_torch.ops import cms

    exact = data.exact_clicks(engine.events_processed)
    users, _ = engine.encoder.dump_intern_tables()
    want = np.asarray([exact.get(u.decode(), 0) for u in users], np.int64)
    keys = torch.arange(len(users), dtype=torch.int32,
                        device=engine.device)
    small = cms.query_small(engine.cms, keys).cpu().numpy()
    fat = cms.query(engine.cms.fat, keys).cpu().numpy()
    out = {"users_checked": len(users),
           "small_min_margin": int((small - want).min()),
           "fat_min_margin": int((fat - want).min()),
           "small_over_fat_mean": float((small - fat).mean())}
    if out["small_min_margin"] < 0 or out["fat_min_margin"] < 0:
        raise AssertionError(f"[session_two_stage] estimate under exact: "
                             f"{out}")
    return out


# ----------------------------------------------------------------------
# phase 17: BASELINE #5 in the reference's shape (the sharded engine)

SHARDED_RUNS = ("plain", "obs_shard")
COLLECTIVE_REPEATS = 3


def _collective_kernels(engine, repeats: int = 20) -> dict:
    """The NCCL kernels of ``repeats`` x (one step + one 1-batch scan) of
    all-invalid rows under ``torch.profiler``: their device time and the
    host time of the c10d calls that issue them, a dispatch (each
    dispatch issues the same three collectives)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.collective_report(k=1)             # warm outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            engine.collective_report(k=1)
        torch.cuda.synchronize()
    dispatches = 2 * repeats
    dev = [(e.key, e.count, e.self_device_time_total)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()]
    host = [(e.key, e.count, e.cpu_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CPU
            and e.key.startswith("c10d::")]
    return {
        "dispatches": dispatches,
        "device_ms_per_dispatch": sum(t for _, _, t in dev) / 1e3
        / dispatches,
        "host_ms_per_dispatch": sum(t for _, _, t in host) / 1e3
        / dispatches,
        "kernels": [{"name": k[:80], "calls": c, "device_ms": t / 1e3}
                    for k, c, t in dev],
        "host_calls": [{"name": k[:80], "calls": c, "host_ms": t / 1e3}
                       for k, c, t in host],
    }


def phase_sharded(data: Config5Data, want: dict, unsharded: dict,
                  device: str = "cuda") -> dict:
    """Phase 17: ``ShardedWindowEngine`` on a ``(1, 1)`` NCCL mesh over
    phase 6's journal (see the module doc); ``want`` is phase 6's
    oracle-checked store, ``unsharded`` its result.  ``device`` is an
    argument so the phase can be rehearsed on the CPU (gloo, the touched
    rows read through host memory, no device times)."""
    import statistics

    import torch
    import torch.distributed as dist

    from streambench_tpu_torch.engine import StreamRunner
    from streambench_tpu_torch.obs import MetricsRegistry, ShardSkew
    from streambench_tpu_torch.ops.count import count_cells
    from streambench_tpu_torch.parallel import (
        ShardedWindowEngine,
        build_mesh,
    )

    cfg = data.config()
    on_card = device == "cuda"
    drain_kind = "rows_compact" if on_card else "rows_host"
    t0 = time.perf_counter()
    mesh = build_mesh(1, 1, device=device)
    out: dict = {"mesh": repr(mesh), "backend": mesh.backend,
                 "mesh_s": time.perf_counter() - t0}
    try:
        warm = ShardedWindowEngine(cfg, data.mapping, mesh,
                                   campaigns=data.campaigns, device=device)
        warm.warmup()
        warm.close()
        del warm
        for run in SHARDED_RUNS:
            r = data.store()
            engine = ShardedWindowEngine(cfg, data.mapping, mesh,
                                         campaigns=data.campaigns, redis=r,
                                         device=device)
            skew = None
            if run == "obs_shard":
                # jax.obs.shard: the fold's stats arm feeds the tracker
                reg = MetricsRegistry()
                skew = ShardSkew(reg, n_shards=1)
                engine.attach_obs(reg, shard=skew)
            reader = data.broker.reader(cfg.kafka_topic)
            _sync(device)
            count_cells.launches = 0          # this path starts here
            t0 = time.perf_counter()
            stats = StreamRunner(engine, reader).run_catchup()
            run_s = time.perf_counter() - t0
            engine.close()
            _sync(device)
            total_s = time.perf_counter() - t0
            launches = count_cells.launches   # this path ends here
            reader.close()
            res = {
                "events": stats.events, "flushes": stats.flushes,
                "windows_written": stats.windows_written,
                "dropped": engine.dropped,
                "run_catchup_s": run_s, "catchup_with_close_s": total_s,
                "events_per_s": stats.events / run_s,
                "events_per_s_with_close": stats.events / total_s,
                "drains": dict(engine.drain_stats),
                "count_cells_launches": launches,
                "stages": engine.tracer.as_dict(),
            }
            diff: set = set()
            if skew is not None:
                # the stats arm's run is held by its routed rows below;
                # reading a 1e6-campaign store again costs ~15 s
                res["shard_skew"] = skew.summary()
            else:
                t0 = time.perf_counter()
                got = _store_windows(r)
                res["store_read_s"] = time.perf_counter() - t0
                diff = {k for k in got.keys() | want.keys()
                        if got.get(k) != want.get(k)}
                res["windows_equal_phase6"] = len(want) - len(
                    diff & want.keys())
            print(f"[sharded_{run}] {json.dumps(res)}", flush=True)
            if diff:
                raise AssertionError(
                    f"sharded {run}: {len(diff)} of {len(want)} windows "
                    f"differ from phase 6's, e.g. {sorted(diff)[:3]}")
            if stats.events != data.events or engine.dropped:
                raise AssertionError(f"sharded {run}: folded "
                                     f"{stats.events} of {data.events}, "
                                     f"dropped {engine.dropped}")
            if not engine.drain_stats.get(drain_kind):
                raise AssertionError(f"sharded {run}: no {drain_kind} "
                                     f"drain ran: {engine.drain_stats}")
            if on_card and launches <= 0:
                raise AssertionError(f"sharded {run}: the count kernel "
                                     "never launched")
            if skew is not None and res["shard_skew"]["rows"] != [
                    sum(want.values())]:
                raise AssertionError(f"sharded {run}: the shard's routed "
                                     f"rows {res['shard_skew']} are not "
                                     "the views counted")
            out[run] = res
        # the collectives a dispatch issues, from the engine's own
        # counter, each bracketed by CUDA events (the step the path runs,
        # and a scan of the configured group)
        reports = [engine.collective_report(timed=on_card)
                   for _ in range(COLLECTIVE_REPEATS)]
        out["collectives"] = reports[-1]
        for kernel in ("step", "scan") if on_card else ():
            out["collectives"][kernel]["device_ms_runs"] = [
                rep[kernel]["device_ms"] for rep in reports]
            out["collectives"][kernel]["device_ms_median"] = (
                statistics.median(rep[kernel]["device_ms"]
                                  for rep in reports))
        if on_card:
            out["collective_kernels"] = _collective_kernels(engine)
        out["unsharded_events_per_s"] = unsharded["events_per_s"]
        out["unsharded_events_per_s_with_close"] = unsharded[
            "events_per_s_with_close"]
    finally:
        dist.destroy_process_group()
    step = out["collectives"]["step"]
    step.setdefault("device_ms_median", "not measured")
    print(f"[sharded] ev/s {out['plain']['events_per_s']} "
          f"({out['plain']['events_per_s_with_close']} with close) on the "
          f"(1, 1) {mesh.backend} mesh, phase 6 unsharded "
          f"{out['unsharded_events_per_s']} "
          f"({out['unsharded_events_per_s_with_close']}); a step issues "
          f"{step['per_dispatch']['by_kind']} collectives, "
          f"{step['per_dispatch']['bytes']} B, "
          f"{step['device_ms_median']} ms between CUDA events, "
          f"{out.get('collective_kernels', {}).get('device_ms_per_dispatch', 'not measured')}"
          f" ms of NCCL kernels; jax.obs.shard run "
          f"{out['obs_shard']['events_per_s']} ev/s, skew "
          f"{out['obs_shard']['shard_skew']}", flush=True)
    return out


class Laps:
    """Seconds of each phase of one run: ``lap(name)`` closes the phase
    that ran since the last lap (or since the start)."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now

    def as_dict(self) -> dict:
        return {"seconds": self.seconds,
                "total_s": time.perf_counter() - self.start}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--events", type=int, default=5_000_000,
                    help="catchup events for the end-to-end phase")
    ap.add_argument("--out", help="also write every phase's result to "
                    "this JSON file")
    ap.add_argument("--only-sketches", action="store_true",
                    help="a diagnostic: the device, the build, the kernel "
                    "cases and phase 15 alone (no result line)")
    ap.add_argument("--only-session", action="store_true",
                    help="a diagnostic: phases 1-3 and 16 alone (no result "
                    "line)")
    args = ap.parse_args(argv)
    lap = Laps()

    try:
        import torch
    except ImportError as e:
        return fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke needs "
                    "a CUDA card")
    sys.path.insert(0, REPO)
    try:
        from streambench_tpu_torch.ops import _build
    except ImportError as e:
        return fail(f"the port package is not beside this script: {e}")
    if os.path.dirname(os.path.abspath(_build.__file__)) != os.path.join(
            REPO, "streambench_tpu_torch", "ops"):
        return fail("imported a port package from outside this checkout")

    import numpy as np

    # the decode A/B of phase 12 goes to a method cache inside the checkout
    os.environ["STREAMBENCH_TORCH_METHOD_CACHE"] = os.path.join(
        REPO, "build", "smoke_method_bench.json")
    if os.path.exists(os.environ["STREAMBENCH_TORCH_METHOD_CACHE"]):
        os.unlink(os.environ["STREAMBENCH_TORCH_METHOD_CACHE"])

    smi = phase_device()
    ptxas = phase_build()
    cases, floor = phase_kernels()
    if args.only_session:
        decode_cases = phase_decode_kernels(floor)
        cms_cases = phase_cms_kernels(floor)
        methods = phase_method_table()
        cms_methods = phase_cms_method_table()
        session = phase_session()
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"kernel_cases": cases, "decode_cases":
                           decode_cases, "cms_cases": cms_cases,
                           "method_table": methods,
                           "cms_method_table": cms_methods,
                           "session": session, "nvidia_smi": smi,
                           "ptxas": ptxas}, f, indent=1)
        print(smi, flush=True)
        return 0
    if args.only_sketches:
        sketch = phase_sketches()
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"kernel_cases": cases, "sketches": sketch,
                           "nvidia_smi": smi}, f, indent=1)
        print(smi, flush=True)
        return 0
    lap("1-3 device, build, K1 cases")
    decode_cases = phase_decode_kernels(floor)
    cms_cases = phase_cms_kernels(floor)
    methods = phase_method_table()
    cms_methods = phase_cms_method_table()
    lap("3 K2, K3 cases, method tables")
    e2e, (C, W), steps, pipelined, decode = phase_end_to_end(args.events)
    lap("4, 8, 12 catchups")
    config5 = Config5Data(LARGE_EVENTS)
    large, large_rows = phase_large_key_space(config5)
    lap("6 config #5, its journal and oracle")
    xo = phase_exactly_once_resume(LARGE_EVENTS)
    lap("7 exactly-once resume")
    paced = phase_paced("paced", PACED_LOAD)
    lap("9 paced")
    kafka = phase_paced("kafka", KAFKA_LOAD, KAFKA_FAKE="1",
                        KAFKA_BROKERS=f"127.0.0.1:{_free_port()}")
    lap("10 kafka")
    obs = phase_paced("obs", OBS_LOAD, check=check_obs, **OBS_ENV)
    lap("11 obs")
    paced_decode = phase_paced("paced_decode", PACED_DECODE_LOAD,
                               DECODE_DEVICE="on")
    lap("13 paced decode")
    try:
        chaos = phase_chaos(config5)
        lap("14 chaos")
        sharded = phase_sharded(config5, large_rows, large)
        lap("17 config #5 sharded")
    finally:
        config5.remove()
    del large_rows
    sketch = phase_sketches()
    lap("15 sketches")
    session = phase_session()
    lap("16 session")
    print(f"[paced_decode] window latency p50/p99 "
          f"{paced_decode['window_latency']['p50_ms']}/"
          f"{paced_decode['window_latency']['p99_ms']} ms with device "
          f"decode, {paced['window_latency']['p50_ms']}/"
          f"{paced['window_latency']['p99_ms']} ms in phase 9; K2 launches "
          f"{paced_decode['decode_rows_launches']}, K1 launches "
          f"{paced_decode['count_cells_launches']}", flush=True)
    print(f"[decode] catchup ev/s: phase 4 {e2e['events_per_s']}, phase 8 "
          f"{pipelined['events_per_s']}, phase 12 serial "
          f"{decode['serial']['events_per_s']}, pipelined "
          f"{decode['pipelined']['events_per_s']}", flush=True)
    o = obs["obs"]
    print(f"[obs] segments p50/p99 ms: " + ", ".join(
        f"{k} {v['p50_ms']}/{v['p99_ms']}" for k, v in o["segments"].items())
        + f"; clamped {o['attribution_clamps']}; e2e max "
        f"{o['e2e_max_ms']} ms, updated.txt max {o['updated_max_ms']} ms"
        f"; device_busy_ratio {o['occupancy']['device_busy_ratio']}, "
        f"the capture's busy share "
        f"{[c['busy_share'] for c in o['capture_busy']]} "
        f"(phase 4 profiler busy share "
        f"{e2e['profile']['busy_share_profiled']}); peak device memory "
        f"{o['devmem']['peak_allocated_bytes']} B; K1 launches "
        f"{obs['count_cells_launches']}; window latency p50/p99 "
        f"{obs['window_latency']['p50_ms']}/"
        f"{obs['window_latency']['p99_ms']} ms with obs on, "
        f"{paced['window_latency']['p50_ms']}/"
        f"{paced['window_latency']['p99_ms']} ms in phase 9; profiler "
        f"warm-up {o['captures']['warm_s']} s, captures "
        f"{[(c.get('start_s'), c.get('stop_s')) for c in o['captures']['captures']]}"
        f" s (start, stop)", flush=True)
    lap("the summaries")
    cases.append(_kernel_case(
        f"the main path's own rows: every launch of the catchup's first "
        f"{min(args.events, PROFILE_EVENTS)} events", C, W, "catchup",
        steps, np.zeros((C, W), np.int32), floor))

    main_case = cases[0]
    kernels = [{
        "name": "count_cells",
        "route": "cuda",
        "source": "streambench_tpu_torch/csrc/count_cells.cu",
        "replaces": "streambench_tpu/ops/pallas_count.py:51",
        "launches": e2e["count_cells_launches"],
        "launches_by_path": {
            "stock_catchup": e2e["count_cells_launches"],
            "config5_catchup": large["count_cells_launches"],
            **{f"sharded_config5_{k}": sharded[k]["count_cells_launches"]
               for k in SHARDED_RUNS},
            "exactly_once_resume": xo["count_cells_launches"],
            "pipelined_catchup": pipelined["count_cells_launches"],
            "paced_ysb": paced["count_cells_launches"],
            "fake_kafka": kafka["count_cells_launches"],
            "paced_ysb_obs": obs["count_cells_launches"],
            "decode_catchup": decode["serial"]["count_cells_launches"],
            "decode_catchup_pipelined":
                decode["pipelined"]["count_cells_launches"],
            "paced_ysb_decode": paced_decode["count_cells_launches"],
            **{f"supervised_chaos_{k}": chaos[k]["count_cells_launches"]
               for k in CHAOS_RUNS},
            "hll_catchup": sketch["hll"]["count_cells_launches"],
            "sliding_sliced_catchup":
                sketch["sliced"]["count_cells_launches"],
            "sliding_unsliced_catchup":
                sketch["unsliced"]["count_cells_launches"],
            "hll_resume": sketch["resume"]["hll"]["count_cells_launches"],
            "sliding_sliced_resume":
                sketch["resume"]["sliced"]["count_cells_launches"],
            **{f"session_{k}": session[k]["count_cells_launches"]
               for k in SESSION_RUNS}},
        "shape": main_case["shape"],
        "max_abs_err": max(c["max_abs_diff"] for c in cases),
        "max_abs_diff": max(c["max_abs_diff"] for c in cases),
        "ms": main_case["kernel_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_case["library_ms"],
        "launch_floor_ms": main_case["launch_floor_ms"],
        "cases": cases,
    }]
    main_decode = next(c for c in decode_cases
                       if c["inputs"] == "halfbatch")
    kernels.append({
        "name": "decode_rows",
        "route": "cuda",
        "source": "streambench_tpu_torch/csrc/decode_rows.cu",
        # not a Pallas kernel: the XLA fusion _decode_columns
        "replaces": "streambench_tpu/ops/devdecode.py:268",
        "launches": decode["serial"]["decode_rows_launches"],
        "launches_by_path": {
            "decode_catchup": decode["serial"]["decode_rows_launches"],
            "decode_catchup_pipelined":
                decode["pipelined"]["decode_rows_launches"],
            "paced_ysb_decode": paced_decode["decode_rows_launches"],
            "supervised_chaos_decode":
                chaos["decode"]["decode_rows_launches"]},
        "shape": main_decode["shape"],
        "max_abs_err": max(c["max_abs_diff"] for c in decode_cases),
        "ms": main_decode["kernel_ms"],
        "kernel_call_ms": main_decode["kernel_call_ms"],
        "plain_ms": main_decode["plain_ms"],
        "bound_ms": main_decode["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "launch_floor_ms": main_decode["launch_floor_ms"],
        "cases": decode_cases,
    })
    main_cms = cms_cases[0]
    update = main_cms["entries"]["update"]
    kernels.append({
        "name": "cms_rows",
        "route": "cuda",
        "source": "streambench_tpu_torch/csrc/cms_rows.cu",
        # not a Pallas kernel: the XLA program of cms.update (with
        # _row_cols :43, query :88, update2 :145, query_small :164)
        "replaces": "streambench_tpu/ops/cms.py:53",
        "launches": session["fixed"]["cms_rows_launches_total"],
        "launches_by_path": {
            f"session_{k}": session[k]["cms_rows_launches"]
            for k in SESSION_RUNS},
        "shape": main_cms["shape"],
        "max_abs_err": max(c["max_abs_diff"] for c in cms_cases),
        "ms": update["kernel_ms"],
        "kernel_call_ms": update["kernel_call_ms"],
        "plain_ms": update["plain_ms"],
        "bound_ms": update["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_cms["library_ms"],
        "library_what": main_cms["library_what"],
        "launch_floor_ms": main_cms["launch_floor_ms"],
        "cases": cms_cases,
    })
    # the fused entry points, each on the run of its family
    two_cms = next(c for c in cms_cases if c["shape"]["Ws"])
    for name, case, run, entry in (
            ("cms_rows.update_query", main_cms, "fixed", "update_query"),
            ("cms_rows.update2_query", two_cms, "two_stage",
             "update2_query")):
        e = case["entries"][entry]
        fn = "cms2_update_query" if run == "two_stage" else \
            "cms_update_query"
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "streambench_tpu_torch/csrc/cms_rows.cu",
            # cms.update then query (update2 then query_small) in
            # _session_cms_scan, one XLA program there
            "replaces": "streambench_tpu/engine/sketches.py:1083",
            "launches": session[run]["cms_rows_launches"][fn],
            "shape": case["shape"],
            "max_abs_err": e["max_abs_diff"],
            "ms": e["kernel_ms"],
            "kernel_call_ms": e["kernel_call_ms"],
            "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "launch_floor_ms": case["launch_floor_ms"],
            "device_ms_in_turns": e["device_ms_in_turns"],
            "plan": case["plan"],
        })
    lap("5 K1 on the main path's rows")
    laps = lap.as_dict()
    print(f"[smoke] seconds by phase {json.dumps(laps)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"kernels": kernels, "phase_seconds": laps,
                       "method_table": methods,
                       "end_to_end": e2e, "large_key_space": large,
                       "exactly_once_resume": xo,
                       "pipelined_catchup": pipelined, "paced_ysb": paced,
                       "fake_kafka": kafka, "paced_ysb_obs": obs,
                       "decode_catchup": decode,
                       "paced_ysb_decode": paced_decode,
                       "supervised_chaos": chaos,
                       "sharded": sharded,
                       "sketches": sketch,
                       "cms_method_table": cms_methods,
                       "session": session,
                       "nvidia_smi": smi,
                       "ptxas": ptxas}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
