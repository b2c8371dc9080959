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
   of the rows out of shard and masked), the micro-batch window fold
   ([100, 1], 1,666 rows) and the dimension step ([2^20, 16], 8,192 rows
   of keys uniform over 1M), and a 16.7M-row bandwidth
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
   in-process Redis store): generate the catchup journal (1,000,000
   events by default: 10,000,000 cut to 5,000,000, then to 2,000,000 to
   pay for phase 20, then to 1,000,000 for phase 21), run
   ``AdAnalyticsEngine(device="cuda")`` under ``StreamRunner.run_catchup``, and require the generator's oracle
   (``gen.check_correct``) to find every window exact and the count
   kernel to have launched during the run; then replay the first
   1,000,000 events under ``torch.profiler`` for the device busy share,
   and once more to keep the rows of every K1 launch.
5. K1 on the main path's own rows: the launches kept in phase 4, held and
   timed as the cases of phase 3 are.
6. Large key space: BASELINE config #5's settings (1,000,000 campaigns x 1
   ad, a 64-slot ring, 8192-event batches, no scan groups) over a
   generated 1,000,000-event journal through ``StreamRunner.run_catchup``,
   oracle-exact (the store's window digest against the journal's exact
   windows, and a seeded tenth of the campaigns' windows read back and
   held to them), with the drains per branch of ``_drain_device`` (touched
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
   and four encode workers, the generator at 100,000 ev/s for 5 s over
   the file journal, ``-g`` stats, ``VERIFY=1``).  The engine must exit
   0 having folded exactly the events the generator emitted, none
   dropped, with every window in Redis equal to the oracle over the
   journal; the window latency (``updated.txt``) as p50/p90/p99/max.
10. Fake Kafka: the same composite with ``KAFKA_FAKE=1`` (the broker its
   own process, one partition), 10,000 ev/s for 5 s.
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
   ev/s for 5 s, ``VERIFY=1``; the window latency beside phase 9's and
   K2's launches from the engine's stats line.

14. Supervised chaos: the chaos layer (``streambench_tpu_torch.chaos``) on
   the card.  Each run's attempts come from a factory that builds a fresh
   engine on ``cuda``, a fault-wrapped reader and a runner, under a
   ``Supervisor`` (``max_no_progress_restarts=8``): (a) config #1 with
   ``jax.sink.exactly_once: true``, 500,000 events, the reference's
   exactly-once acceptance plan (seed 1234: sink faults with an outage
   and partial applies, torn/truncated/corrupt journal reads, crashes at
   batch 5, flush 1, batch 2, checkpoint 1), every window exact; (b) the
   same journal at-least-once with ``jax.decode.device: on`` (K2, then
   K1) under the at-least-once acceptance plan, within the bound, with
   only the rows the journal faults damaged falling back to the host
   encoder; (c) config #5's key space (phase 6's deployment, seed 7)
   under a script with a checkpoint crash, every event folded and none
   dropped, each restart allocating the 256 MB plane and restoring a
   256 MB snapshot, taken at most every 2 s of wall clock
   (``CHAOS_CONFIG5_KEYS``, not after every flush: part of the cut that
   pays for phase 22) (its at-least-once check of the store, 51.4 s
   here, runs in the CPU rehearsal only: the cut that pays for phase
   18; phase 17 holds config #5's rows to phase 6's); (d) the
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
   of 500,000 events of the stock topology (seed 61, the in-process
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
   snapshots after every flush is abandoned half way and a
   fresh one resumes on the same store, its windows equal to (a)'s and
   (b)'s.  Each run's ev/s (and with ``close()``), its spans, the host
   ms of the fold per batch, K1's launches.  Phase 3 holds K1 on the
   sliced plane (a half batch with a quarter of its rows masked and
   negative, and a full batch).

16. BASELINE config #4, session windows + count-min heavy hitters, as
   the reference benchmark deploys it (``bench.py:1199-1214``) at its
   paced 100,000 ev/s: a 5 s gap, 400,000 users (max(50,000, 4 x rate)),
   a 2^20-user session state (12 MB on the card), CMS D = 4, Wd = 2048,
   top 16 from a 128-slot ring.  Its journal is 2,000,000 events of the
   stock topology, 100 to a millisecond (20 s of the stream; 30 s until
   phase 21 came), written
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
   ``jax.cms.stages: 2`` on the first 500,000 events: every user's
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
   and launch K1; each run's whole store must hold phase 6's windows:
   the same number, the same total of counts (the views phase 6 counted)
   and the same digest of (campaign, window, count) (``window_digest``,
   one native call a store, where the read of each store, 19 s, went to
   pay for phase 19); a seeded sample of 10,000 of phase 6's
   oracle-checked windows (drawn from those of a seeded tenth of the
   campaigns) read back from the plain run's store must be equal, and
   the tracker's routed rows must be the views phase 6 counted.  Its ev/s
   (and with ``close()``) beside phase 6's, and the collectives one
   dispatch issues, by kind and bytes, from the engine's own counter
   (``collective_report``), each bracketed by CUDA events, and the NCCL
   kernels' device time and the c10d calls' host time a dispatch under
   ``torch.profiler``.  (d) ``python -m streambench_tpu_torch.engine
   --sharded`` with ``jax.mesh.shape: [2]`` over phase 6's journal, one
   rank a card: on a host of one card it must exit 2 within seconds with
   the refusal naming 2 ranks and 1 card, and start no rank
   (``"multi_rank": "refused: 2 ranks, 1 card"``); with two cards the
   two NCCL ranks fold the journal into a RESP store process whose
   windows must be phase 6's by the window digest, every rank exiting 0
   and launching K1 (its ev/s beside the runs above).

18. The sharded sketch engines (M16b, ``parallel.sketches``) on the
   ``(1, 1)`` NCCL mesh of phase 17, over phase 15's and 16's journals,
   each held to that phase's card result: (a) ``ShardedHLLEngine``, plain
   and with the shard-skew tracker (``jax.obs.shard``): Redis rows, the
   registers left after ``close()`` window by window, the watermark and
   ``dropped`` equal to 15 (a)'s, no K1 launch, the tracker's routed rows
   the views; (b) ``ShardedSlidingTDigestEngine``, sliced (K1 on the
   shard's ``[Cl*S, W]`` view), under 15 (b)'s clock: the store's window
   digest (count, total, digest) equal to 15 (b)'s store's and a seeded
   sample of 10,000 of 15 (b)'s rows read back (the whole store's read,
   11.9 s, went to pay for phase 19), the ring,
   watermark, ``dropped`` and the digest's weight per campaign equal, the
   quantiles within 2^-5 of 15 (b)'s, K1 launched; (c)
   ``ShardedSessionCMSEngine`` with the fixed sketch, as 16 (a) runs: its
   drains expire what 16 (a)'s did, the session arrays, sketch, ring,
   counters and latency histogram bit-identical to 16 (a)'s, the heavy
   hitters equal, K3's update and query launched and never the fused
   entry; (d) the same with SALSA against 16 (b); (e) the two-stage
   sketch refused.  Each run's ev/s (and with ``close()``), K1's and K3's
   launches, the fullest device memory, the collectives a dispatch by
   kind and bytes, each bracketed by CUDA events, and the NCCL kernels'
   device time under ``torch.profiler``.

19. Reach serving (M13a): the MinHash ∪ HLL reach engine at the
   reference reach benchmark's "large" rung (``bench_reach.py:2262-2285``):
   100 campaigns x 10 ads, 130,000 devices, 600,000 generator events 10
   ms apart, k = 256 signature slots, R = 1,024 registers, B = 8,192.
   (a) ``ReachSketchEngine(device="cuda")`` under
   ``StreamRunner.run_catchup`` on the packed scan: both planes
   bit-identical to ``reach.oracle.expected_state`` over the journal's
   exact device sets, no K1, K2 or K3 launch; an engine abandoned half way
   after a snapshot a flush and a fresh one resumed from it, with the
   same planes and epoch 1; the first four dispatches again under
   ``torch.profiler`` (X6: device operations and device ms a dispatch).
   (b) 512 queries through ``reach.query.query_chunks``: 2 dispatches,
   ``agree`` equal to ``oracle.query_oracle_np``, the mean errors against
   exact set arithmetic inside 2 x 1.04/sqrt(R) (union) and 1/sqrt(k) +
   1.04/sqrt(R) (overlap, relative to the union); ``batch_query`` at Q =
   256 timed between CUDA events and per eager call, its device
   operations and fullest memory (X7).  (c) A storm of 1,200 queries from
   6 pub/sub clients against a held ``ReachQueryServer`` (batch 256,
   depth 2,048): all served in at most 5 dispatches, none shed, p50/p99;
   a shed rung of 300 at depth 64 and batch 64: some shed, shed + served
   = sent.  (d) 400 queries served while a second thread folds a second
   journal (100,000 events over 20,000 new devices) into the same engine,
   pushing between chunks: every query answered or shed, none lost or in
   error, each served ``agree`` that of a state pushed while the query
   was in flight (each push's planes recorded), 64 queries after the
   last push equal to the oracle's over both journals; after ``close()``
   the planes equal that oracle's.  (e) ``python -m
   streambench_tpu_torch.engine --engine reach --device cuda --catchup``
   on (a)'s journal and a tail of 196,608 events over 5 campaigns
   appended to it, flushing and shipping at every chunk to a delta ship
   log, and a RESP store process, and a ``python -m
   streambench_tpu_torch.reach.replica --device cuda`` process tailing the
   log: the tail's own chunks shipped as deltas and the replica folded
   them; 64 queries through the replica's pub/sub with ``agree`` equal to
   the oracle's over both (R = 256, the CLI engine's), the ``_reach`` hash
   the rounded estimates, both processes exiting 0.

20. The replica fleet (M13b): the reference reach benchmark's three fleet
   rungs at their own parameters, the replicas on the card.  (a)
   ``bench_reach.py:run_replica_scaleout``: a writer with phase 19's
   large-rung engine (100 campaigns, k = 256, R = 1,024, B = 8,192)
   folds 128 KB blocks of a 100,000-event journal 0.6 s apart and ships
   every 400 ms, its pub/sub origin live; 1 and then 2 replica processes
   (``chaos.fleet_supervisor.cli_spawn``: ``python -m
   streambench_tpu_torch.reach.replica --device cuda --fleet
   --metrics-dir ...`` at pinned ports) each answer 240 queries 4 ms
   apart.  Shed + served = sent, every reply carries ``plane_epoch``,
   ``staleness_ms`` and a freshness block whose hops sum to it, each
   replica reports its clock estimate; replica 0 is SIGKILLed and the
   supervisor respawns it at its port, and the card's memory in use
   comes back within one replica context (the card's memory taken by the
   first replica) of what it was before the kill; then the ingest
   stops, the last planes ship, and 64 queries of 4-6 campaigns to each
   replica give the oracle's ``agree``; ``obs fleet`` over the run's
   journals renders the writer and the replicas, and ``obs trace
   --merge`` of the writer's and the replicas' traces validates.  It
   reports the off-writer contention ratio, staleness p50/p99, each
   replica process's seconds to its ready line and to its first answer,
   and the peak device memory per process.  (b)
   ``run_fleet_chaos``: 2 in-process replicas on the card behind
   ``ChaosPubSub`` proxies sharing one seeded injector, the router in
   front, epochs shipped live through the ship-log fault hook and
   queries at the reference's own smoke schedule (10 epochs 0.3 s
   apart, 60 queries; the defaults, 14 and 160, are 134 s of timeouts),
   each replica killed once mid-storm and respawned at its
   port by the ``FleetSupervisor`` (its planes freed before its successor
   loads); sent = answered + shed by id, no answer staler than the bound,
   the final record bit-identical to the fault-free arm's; the router's
   failover p99 and shed ratio.  (c) ``run_autoscale`` at its reduced
   schedule (5 -> 30 qps over 8 s, bursts of 24, 8 s of tail; the
   defaults, 6 -> 36 qps over 14 s and 7 s of tail, do not fit the
   smoke's time) against in-process
   replicas (K = 8,192, R = 4,096, 16 campaigns) without and with the
   ``AutoscaleController`` (at most 3 replicas): the ON arm's breach
   ratio below the OFF arm's, at least one scale-up, every decision
   journaled with its freshness-hop evidence.  No kernel runs on this
   path: K1-K3 launch 0 times.

21. The hyper-extended HLL engine (M14) and sharded reach (M16c).  (b)
   ``parallel.reach.ShardedReachEngine`` on a (1, 1) NCCL mesh over
   phase 19's journal (600,000 events, k = 256, R = 1,024, B = 8,192, in
   a topic of its own: 19 (e) appended a tail to the main one): the
   planes bit-identical to 19's engine's (the oracle's); 19 (b)'s 512
   queries through ``batch_query`` (2 dispatches) and through a
   ``ReachQueryServer`` with the sharded evaluator installed by
   ``attach_reach``, every answer equal to the unsharded
   ``batch_query``'s on 19's planes; exactly 2 collectives recorded a
   query dispatch (one all-reduce MIN, one MAX), and the engine's
   ``collective_report`` agrees; one dispatch next to the shards timed
   between CUDA events beside 19 (b)'s X7, per eager call, and its device
   operations (X9); ev/s beside 19 (a)'s.  (a) ``HLLXEngine`` at the
   CLI's defaults (G = 8, R = 128, the stock 100 campaigns) over phase
   15's journal (seed 61): F1 equal to the journal's views, registers
   and totals bit-identical to the same engine on the CPU and its
   moments within rtol 1e-6, a snapshot -> resume equal to the
   uninterrupted run, the ``<hashtable>_hllx`` rows (11 a campaign);
   ev/s, ``device_scan`` ms, the fullest device memory, and the device
   operations and ms of a packed-scan dispatch (X8).  Its ops rung at the
   reference bench's size (``bench_sketch.py:run_hllx``: C = 8, G = 8,
   R = 128, 150,000 Zipf keys with 300,000 extra events capped at 120,
   B = 65,536): the distinct and log-moment relative errors against each
   campaign's exact statistics under 0.2 and 0.15
   (``tests/test_hllx.py:180-225``).  Then, side by side, ``python -m
   streambench_tpu_torch.engine --engine hllx --catchup --checkpointDir
   D`` over 15's journal (its exit snapshot's registers and totals those
   of the run above) and 19 (e) again with ``--sharded`` (its own ship
   log, a replica process, the answers the oracle's over journal and
   tail, as the unsharded CLI's).  K1-K3 launch 0 times on every path.

22. The fork's count-window micro-batch mode (M15a), the columnar
   handoff, and the dimensional-aggregation family (M15b).  One journal
   of 1,500,000 events of the stock topology (seed 71), split round-robin
   over the stock ``map.partitions: 3`` (``window.size: 5000``: 300
   windows of 3 x 1,666 events).  (a) ``run_microbatch(device="cuda")``
   with the in-process barrier: every merged window equal to the
   journal's golden (its views a window per campaign), the fork's latency
   hash in the store (``thread_idx``, ``running_time:<i>``,
   ``<windowStart>:<i>``), K1 once a window a partition and once in the
   warm-up; the first 100 windows equal the same run on the CPU; HLL
   (R = 128) on the card over the first 100 windows, each partition's
   registers window by window bit-identical to the CPU run's, estimates
   within 1, no K1; the ``RedisWindowBarrier`` over the in-repo RESP server
   (a connection a partition) for 30 windows, equal, its stamp fields
   kept and its count back at 0; a checkpointed run stopped at window 100
   (chunks every 64 windows) and resumed, equal to the clean run.
   Windows/s, ev/s, p50/p99 window latency, and the window fold's device
   ms (CUDA-graph replays) and eager ms a call.  (b) The handoff CLI's
   entry at the reference's defaults (20 windows of 5,000 events): r2c
   and c2r p50 and max.  Then ``python -m streambench_tpu_torch.engine
   --microbatch`` over the journal (its ``total_views`` the golden's) and
   ``python -m streambench_tpu_torch.dimensions --generate 100000`` run
   as processes beside (c): ``run_synthetic`` at 1,000,000 campaigns into
   2^20 keys, W = 16, 2,000,000 events, B = 8,192: rows equal to a numpy
   oracle over the same seeded draws, none dropped, K1 once a step; ev/s,
   the fold's device ms a step, the fullest device memory, the
   interner's and the row build's share; ``DimensionApp`` (the default
   schema) over the journal whole: every (campaign, 10 s bucket)'s
   ``clicks:SUM`` the journal's views, ``latency:MAX`` >= 0, K1 once a
   step.  K2 and K3 launch 0 times on every path.
23. The multi-tenant host (M15c) at the stock configuration (100
   campaigns x 10 ads, 16 slots, 10 s windows), on a 250,000-event
   journal (seed 31) cut into its 8,192-event batches.  Gates that hold
   at any speed; the speeds are findings.  (a) ``ex:exact, se:session,
   hl:hll, rc:reach`` under one ``MultiTenantHost(device="cuda")``,
   admission off, ``sample_every`` 4, every batch offered to each tenant
   and folded by ``step()``: each tenant's Redis rows after ``close()``
   equal those of the same engine class alone on the card over the same
   batches (exact and session bit for bit, HLL and reach estimates
   within 1, the reach planes bit for bit), the exact rows exact by
   ``gen.check_correct``, K1's and K3's launches under the host equal to
   the engines' alone (and non-zero), the partition check ``ok`` and
   each tenant's attributed busy equal to its sampler's ``busy_ns``;
   ev/s by each tenant's ``process_lines`` time under the host and
   alone, the host's loop against the engines' loops alone (each ended
   by a synchronise), attributed busy ms, the offdiag ratio.  (b) ``bench_multitenant.py``'s
   ``--smoke`` flash crowd (8 s, crowd 2-6 s; alpha session, beta reach,
   gamma reach serving at 20 qps with a 12 ms ``reach_p99_ms``; its
   ``admission_kw``) in an off and an on arm: both partition checks
   pass, every queue drains (a backlog fails naming its tenant), every
   query is replied, the arms fold the same events per tenant, and every
   defer or shed decision names an aggressor other than its victim with
   ``blame_ms`` > 0 and the blame row attached; the breach ratios, p99s,
   offdiag ratios and decision counts are printed, not judged.  (c)
   ``rb:reach`` first in the fold order and ``ex:exact`` after it, every
   dispatch timed, the controller built on the host's ledger with burns
   scripted by control step and the step as its clock: a breach then
   health (the defer at priming plus ``breach_ticks`` naming rb by the
   card-measured matrix, equal to ``ledger.aggressor_for("ex")``; rb's
   folds and queue held under the gate; the release after
   ``healthy_ticks``; rb's planes after the drain equal the reach engine
   alone's), then a breach that persists (the shed after
   ``escalate_ticks``; offered = folded + shed + dropped per tenant);
   the decisions in ``metrics.jsonl`` and in a flight-recorder dump.
   (d) ``python -m streambench_tpu_torch.engine --tenants
   ex:exact,se:session,rc:reach --catchup`` over a topic of the
   journal's first 100,000 events, beside (c) and ended before (a)
   and (b): exit 0, ``"engine": "multitenant"``, ``partition_ok``, each
   tenant's ``events`` the topic's.

Each kernel's launches are counted over each of phases 4, 6-23, from 0
just before the phase's run to just after it (phases 9-11 and 13 run the
engine in its own process, which reports them in its stats line).  The
line before the nvidia-smi line is ``{"kernels": [...]}``; the last line
is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--events N] [--out FILE]
    python3 chip_smoke.py --only-sketches  # phases 1-3 and 15 alone
    python3 chip_smoke.py --only-session   # phases 1-3 and 16 alone
    python3 chip_smoke.py --only-sharded-sketches  # 1-3, 15, 16 and 18
    python3 chip_smoke.py --only-reach     # phases 1-3 and 19 alone
    python3 chip_smoke.py --only-fleet     # phases 1-3 and 20 alone
    python3 chip_smoke.py --only-hllx-reach  # phases 1-3, 15, 19 and 21
    python3 chip_smoke.py --only-microbatch-dims  # phases 1-3 and 22
    python3 chip_smoke.py --only-tenants   # phases 1-3 and 23 alone
    python3 chip_smoke.py --only-sharded-ranks  # phases 1-3 and 17 (d)
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
# phases 9, 10 and 13: (rate ev/s, seconds) of the paced load (5 s each,
# not 15 s: 10 went to 5 s to pay for phase 22, 9 and 13 to pay for 23)
PACED_LOAD = (100_000, 5)
KAFKA_LOAD = (10_000, 5)
PACED_DECODE_LOAD = (100_000, 5)
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
CHAOS_EVENTS = 500_000
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
# snapshot, one right after the next snapshot of the resumed attempt.
# Each attempt meets a checkpoint at the latest when it ends, so all
# three land whatever the card's speed (a third crash at "batch 40" did
# not once an attempt folded the journal's rest before its first 2 s
# snapshot).  A resumed attempt that crashes between snapshots, so the
# next restores and replays what was not snapshotted, needs a snapshot
# before the journal's end, which a wall-clock cadence cannot promise:
# tests/test_torch_chaos_recovery.py covers it on the CPU, with a
# checkpoint after every batch
# (test_chip_smoke_phase14_runs_on_the_cpu runs this run's code under
# "batch 3, checkpoint 1, batch 2" and checks the store;
# test_jax_crash_snapshot_resumed_by_port_supervisor resumes a snapshot
# and crashes at batch 4)
CHAOS_CONFIG5_SCRIPT = (("batch", 30), ("checkpoint", 1), ("checkpoint", 1))
CHAOS_KAFKA_SCRIPT = (("batch", 3), ("flush", 1), ("batch", 2))
# the smoke's (c) snapshots config #5's 256 MB plane at most every 2 s of
# wall clock, not after every flush (11 snapshots, 27.8 s of snapshot and
# save on one H100): the cut that pays for phase 22
CHAOS_CONFIG5_KEYS = {"jax.checkpoint.interval.ms": 2000}
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
    # the micro-batch mode's window fold: the stock window.size 5000 over
    # map.partitions 3, one partition's window on a [C, 1] plane
    ("micro-batch window fold [100, 1]: one partition's 1,666-row window "
     "of the stock 5000 / 3, a third of the rows views", 1666, 100, 1,
     "mbwindow"),
    # the dimension fold's presence plane at the Apex generator's 1M
    # campaigns (DimensionTupleGenerateOperator.java:16) in 2^20 keys
    ("dimension step [2^20, 16]: 8192 rows, keys uniform over 1M "
     "campaigns", 8192, 1 << 20, 16, "dims"),
)
# the phase 15 dataset: the stock topology (conf/benchmarkConf.yaml),
# 500,000 events 10 ms apart, its own seed (run (d) crashes half way)
STORE_SAMPLE = 10_000             # windows phases 17 and 18 (b) read back
SKETCH_EVENTS = 500_000
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
# journal holds 20 s of the stream, 100 events a millisecond, then a tail
# of SESSION_TAIL_EVENTS events of SESSION_TAIL_USERS users not seen
# before, starting gap + lateness + 1 s past the body, so that every
# session of the body expires by the watermark inside the run
SESSION_EVENTS = 2_000_000
SESSION_TAIL_EVENTS = 20_000
SESSION_TAIL_USERS = 2_000
SESSION_RATE = 100_000
SESSION_USERS = max(50_000, 4 * SESSION_RATE)
SESSION_GAP_MS = 5_000
SESSION_SEED = 16
SESSION_TWO_STAGE_EVENTS = 500_000
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
    elif kind == "mbwindow":
        # the gather-join's campaigns of generator rows (ads uniform, ten
        # a campaign), all in slot 0; a third of the rows are views
        camp = rng.integers(0, C, n, dtype=np.int32)
        return camp, np.zeros(n, np.int32), rng.random(n) < 1 / 3, offset
    elif kind == "dims":
        # the synthetic source's keys, uniform over 1M campaigns interned
        # in first-seen order into 2^20 keys, 10 us apart (one 10 s
        # bucket of the ring), every row counted
        camp = rng.integers(0, 1_000_000, n, dtype=np.int32)
        t0 = int(rng.integers(0, 10_000_000))
        slot = ((t0 + np.arange(n) // 100) // 10_000 % W).astype(np.int32)
        return camp, slot, np.ones(n, bool), offset
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


def _store_windows(r, campaigns=None) -> dict:
    """``(campaign, window_ts) -> seen_count`` of every window in a store
    (or of ``campaigns``' windows): one HGETALL per campaign, one HGET per
    window."""
    out = {}
    if campaigns is None:
        campaigns = r.execute("SMEMBERS", "campaigns")
    for campaign in campaigns:
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
               STOP_STATS_GRACE="2.5", VERIFY="1")
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
    Returns the result and the windows of a seeded sample of campaigns,
    which phase 17 holds its rows against."""
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
    oracle, expected = _digest_oracle(r, workdir, cfg.jax_time_divisor_ms,
                                      mapping=mapping)
    result.update(oracle)
    print(f"[config5] oracle {json.dumps(result['windows_checked'])} "
          f"windows exact (the store's digest) in "
          f"{result['oracle_s']:.2f} s", flush=True)
    if stats.events != events or engine.dropped:
        raise AssertionError(f"folded {stats.events} of {events}, "
                             f"dropped {engine.dropped}")
    if not any(c.get("rows_compact") for c in checked):
        raise AssertionError(f"no rows_compact drain ran under the "
                             f"sync check: {checked}")
    if launches <= 0:
        raise AssertionError("the count kernel never launched on the "
                             "config #5 path")
    record, windows = _config5_record(data, r, expected)
    result.update(record)
    return result, windows


def _digest_oracle(r, workdir: str, divisor_ms: int,
                   mapping: dict | None = None) -> tuple[dict, dict]:
    """The oracle without reading the store back: the journal's exact
    windows (``gen.dostats``) as a window digest (``window_digest_of``:
    the windows, the total of their counts and an order-independent
    digest of (campaign, window, count)) against the store's own digest.
    A window missing, extra, moved or miscounted changes it.  Returns the
    result and the exact windows, ``(campaign, window_ts) -> count``.
    ``mapping`` is the ad -> campaign map where the caller holds it (else
    the workdir's file is read).  (``gen.check_correct``'s read-back of
    1,000,000 campaigns, one HGETALL each, went to pay for phase 21.)"""
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.io.fakeredis import window_digest_of

    t0 = time.perf_counter()
    expected = {(c, b * divisor_ms): n
                for c, per in gen.dostats(workdir, divisor_ms,
                                          mapping=mapping).items()
                for b, n in per.items()}
    want = window_digest_of((c, str(ts), n)
                            for (c, ts), n in expected.items())
    got = _store_digest(r)
    out = {"windows_checked": want["windows"], "oracle_digest": want,
           "oracle_s": time.perf_counter() - t0}
    if got != want:
        raise AssertionError(f"oracle: the store's windows {got} against "
                             f"the journal's {want}")
    return out, expected


def _store_digest(r) -> dict:
    """The store's whole-store window digest (``window_digest``: windows,
    total of counts, digest), one native call."""
    return getattr(r, "_store", r).window_digest()


def _config5_record(data: Config5Data, r, expected: dict
                    ) -> tuple[dict, dict]:
    """What phase 17 holds its stores to, from phase 6's oracle-checked
    store: its window digest, whose total must be the journal's views
    (every view joins and none is dropped), and the windows of a seeded
    tenth of the campaigns, ~33,000 windows, read back and held to the
    journal's exact windows ``expected`` (the whole store's read went to
    pay for phase 19)."""
    from streambench_tpu_torch.datagen import gen

    t0 = time.perf_counter()
    out = {"store_digest": _store_digest(r)}
    out["store_digest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sample = random.Random(19).sample(list(data.campaigns),
                                      len(data.campaigns) // 10)
    windows = _store_windows(r, sample)
    out["store_read_s"] = time.perf_counter() - t0
    out["store_read_windows"] = len(windows)
    sample = set(sample)
    want = {k: n for k, n in expected.items() if k[0] in sample}
    if windows != want:
        raise AssertionError(f"[config5] {len(windows)} windows read back "
                             f"against the journal's {len(want)} for the "
                             "sampled campaigns")
    with open(os.path.join(data.workdir, gen.KAFKA_JSON_FILE), "rb") as f:
        out["views"] = f.read().count(b'"event_type": "view"')
    if out["store_digest"]["seen"] != out["views"]:
        raise AssertionError(f"[config5] the store counts "
                             f"{out['store_digest']} against "
                             f"{out['views']} views in the journal")
    return out, windows


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


def _chaos_config5(data: Config5Data, device: str,
                   check: bool = True, keys: dict | None = None) -> dict:
    """Phase 14 (c): config #5's key space (phase 6's dataset) under a
    crash script with a checkpoint crash.  The store is not wrapped: the
    plan has no sink faults, so the native bulk writeback stays.
    ``check`` holds the store to ``check_at_least_once`` over the journal
    (51.4 s on the card, PR 11 call 11); the smoke's full run leaves it
    to this rehearsal on the CPU, and phase 17 holds config #5's rows to
    phase 6's oracle-checked store on the card.  ``keys`` adds config
    keys (the smoke's ``CHAOS_CONFIG5_KEYS``)."""
    from streambench_tpu_torch.chaos import FaultPlan, check_at_least_once
    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner

    cfg = data.config(dict(CHAOS_SINK_RETRY, **(keys or {})))
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
    v = None
    if check:
        v = check_at_least_once(r, data.workdir,
                                data.broker.topic_path(cfg.kafka_topic),
                                st.replay_segments, st.carried)
        rec["verdict"] = _chaos_verdict(v)
    else:
        rec["verdict"] = "not checked in this run (the smoke's cut)"
    rec["check_s"] = time.perf_counter() - t0
    print(f"[chaos_config5] {json.dumps(rec)}", flush=True)
    if v is not None and not (v.ok and v.windows > 0):
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
                device: str = "cuda", check_config5: bool = True,
                config5_keys: dict | None = None) -> dict:
    """Phase 14: supervised chaos (see the module doc).  ``device`` and
    the sizes are arguments so the phase can be rehearsed on the CPU at a
    small size; the smoke runs it on ``cuda`` at full size, without (c)'s
    at-least-once check (``check_config5``) and with (c)'s checkpoints
    spaced by ``config5_keys``."""
    t0 = time.perf_counter()
    out = _chaos_journal_runs(events, device)
    out["config5"] = _chaos_config5(config5, device, check_config5,
                                    config5_keys)
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


def _sketch_engine(kind: str, cfg, data: Config5Data, r, device: str,
                   mesh=None):
    """Phase 15's engine of ``kind`` ("hll", "sliding" or phase 21's
    "hllx"), or with ``mesh`` its sharded form (phase 18)."""
    from streambench_tpu_torch.engine.sketches import (
        HLLDistinctEngine,
        HLLXEngine,
        SlidingTDigestEngine,
    )
    from streambench_tpu_torch.parallel import (
        ShardedHLLEngine,
        ShardedSlidingTDigestEngine,
    )

    if kind == "hllx":                    # phase 21; no sharded form
        return HLLXEngine(cfg, data.mapping, campaigns=data.campaigns,
                          redis=r, device=device)
    if mesh is not None:
        cls = (ShardedHLLEngine if kind == "hll"
               else ShardedSlidingTDigestEngine)
        return cls(cfg, data.mapping, mesh, campaigns=data.campaigns,
                   redis=r, device=device)
    cls = HLLDistinctEngine if kind == "hll" else SlidingTDigestEngine
    return cls(cfg, data.mapping, campaigns=data.campaigns, redis=r,
               device=device)


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _reset_peak(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(device: str):
    """The fullest device memory since ``_reset_peak`` (bytes), or "not
    measured" off the card."""
    import torch

    if device == "cuda":
        return torch.cuda.max_memory_allocated()
    return "not measured"


def _sketch_catchup(tag: str, kind: str, data: Config5Data, device: str,
                    keys: dict | None = None, mesh=None,
                    obs_shard: bool = False) -> tuple:
    """One timed catchup of the dataset through a fresh sketch engine on
    the card (sharded on ``mesh`` if given, with the shard-skew tracker
    if ``obs_shard``), after a warm engine ran every device path once (as
    the CLI does).  Returns (result, store, engine)."""
    from streambench_tpu_torch.engine import StreamRunner
    from streambench_tpu_torch.ops.count import count_cells

    cfg = data.config(keys)
    warm = _sketch_engine(kind, cfg, data, None, device, mesh)
    warm.warmup()
    warm.close()
    del warm
    r = data.store()
    engine = _sketch_engine(kind, cfg, data, r, device, mesh)
    skew = None
    if obs_shard:
        from streambench_tpu_torch.obs import MetricsRegistry, ShardSkew

        reg = MetricsRegistry()
        skew = ShardSkew(reg, n_shards=1)
        engine.attach_obs(reg, shard=skew)
    reader = data.broker.reader(cfg.kafka_topic)
    _sync(device)
    _reset_peak(device)
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
        "peak_allocated_bytes": _peak(device),
    }
    if kind == "sliding":
        result["sliced"] = engine.sliced
    if skew is not None:
        result["shard_skew"] = skew.summary()
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
    finishes.  Returns (result, store, engine B)."""
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
    return result, r, b


def _sampled_windows_equal(tag: str, r, want: dict, what: str,
                           n: int = STORE_SAMPLE, seed: int = 19) -> int:
    """Hold a seeded sample of ``n`` of ``want``'s windows against the
    store, reading each back (two commands a window) instead of the
    whole store.  Returns the windows compared."""
    sample = random.Random(seed).sample(list(want), min(n, len(want)))
    bad = []
    for campaign, ts in sample:
        key = r.execute("HGET", campaign, str(ts))
        got = None if key is None else r.execute("HGET", key, "seen_count")
        if got is None or int(got) != want[(campaign, ts)]:
            bad.append((campaign, ts, got, want[(campaign, ts)]))
    if bad:
        raise AssertionError(f"[{tag}] {len(bad)} of {len(sample)} sampled "
                             f"windows differ from {what}: {bad[:3]}")
    return len(sample)


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
                   device: str = "cuda", keep: bool = False):
    """Phase 15: BASELINE configs #2 and #3 on the card (module doc).
    ``device`` and the size are arguments so the phase can be rehearsed
    on the CPU at a small size; the smoke runs it on ``cuda``.  With
    ``keep`` it returns ``(result, kept)``: the journal and what phase 18
    holds its sharded runs to (the caller removes the journal)."""
    import numpy as np

    t0 = time.perf_counter()
    out: dict = {"ops": _sketch_ops_check(device)}
    data = Config5Data(events, keys={}, name="smoke_sketch",
                       seed=SKETCH_SEED)
    out.update(events=events, generate_s=data.gen_s)
    kept = None
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
        hll_end = _hll_end_state(hll_eng)
        hll_res.update(_hll_against_cpu(
            got, hll_end, _store_windows(ref_r), _hll_end_state(ref_eng)),
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
        sliced_digest = _store_digest(r)
        sliced_end = {"ids": sl_eng.state.window_ids.cpu().numpy(),
                      "watermark": int(sl_eng.state.watermark),
                      "dropped": int(sl_eng.state.dropped),
                      "counts": int(sl_eng.state.counts.sum())}
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
        res_h, r, _ = _sketch_resume("hll_resume", "hll", data, device)
        _windows_equal("hll_resume", _store_windows(r), hll_windows,
                       "run (a)'s")
        res_s, r, _ = _sketch_resume("sliced_resume", "sliding", data,
                                  device)
        _windows_equal("sliced_resume", _store_windows(r), sliced_windows,
                       "run (b)'s")
        if device == "cuda" and res_s["count_cells_launches"] <= 0:
            raise AssertionError("[sketch_sliced_resume] K1 never launched")
        out["resume"] = {"hll": res_h, "sliced": res_s}
        if keep:
            kept = {"data": data, "clock": clock,
                    "ev": {k: (out[k]["events_per_s"],
                               out[k]["events_per_s_with_close"])
                           for k in ("hll", "sliced")},
                    "views": int(views[0].size), "hll_rows": hll_windows,
                    "hll_end": hll_end, "sliced_rows": sliced_windows,
                    "sliced_digest": sliced_digest,
                    "sliced_end": sliced_end, "sliced_q": q,
                    "sliced_w": weights}
    finally:
        if kept is None:
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
    return (out, kept) if keep else out


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


def _session_engine(data: SessionData, cfg, r, device: str, mesh=None):
    """Phase 16's engine, or with ``mesh`` its sharded form (phase 18)."""
    from streambench_tpu_torch.engine.sketches import SessionCMSEngine
    from streambench_tpu_torch.parallel import ShardedSessionCMSEngine

    kw = dict(campaigns=data.campaigns, redis=r, gap_ms=SESSION_GAP_MS,
              user_capacity=data.capacity, cms_depth=4,
              cms_width=data.cms_width, top_k=16, device=device)
    if mesh is not None:
        return ShardedSessionCMSEngine(cfg, data.mapping, mesh, **kw)
    return SessionCMSEngine(cfg, data.mapping, **kw)


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
                 flush_interval_ms: int | None = None, mesh=None) -> tuple:
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
    warm = _session_engine(data, cfg, None, device, mesh)
    warm.warmup()
    warm.close()
    del warm
    r = as_redis(make_store())
    engine = _session_engine(data, cfg, r, device, mesh)
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
    _reset_peak(device)
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
            engine.scan_batches, "user_capacity": engine.user_capacity,
        "peak_allocated_bytes": _peak(device)}
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
                  cms_width: int = 2048, keep: bool = False):
    """Phase 16: BASELINE config #4 on the card (module doc).  ``device``,
    the sizes and the sketch's width are arguments so the phase can be
    rehearsed on the CPU at a small size (a narrow sketch, so that SALSA
    widens cells there too); the smoke runs it on ``cuda`` at Wd =
    2048.  With ``keep`` it returns ``(result, kept)``: the journal and
    the states of (a) and (b), which phase 18 holds its sharded runs to
    (the caller removes the journal)."""
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
    kept = None
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
            state_b, hh_b = _session_state(eng), eng.heavy_hitters()
            res["cpu_equal_arrays"] = _states_equal(
                "salsa", state_b, _session_state(ref_eng), "the CPU run's")
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
        if keep:
            kept = {"data": data, "clock": clock,
                    "ev": {k: (out[k]["events_per_s"],
                               out[k]["events_per_s_with_close"])
                           for k in ("fixed", "salsa")},
                    "fixed": (state_a, hh_a), "salsa": (state_b, hh_b)}
    finally:
        if kept is None:
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
    return (out, kept) if keep else out


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


RANKS = 2
# --only-sharded-ranks's journal
RANKS_ONLY_EVENTS = 100_000


class _RanksCli:
    """Phase 17 (d): the engine CLI with ``--sharded`` and
    ``jax.mesh.shape: [2]`` over phase 6's journal, one rank a device.
    With fewer cards than ranks it must exit 2 with the refusal that
    names both counts, and start no rank: that process starts at once
    and runs beside the rest of the phase (it touches no card), and
    ``finish`` checks it.  With two cards (or on the CPU, gloo ranks)
    ``finish`` runs the two ranks, which fold the journal into a RESP
    store process whose windows must be phase 6's by the window digest
    (``want_digest``, else the journal's exact windows'); each rank's K1
    launches come from the stats line."""

    def __init__(self, data: Config5Data, device: str = "cuda"):
        import torch
        import yaml

        self.data = data
        with open(os.path.join(REPO, "conf", "benchmarkConf.yaml")) as f:
            conf = yaml.safe_load(f)
        self.port = _free_port()
        conf.update(data.keys, **{"redis.host": "127.0.0.1",
                                  "redis.port": self.port,
                                  "jax.mesh.shape": [RANKS]})
        conf_path = os.path.join(data.workdir, "ranks_conf.yaml")
        with open(conf_path, "w") as f:
            yaml.safe_dump(conf, f)
        self.argv = [sys.executable, "-m", "streambench_tpu_torch.engine",
                     "--confPath", conf_path, "--workdir", data.workdir,
                     "--catchup", "--sharded", "--device", device]
        self.env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.logs = [os.path.join(data.workdir, f"engine.rank{k}.log")
                     for k in range(1, RANKS)]
        self.device = device
        self.cards = torch.cuda.device_count() if device == "cuda" else None
        self.refused = None
        if self.cards is not None and self.cards < RANKS:
            for path in self.logs:
                if os.path.exists(path):
                    os.unlink(path)
            t0 = time.perf_counter()
            self.refused = proc = subprocess.Popen(
                self.argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=self.env, cwd=REPO)
            # the process's own time to its exit, taken while the phase
            # runs on
            self.exit_s = None

            def timed_exit() -> None:
                proc.wait()
                self.exit_s = time.perf_counter() - t0

            self._exited = threading.Thread(target=timed_exit, daemon=True)
            self._exited.start()

    def finish(self, want_digest: dict | None) -> dict:
        if self.refused is not None:
            return self._refusal()
        return self._run(want_digest)

    def _refusal(self) -> dict:
        proc, cards = self.refused, self.cards
        try:
            _, err = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        self._exited.join(timeout=10)
        out = {"multi_rank": f"refused: {RANKS} ranks, {cards} card"
                             + ("" if cards == 1 else "s"),
               "exit_code": proc.returncode, "refusal_s": self.exit_s}
        print(f"[sharded_ranks] {json.dumps(out)}", flush=True)
        words = (f"error: --sharded over {RANKS} ranks: {RANKS} ranks on "
                 f"cuda need {RANKS} cards, one a rank; this host has "
                 f"{cards}")
        if proc.returncode != 2 or words not in err:
            raise AssertionError(f"sharded ranks: {RANKS} ranks on {cards} "
                                 f"card(s) were not refused by name: rc "
                                 f"{proc.returncode}, {err[-2000:]}")
        if any(os.path.exists(p) for p in self.logs):
            raise AssertionError("sharded ranks: a rank started before the "
                                 "refusal")
        return out

    def _run(self, want_digest: dict | None) -> dict:
        from streambench_tpu_torch.io.fakeredis import window_digest_of
        from streambench_tpu_torch.io.redis_schema import read_seen_counts

        data = self.data
        server = subprocess.Popen(
            [sys.executable, "-m", "streambench_tpu_torch.io.fakeredis",
             "--host", "127.0.0.1", "--port", str(self.port)],
            env=self.env, cwd=REPO, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        try:
            r = _await_resp(self.port)
            for i in range(0, len(data.campaigns), 10_000):
                r.execute("SADD", "campaigns",
                          *data.campaigns[i:i + 10_000])
            t0 = time.perf_counter()
            proc = subprocess.run(self.argv, capture_output=True, text=True,
                                  timeout=900, env=self.env, cwd=REPO)
            cli_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"sharded ranks: the CLI exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-3000:]}")
            lines = proc.stdout.strip().splitlines()
            stats = json.loads(lines[-1])
            t0 = time.perf_counter()
            digest = window_digest_of(
                (c, str(ts), n) for c, per in read_seen_counts(r).items()
                for ts, n in per.items())
            out = {"multi_rank": f"ran: {RANKS} ranks",
                   "engine_up": next(ln for ln in lines
                                     if ln.startswith("engine up:")),
                   "events": stats["events"], "dropped": stats["dropped"],
                   "events_per_s": stats["events_per_s"], "cli_s": cli_s,
                   "count_cells_launches_by_rank": [
                       stats["kernel_launches"]["count_cells"]] + [
                       (f["kernel_launches"] or {}).get("count_cells")
                       for f in stats["followers"]],
                   "follower_exit_codes": [f["exit_code"]
                                           for f in stats["followers"]],
                   "store_digest": digest,
                   "store_read_s": time.perf_counter() - t0}
        finally:
            server.kill()
            server.communicate()
        print(f"[sharded_ranks] {json.dumps(out)}", flush=True)
        if stats["events"] != data.events or stats["dropped"]:
            raise AssertionError(f"sharded ranks: folded {stats['events']} "
                                 f"of {data.events}, dropped "
                                 f"{stats['dropped']}")
        if out["follower_exit_codes"] != [0] * (RANKS - 1):
            raise AssertionError(f"sharded ranks: a rank exited "
                                 f"{out['follower_exit_codes']}")
        if self.device == "cuda" and not all(
                n and n > 0 for n in out["count_cells_launches_by_rank"]):
            raise AssertionError(f"sharded ranks: the count kernel did not "
                                 f"launch on every rank: "
                                 f"{out['count_cells_launches_by_rank']}")
        if want_digest is None:
            want_digest = _journal_digest(data)
        if digest != want_digest:
            raise AssertionError(f"sharded ranks: the store's windows "
                                 f"{digest} are not phase 6's "
                                 f"{want_digest}")
        return out


def _await_resp(port: int):
    """A client of the RESP store process on ``port``, once it answers."""
    from streambench_tpu_torch.io.resp import RespClient

    for _ in range(200):
        try:
            r = RespClient("127.0.0.1", port)
            r.ping()
            return r
        except OSError:
            time.sleep(0.05)
    raise AssertionError("the RESP store process did not start")


def _journal_digest(data: Config5Data) -> dict:
    """The window digest of the journal's exact windows (``gen.dostats``)."""
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.io.fakeredis import window_digest_of

    divisor = data.config().jax_time_divisor_ms
    return window_digest_of(
        (c, str(b * divisor), n)
        for c, per in gen.dostats(data.workdir, divisor,
                                  mapping=data.mapping).items()
        for b, n in per.items())


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
    ranks_cli = _RanksCli(data, device)
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
            # the whole store against phase 6's: windows, total, digest
            res["store_digest"] = _store_digest(r)
            if skew is not None:
                # the stats arm's run is held by its routed rows below;
                # reading a 1e6-campaign store again costs ~15 s
                res["shard_skew"] = skew.summary()
            else:
                # a seeded sample of phase 6's oracle-checked windows, read
                # back (the whole store's read, 19 s, paid for phase 19)
                t0 = time.perf_counter()
                res["windows_equal_phase6_sampled"] = _sampled_windows_equal(
                    f"sharded_{run}", r, want, "phase 6's")
                res["store_read_s"] = time.perf_counter() - t0
            print(f"[sharded_{run}] {json.dumps(res)}", flush=True)
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
            if res["store_digest"] != unsharded["store_digest"]:
                raise AssertionError(
                    f"sharded {run}: the store's windows "
                    f"{res['store_digest']} are not phase 6's "
                    f"{unsharded['store_digest']}")
            if skew is not None and res["shard_skew"]["rows"] != [
                    unsharded["views"]]:
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
    out["multi_rank"] = ranks_cli.finish(unsharded["store_digest"])
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
          f"{out['obs_shard']['shard_skew']}; over {RANKS} ranks "
          f"{out['multi_rank']['multi_rank']}, "
          f"{out['multi_rank'].get('events_per_s', 'not run')} ev/s, K1 "
          f"launches by rank "
          f"{out['multi_rank'].get('count_cells_launches_by_rank', 'not run')}",
          flush=True)
    return out


# ----------------------------------------------------------------------
# phase 18: the sharded sketch engines (M16b) on a (1, 1) mesh

SHARDED_SKETCH_RUNS = ("hll", "hll_obs_shard", "sliced", "fixed", "salsa")


def _sharded_collectives(engine, on_card: bool) -> dict:
    """An engine's collective report (ops and bytes a dispatch by kind),
    each collective bracketed by CUDA events, three times for the median
    device ms; and on the card the NCCL kernels' device ms and the c10d
    calls' host ms a dispatch under ``torch.profiler`` (5 x a step and a
    1-batch scan)."""
    import statistics

    t0 = time.perf_counter()
    reports = [engine.collective_report(timed=on_card)
               for _ in range(COLLECTIVE_REPEATS)]
    rep = reports[-1]
    for kernel in ("step", "scan"):
        rep[kernel]["device_ms_median"] = (
            statistics.median(r[kernel]["device_ms"] for r in reports)
            if on_card else "not measured")
    out = {"collectives": rep}
    if on_card:
        k = _collective_kernels(engine, repeats=5)
        out["collective_kernels"] = {key: k[key] for key in (
            "dispatches", "device_ms_per_dispatch", "host_ms_per_dispatch")}
    out["collectives_s"] = time.perf_counter() - t0
    return out


def _collective_line(res: dict) -> str:
    c = res["collectives"]
    k = res.get("collective_kernels", {})
    return (f"step {c['step']['per_dispatch']['by_kind']} "
            f"{c['step']['per_dispatch']['bytes']} B "
            f"{c['step']['device_ms_median']} ms, scan "
            f"{c['scan']['per_dispatch']['by_kind']} "
            f"{c['scan']['per_dispatch']['bytes']} B "
            f"{c['scan']['device_ms_median']} ms between CUDA events, "
            f"NCCL kernels {k.get('device_ms_per_dispatch', 'not measured')}"
            f" ms a dispatch")


def phase_sharded_sketches(sk: dict, ses: dict, device: str = "cuda",
                           keep_sketch: bool = False) -> dict:
    """Phase 18 (module doc): the sharded sketch engines on a ``(1, 1)``
    mesh over phase 15's and 16's journals, held to those phases' card
    results (``sk``, ``ses``: what they kept).  Removes both journals,
    phase 15's only on failure with ``keep_sketch`` (phase 21 folds it
    again).  ``device`` is an argument so the phase can be rehearsed on
    the CPU (gloo, against CPU results)."""
    import numpy as np
    import torch.distributed as dist

    from streambench_tpu_torch.parallel import build_mesh

    on_card = device == "cuda"
    t0 = time.perf_counter()
    out: dict = {}
    try:
        mesh = build_mesh(1, 1, device=device)
        out.update(mesh=repr(mesh), backend=mesh.backend)
        data = sk["data"]
        # (a) HLL, plain and with jax.obs.shard
        for run in ("hll", "hll_obs_shard"):
            obs = run == "hll_obs_shard"
            res, r, eng = _sketch_catchup(
                f"sharded_{run}", "hll", data, device, mesh=mesh,
                obs_shard=obs)
            t1 = time.perf_counter()
            if not obs:
                # the stats arm folds the same registers (checked below)
                _windows_equal(run, _store_windows(r), sk["hll_rows"],
                               "phase 15 (a)'s")
                res["windows_equal_phase15"] = len(sk["hll_rows"])
            end, want = _hll_end_state(eng), sk["hll_end"]
            if (set(end["registers"]) != set(want["registers"])
                    or not all(np.array_equal(end["registers"][w],
                                              want["registers"][w])
                               for w in want["registers"])
                    or (end["watermark"], end["dropped"])
                    != (want["watermark"], want["dropped"])):
                raise AssertionError(f"[sharded_{run}] state after close() "
                                     "differs from phase 15 (a)'s")
            if res["count_cells_launches"]:
                raise AssertionError(f"[sharded_{run}] K1 launched")
            if obs and res["shard_skew"]["rows"] != [sk["views"]]:
                raise AssertionError(f"[sharded_{run}] routed rows "
                                     f"{res['shard_skew']} against "
                                     f"{sk['views']} views")
            res["check_s"] = time.perf_counter() - t1
            res.update(_sharded_collectives(eng, on_card and not obs))
            out[run] = res
            del eng, r
        # (b) the sliced sliding fold (K1 on the [Cl*S, W] plane) under
        # phase 15 (b)'s clock
        with _sketch_clock(sk["clock"]):
            res, r, eng = _sketch_catchup("sharded_sliced", "sliding", data,
                                          device, mesh=mesh)
        t1 = time.perf_counter()
        # the whole store's digest and a seeded sample of 15 (b)'s
        # windows (the whole store's read, 11.9 s, paid for phase 19)
        res["store_digest"] = _store_digest(r)
        if res["store_digest"] != sk["sliced_digest"]:
            raise AssertionError(
                f"[sketch_sharded_sliced] the store's windows "
                f"{res['store_digest']} are not 15 (b)'s "
                f"{sk['sliced_digest']}")
        res["windows_equal_phase15_sampled"] = _sampled_windows_equal(
            "sharded_sliced", r, sk["sliced_rows"], "phase 15 (b)'s")
        st, want = eng.state, sk["sliced_end"]
        if (not np.array_equal(st.window_ids.cpu().numpy(), want["ids"])
                or (int(st.watermark), int(st.dropped),
                    int(st.counts.sum()))
                != (want["watermark"], want["dropped"], want["counts"])):
            raise AssertionError("[sharded_sliced] ring, watermark or "
                                 "dropped differ from phase 15 (b)'s")
        q = eng.quantiles()
        weights = eng._whole()[1].weights.sum(1).cpu().numpy()
        res["quantile_max_rel_err_phase15"] = _quantiles_against_cpu(
            "sharded_sliced", q, weights, sk["sliced_q"], sk["sliced_w"])
        if not eng.sliced or (on_card and res["count_cells_launches"] <= 0):
            raise AssertionError(f"[sharded_sliced] sliced={eng.sliced}, "
                                 f"K1 launches "
                                 f"{res['count_cells_launches']}")
        res["check_s"] = time.perf_counter() - t1
        res.update(_sharded_collectives(eng, on_card))
        out["sliced"] = res
        del eng, r
        if not keep_sketch:
            data.remove()                 # phase 15's journal is done
        # (c) fixed and (d) SALSA over phase 16's journal, held to its
        # (a) and (b); K3's update and query (never the fused entry the
        # single-device fold takes) for fixed, its columns for SALSA
        sdata, once = ses["data"], 10**9
        with _sketch_clock(ses["clock"]):
            for fam, keys, entries in (
                    ("fixed", None, ("cms_update", "cms_query")),
                    ("salsa", {"jax.cms.mode": "salsa"}, ("cms_cols",))):
                res, eng, r = _session_run(f"sharded_{fam}", sdata, device,
                                           keys, flush_interval_ms=once,
                                           mesh=mesh)
                t1 = time.perf_counter()
                res.update(_session_checks(f"sharded_{fam}", sdata, res, eng,
                                           r, entries, device))
                res.update(_expiry_check(f"sharded_{fam}", sdata, res, eng,
                                         ses["clock"]))
                state, hh = ses[fam]
                res["equal_arrays_phase16"] = _states_equal(
                    f"sharded_{fam}", _session_state(eng), state,
                    "phase 16's")
                if eng.heavy_hitters() != hh:
                    raise AssertionError(f"[sharded_{fam}] heavy hitters "
                                         "differ from phase 16's")
                if res["cms_rows_launches"]["cms_update_query"]:
                    raise AssertionError(f"[sharded_{fam}] the fused "
                                         "update and query launched")
                res["check_s"] = time.perf_counter() - t1
                res.update(_sharded_collectives(eng, on_card))
                out[fam] = res
                del eng, r
            # (e) the two-stage sketch does not merge: refused
            try:
                _session_engine(sdata, sdata.config({"jax.cms.stages": 2}),
                                None, device, mesh)
            except ValueError as e:
                out["two_stage_refused"] = str(e)
            else:
                raise AssertionError("[sharded] the two-stage sketch was "
                                     "not refused")
    except BaseException:
        sk["data"].remove()
        raise
    finally:
        if not keep_sketch:
            sk["data"].remove()
        ses["data"].remove()
        if dist.is_initialized():
            dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t0
    unsharded = {**sk["ev"], **ses["ev"], "hll_obs_shard": sk["ev"]["hll"]}
    print(f"[sharded_sketch] ev/s (with close) on the (1, 1) "
          f"{out['backend']} mesh [phases 15 and 16]: " + "; ".join(
              f"{run} {out[run]['events_per_s']} "
              f"({out[run]['events_per_s_with_close']}) "
              f"[{unsharded[run][0]} ({unsharded[run][1]})]"
              for run in SHARDED_SKETCH_RUNS)
          + f"; K1 launches sliced {out['sliced']['count_cells_launches']}"
          f", K3 fixed {out['fixed']['cms_rows_launches']}, salsa "
          f"{out['salsa']['cms_rows_launches']}; peak device memory "
          + ", ".join(f"{run} {out[run]['peak_allocated_bytes']}"
                      for run in SHARDED_SKETCH_RUNS)
          + f"; {out['phase_s']:.1f} s", flush=True)
    for run in SHARDED_SKETCH_RUNS:
        print(f"[sharded_{run}] collectives: "
              f"{_collective_line(out[run])}", flush=True)
    return out


# ----------------------------------------------------------------------
# phase 19: reach serving (M13a) on the card

# the reference reach benchmark's "large" rung (bench_reach.py:2262-2285)
REACH_CAMPAIGNS = 100              # x 10 ads each
REACH_USERS = 130_000
REACH_EVENTS = 600_000
REACH_SPACING_MS = 10
REACH_K = 256
REACH_R = 1024
REACH_BATCH = 8192
REACH_QUERIES = 512
REACH_SEED = 23
REACH_STORM = {"queries_n": 1200, "clients": 6, "depth": 2048,
               "batch": 256, "expect_shed": False}
REACH_SHED = {"queries_n": 300, "clients": 2, "depth": 64, "batch": 64,
              "expect_shed": True}
REACH_PROFILE_EVENTS = 4 * 8 * REACH_BATCH   # four packed-scan dispatches
REACH_TIMED_CALLS = 50
REACH_PROFILED_CALLS = 10
REACH_LIVE_EVENTS = 100_000       # (d): the second journal
REACH_LIVE_USERS = 20_000         # ... over devices (a) never saw
REACH_LIVE_QUERIES = 400
REACH_CLI_QUERIES = 64
REACH_CLI_R = 256                 # the CLI's engine: registers=256
# (e): a tail appended to the topic over the ads of a few campaigns, three
# catchup chunks long, so that with a flush and a ship at every chunk
# the chunks that hold only the tail ship as deltas
REACH_TAIL_EVENTS = 3 * 8 * REACH_BATCH
REACH_TAIL_USERS = 20_000
REACH_TAIL_CAMPAIGNS = 5
REACH_FINAL_QUERIES = 64          # (d): asked after the last push


class ReachData:
    """Phase 19's journal in the reference reach benchmark's shape
    (``bench_reach.py:make_world``): C campaigns x 10 ads, a universe of
    ``users`` devices, ``events`` generator events 10 ms apart, written
    to a broker topic, with the id and map files the engine CLI reads.
    ``extra(n, users, seed)`` writes a second journal over the same ads
    and new devices, ``tail(...)`` appends one over a few campaigns' ads
    to the main topic."""

    def __init__(self, events: int, campaigns: int, users: int, seed: int,
                 name: str = "smoke_reach"):
        from streambench_tpu_torch.datagen import gen
        from streambench_tpu_torch.io.journal import FileBroker
        from streambench_tpu_torch.utils.ids import make_ids

        self.workdir = _workdir(name)
        self.events = events
        t0 = time.perf_counter()
        rng = random.Random(seed)
        self.campaigns = make_ids(campaigns, rng)
        self.ads = make_ids(campaigns * 10, rng)
        self.mapping = {a: self.campaigns[i // 10]
                        for i, a in enumerate(self.ads)}
        gen.write_ids(self.campaigns, self.ads, self.workdir)
        gen.write_ad_mapping_file(self.campaigns, self.ads, self.workdir)
        self.broker = FileBroker(os.path.join(self.workdir, "broker"))
        self.journal = self._write(self.config().kafka_topic, events,
                                   users, rng)
        self.tail_path: str | None = None     # 19 (e)'s, once appended
        self.gen_s = time.perf_counter() - t0

    def _write(self, topic: str, events: int, users: int, rng,
               start: int = 1_700_000_000_000, ads: list | None = None,
               name: str | None = None, append: bool = False) -> str:
        import numpy as np

        from streambench_tpu_torch.datagen import gen
        from streambench_tpu_torch.utils.ids import make_ids

        src = gen.EventSource(ads=ads or self.ads,
                              user_ids=make_ids(users, rng),
                              page_ids=make_ids(100, rng), rng=rng)
        path = os.path.join(self.workdir, f"{name or topic}.journal.txt")
        with open(path, "wb") as f, self.broker.writer(
                topic, append=append) as w:
            for base in range(0, events, 100_000):
                ts = start + REACH_SPACING_MS * np.arange(
                    base, min(base + 100_000, events), dtype=np.int64)
                blob = src.events_blob_at(ts)
                if blob is None:
                    blob = b"".join(src.event_at(int(t)).encode() + b"\n"
                                    for t in ts)
                f.write(blob)
                w.append_bytes(blob)
        return path

    def extra(self, topic: str, events: int, users: int, seed: int) -> str:
        return self._write(topic, events, users, random.Random(seed))

    def tail(self, events: int, users: int, seed: int,
             campaigns: int) -> str:
        """Append ``events`` events (new devices, later times) over the
        ads of the first ``campaigns`` campaigns to the main topic;
        returns the tail's own journal file."""
        return self._write(
            self.config().kafka_topic, events, users, random.Random(seed),
            start=1_700_000_000_000 + REACH_SPACING_MS * self.events,
            ads=self.ads[:10 * campaigns], name="tail", append=True)

    def sets(self, *paths) -> dict:
        """Exact device sets per campaign over the journals (the oracle's
        ``campaign_user_sets``, one pass each)."""
        from streambench_tpu_torch.reach import oracle as ro

        out = {c: set() for c in self.campaigns}
        for path in paths:
            with open(path, "rb") as f:
                for c, s in ro.campaign_user_sets(
                        f, self.mapping, self.campaigns).items():
                    out[c] |= s
        return out

    def config(self, keys: dict | None = None):
        return _config(self.workdir, {"jax.batch.size": REACH_BATCH,
                                      **(keys or {})})

    def remove(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def _reach_engine(data: ReachData, cfg, r, device: str, k: int = REACH_K,
                  registers: int = REACH_R):
    from streambench_tpu_torch.engine.sketches import ReachSketchEngine

    return ReachSketchEngine(cfg, data.mapping, campaigns=data.campaigns,
                             redis=r, k=k, registers=registers,
                             device=device)


def _reset_launches() -> None:
    from streambench_tpu_torch.ops import cmsrows
    from streambench_tpu_torch.ops.count import count_cells
    from streambench_tpu_torch.ops.decode import decode_rows

    count_cells.launches = 0
    decode_rows.launches = 0
    cmsrows.reset_launches()


def _launches() -> dict:
    from streambench_tpu_torch.ops import cmsrows
    from streambench_tpu_torch.ops.count import count_cells
    from streambench_tpu_torch.ops.decode import decode_rows

    return {"count_cells": count_cells.launches,
            "decode_rows": decode_rows.launches,
            "cms_rows": cmsrows.kernel_launches()}


def _planes_equal(tag: str, engine, mins, regs) -> None:
    import numpy as np

    p = engine.planes()
    if not (np.array_equal(p["mins"], mins)
            and np.array_equal(p["registers"], regs)):
        bad = int((p["mins"] != mins).any(1).sum()
                  + (p["registers"] != regs).any(1).sum())
        raise AssertionError(f"[reach_{tag}] planes differ from the "
                             f"oracle's in {bad} campaign rows")


def _scan_profile(tag: str, engine, reader, device: str,
                  events: int) -> dict:
    """The device operations and device ms one packed-scan dispatch of
    ``engine``'s fold launches, under ``torch.profiler`` over the first
    ``events`` events of ``reader`` (no flush inside), after a warmup."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from streambench_tpu_torch.engine import StreamRunner

    engine.warmup()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        stats = StreamRunner(engine, reader, flush_interval_ms=10**9
                             ).run_catchup(max_events=events)
        _sync(device)
    reader.close()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda x: -x[2])
    scans = engine.tracer.as_dict().get("device_scan", {}).get("calls", 0)
    batches = -(-stats.events // engine.batch_size)
    ops = sum(c for _, c, _ in rows)
    out = {"events": stats.events, "batches": batches, "dispatches": scans,
           "device_ops": ops,
           "device_ops_per_dispatch": ops / max(scans, 1),
           "device_ops_per_batch": ops / max(batches, 1),
           "device_ms_per_dispatch": (sum(t for _, _, t in rows) / 1e3
                                      / max(scans, 1)) if rows
           else "not measured",
           "top_device_ops": [{"name": k[:80], "count": c,
                               "device_ms": t / 1e3}
                              for k, c, t in rows[:8]]}
    print(f"[{tag}] {json.dumps(out)}", flush=True)
    return out


def _reach_profile(data: ReachData, device: str) -> dict:
    """X6's numbers: one packed-scan dispatch of the reach fold under the
    profiler, over the first REACH_PROFILE_EVENTS events."""
    cfg = data.config()
    return _scan_profile("reach_profile",
                         _reach_engine(data, cfg, None, device),
                         data.broker.reader(cfg.kafka_topic), device,
                         REACH_PROFILE_EVENTS)


def _reach_catchup(data: ReachData, device: str) -> tuple:
    """19 (a): the timed catchup on a fresh engine after a warm one ran
    every device path.  Returns (result, engine, store)."""
    from streambench_tpu_torch.engine import StreamRunner
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.redis_schema import as_redis

    cfg = data.config()
    warm = _reach_engine(data, cfg, None, device)
    warm.warmup()
    warm.close()
    del warm
    r = as_redis(make_store())
    engine = _reach_engine(data, cfg, r, device)
    reader = data.broker.reader(cfg.kafka_topic)
    _sync(device)
    _reset_peak(device)
    _reset_launches()                     # this path starts here
    t0 = time.perf_counter()
    stats = StreamRunner(engine, reader).run_catchup()
    run_s = time.perf_counter() - t0
    engine.close()
    _sync(device)
    total_s = time.perf_counter() - t0
    launches = _launches()                # this path ends here
    reader.close()
    stages = engine.tracer.as_dict()
    fold_ms = sum(stages.get(k, {}).get("total_ms", 0.0)
                  for k in ("device_step", "device_scan"))
    res = {"events": stats.events, "flushes": stats.flushes,
           "windows_written": stats.windows_written,
           "dropped": engine.dropped, "run_catchup_s": run_s,
           "catchup_with_close_s": total_s,
           "events_per_s": stats.events / run_s,
           "events_per_s_with_close": stats.events / total_s,
           "kernel_launches": launches, "stages": stages,
           "fold_host_ms_per_batch": fold_ms / max(
               -(-stats.events // engine.batch_size), 1),
           "peak_allocated_bytes": _peak(device),
           "reach_rows": len(r.hgetall(f"{cfg.redis_hashtable}_reach"))}
    print(f"[reach_catchup] {json.dumps(res)}", flush=True)
    if stats.events != data.events or engine.dropped:
        raise AssertionError(f"[reach_catchup] folded {stats.events} of "
                             f"{data.events}, dropped {engine.dropped}")
    if any(launches.values()):
        raise AssertionError(f"[reach_catchup] a kernel launched on the "
                             f"reach path: {launches}")
    return res, engine, r


def _reach_resume(data: ReachData, device: str, mins, regs) -> dict:
    """19 (a): an engine that snapshots after every flush is abandoned
    half way; a fresh one resumes, finishes with the oracle's planes, and
    serves a bumped epoch."""
    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.engine import StreamRunner

    cfg = data.config()
    ckdir = os.path.join(data.workdir, "ckpt")
    t0 = time.perf_counter()
    a = _reach_engine(data, cfg, None, device)
    reader = data.broker.reader(cfg.kafka_topic)
    StreamRunner(a, reader, checkpointer=Checkpointer(ckdir),
                 checkpoint_interval_ms=0).run_catchup(
                     max_events=data.events // 2)
    crashed_at = a.events_processed
    reader.close()
    del a                                 # the crash: no close()
    gc.collect()
    b = _reach_engine(data, cfg, None, device)
    reader = data.broker.reader(cfg.kafka_topic)
    runner = StreamRunner(b, reader, checkpointer=Checkpointer(ckdir),
                          checkpoint_interval_ms=0)
    if not runner.resume():
        raise AssertionError("[reach_resume] no snapshot to resume from")
    resumed_at = b.events_processed
    runner.run_catchup()
    b.close()
    reader.close()
    res = {"crashed_at_events": crashed_at, "resumed_at_events": resumed_at,
           "events": b.events_processed, "epoch": b.reach_epoch,
           "run_s": time.perf_counter() - t0}
    print(f"[reach_resume] {json.dumps(res)}", flush=True)
    if (resumed_at != crashed_at or b.events_processed != data.events
            or b.reach_epoch != 1):
        raise AssertionError(f"[reach_resume] {res}")
    _planes_equal("resume", b, mins, regs)
    return res


def _make_queries(n: int, C: int, seed: int):
    """``bench_reach.py:make_queries``: 1-5 campaigns a query, union or
    overlap at random."""
    import numpy as np

    rng = np.random.default_rng(seed)
    masks = np.zeros((n, C), bool)
    overlap = np.zeros(n, bool)
    for i in range(n):
        m = int(rng.integers(1, 6))
        masks[i, rng.choice(C, size=min(m, C), replace=False)] = True
        overlap[i] = bool(rng.integers(0, 2))
    return masks, overlap


def _query_timing(dispatch, call, device: str) -> dict:
    """A query evaluator's numbers: ``dispatch()`` (device tensors in)
    between CUDA events over REACH_TIMED_CALLS calls after three warm
    ones, ``call()`` (host arrays in, results on the host) on the host's
    clock, and the device operations a dispatch under the profiler over
    REACH_PROFILED_CALLS calls (a window of one call has come back
    without its device events).  What the device does not give is "not
    measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        dispatch()
    _sync(device)
    out: dict = {"device_ms": "not measured"}
    if device == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(REACH_TIMED_CALLS):
            dispatch()
        end.record()
        end.synchronize()
        out["device_ms"] = start.elapsed_time(end) / REACH_TIMED_CALLS
    t0 = time.perf_counter()
    for _ in range(REACH_TIMED_CALLS):
        call()
    out["call_ms"] = (time.perf_counter() - t0) * 1e3 / REACH_TIMED_CALLS
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        for _ in range(REACH_PROFILED_CALLS):
            dispatch()
        _sync(device)
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA)
    out["device_ops"] = ops / REACH_PROFILED_CALLS if ops else "not measured"
    return out


def _reach_queries(engine, sets: dict, names: list, device: str) -> dict:
    """19 (b): the 512 queries through ``query_chunks`` (2 dispatches,
    ``agree`` exact, errors inside the bounds), then ``batch_query``
    timed (X7): device ms between CUDA events, eager call ms (the mask
    from numpy in, the results to the host out), device operations, the
    fullest device memory."""
    import math

    import numpy as np
    import torch

    from streambench_tpu_torch.reach import oracle as ro
    from streambench_tpu_torch.reach import query as rq

    k, R = engine.k, engine.registers
    masks, overlap = _make_queries(REACH_QUERIES, len(names),
                                   REACH_SEED + 1)
    mins, regs = engine.state.mins, engine.state.registers
    counter = rq.DispatchCounter()
    t0 = time.perf_counter()
    est, union, jacc, agree = rq.query_chunks(mins, regs, masks, overlap,
                                              counter=counter)
    chunks_ms = (time.perf_counter() - t0) * 1e3
    p = engine.planes()
    want = ro.query_oracle_np(p["mins"], p["registers"], masks)
    u_err, o_err = [], []
    for i in range(masks.shape[0]):
        sel = [names[j] for j in np.flatnonzero(masks[i])]
        op = "overlap" if overlap[i] else "union"
        truth, true_union = ro.exact_counts(sets, sel, op)
        if overlap[i]:
            o_err.append(abs(float(est[i]) - truth) / max(true_union, 1))
        else:
            u_err.append(abs(float(est[i]) - truth) / max(truth, 1))
    ub = 2 * rq.union_bound(R)
    ob = rq.overlap_bound(k, R)
    out = {"queries": REACH_QUERIES, "dispatches": counter.dispatches,
           "query_chunks_ms": chunks_ms,
           "agree_equal_oracle": bool(np.array_equal(agree, want)),
           "union_rel_err": {"mean": float(np.mean(u_err)),
                             "max": float(np.max(u_err)), "n": len(u_err),
                             "bound": ub},
           "overlap_rel_err_vs_union": {"mean": float(np.mean(o_err)),
                                        "max": float(np.max(o_err)),
                                        "n": len(o_err), "bound": ob}}
    # X7: one padded batch at DEFAULT_BATCH, on the device and per call
    qb = rq.DEFAULT_BATCH
    m_np, o_np = masks[:qb], overlap[:qb]
    m_dev = torch.from_numpy(m_np).to(mins.device)
    o_dev = torch.from_numpy(o_np).to(mins.device)
    t = _query_timing(
        lambda: rq.batch_query(mins, regs, m_dev, o_dev),
        lambda: [x.cpu() for x in rq.batch_query(mins, regs, m_np, o_np)],
        device)
    out.update(batch_query_device_ms=t["device_ms"],
               batch_query_call_ms=t["call_ms"],
               batch_query_device_ops=t["device_ops"])
    if device == "cuda":
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rq.batch_query(mins, regs, m_dev, o_dev)
        _sync(device)
        out["batch_query_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                         - base)
    else:
        out["batch_query_peak_bytes"] = "not measured"
    # the least the card could take: each plane and the mask read once,
    # the four [Q] outputs written once, at HBM's rate
    nbytes = (mins.numel() * mins.element_size()
              + regs.numel() * regs.element_size() + m_np.size
              + o_np.size + 4 * 4 * qb)
    out["batch_query_bytes"] = nbytes
    out["batch_query_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    out["shape"] = {"Q": qb, "C": int(mins.shape[0]), "k": k, "R": R}
    print(f"[reach_queries] {json.dumps(out)}", flush=True)
    if counter.dispatches != math.ceil(REACH_QUERIES / rq.DEFAULT_BATCH):
        raise AssertionError(f"[reach_queries] {counter.dispatches} "
                             "dispatches")
    if not out["agree_equal_oracle"]:
        raise AssertionError("[reach_queries] agree differs from the "
                             "oracle's")
    if not (out["union_rel_err"]["mean"] <= ub
            and out["overlap_rel_err_vs_union"]["mean"] <= ob):
        raise AssertionError(f"[reach_queries] errors past the bounds: "
                             f"{out['union_rel_err']}, "
                             f"{out['overlap_rel_err_vs_union']}")
    return out


def _reach_storm(engine, names: list, *, queries_n: int, clients: int,
                 depth: int, batch: int, expect_shed: bool,
                 phase: str) -> dict:
    """19 (c): ``bench_reach.py:run_storm`` on the port: clients send
    over ``PubSubServer`` to a held ``ReachQueryServer`` attached to the
    engine, the queue fills (or sheds), then drains."""
    import math

    import numpy as np

    from streambench_tpu_torch.dimensions.pubsub import (
        PubSubClient,
        PubSubServer,
    )
    from streambench_tpu_torch.reach.serve import ReachQueryServer

    srv = ReachQueryServer(names, depth=depth, batch=batch, hold=True)
    engine.attach_reach(srv)
    ps = PubSubServer(port=0).start()
    ps.register_query("reach", srv.handle)
    host, port = ps.address
    per = queries_n // clients
    results: list = [None] * clients
    errors: list = []
    rng = np.random.default_rng(1234)
    picks = [[list(rng.choice(len(names), size=int(rng.integers(1, 5)),
                              replace=False)) for _ in range(per)]
             for _ in range(clients)]

    def run_client(ci: int) -> None:
        try:
            c = PubSubClient(host, port, timeout_s=120)
            for qi, sel in enumerate(picks[ci]):
                qid = ci * per + qi
                c.request({"type": "reach", "id": qid,
                           "campaigns": [names[j] for j in sel],
                           "op": "overlap" if qid % 2 else "union"})
            results[ci] = [c.recv()["data"] for _ in range(per)]
            c.close()
        except Exception as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=run_client, args=(ci,))
               for ci in range(clients)]
    try:
        t_sub = time.monotonic()
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        want_pending = depth if expect_shed else queries_n
        while (srv.pending() < want_pending
               and srv.pending() + srv.shed < queries_n
               and time.monotonic() < deadline):
            time.sleep(0.01)
        submit_s = time.monotonic() - t_sub
        t_drain = time.monotonic()
        srv.resume()
        for t in threads:
            t.join(timeout=120)
        drain_s = time.monotonic() - t_drain
        summary = srv.summary()
    finally:
        ps.close()
        srv.close()
    answers = [m for got in results if got for m in got]
    served = [m for m in answers if "estimate" in m]
    shed = [m for m in answers if m.get("shed")]
    out = {"phase": phase, "sent": clients * per, "clients": clients,
           "served": summary["served"], "shed": summary["shed"],
           "dispatches": summary["dispatches"], "batch": batch,
           "queue_depth": depth, "submit_s": submit_s, "drain_s": drain_s,
           "p50_ms": summary.get("p50_ms"), "p99_ms": summary.get("p99_ms"),
           "qps": summary["served"] / max(drain_s, 1e-9),
           "errors": errors}
    print(f"[reach_{phase}] {json.dumps(out)}", flush=True)
    if errors or len(answers) != clients * per:
        raise AssertionError(f"[reach_{phase}] {len(answers)} answers of "
                             f"{clients * per}: {errors[:3]}")
    if (len(served) != summary["served"]
            or len(served) + len(shed) != clients * per):
        raise AssertionError(f"[reach_{phase}] served {len(served)} + shed "
                             f"{len(shed)} != sent {clients * per}")
    if expect_shed:
        if summary["shed"] <= 0:
            raise AssertionError(f"[reach_{phase}] nothing shed")
    elif (summary["shed"] or summary["served"] != clients * per
          or summary["dispatches"] > math.ceil(clients * per / batch)
          or any(m["epoch"] != engine.reach_epoch for m in served)):
        raise AssertionError(f"[reach_{phase}] {summary}")
    return out


def _reach_live(engine, data: ReachData, names: list, sets: dict,
                device: str) -> dict:
    """19 (d): serve REACH_LIVE_QUERIES queries while a second thread
    folds a second journal (new devices) into the same engine, flushing
    (pushing) between chunks.  Every push's planes are recorded; each
    served answer's ``agree`` must be that of a state pushed while the
    query was in flight (a read of planes folded after the push, or torn
    by a fold, matches none), and REACH_FINAL_QUERIES queries after the
    last push must equal the oracle over both journals; then
    ``close()`` and the planes against that oracle."""
    import numpy as np

    from streambench_tpu_torch.dimensions.pubsub import (
        PubSubClient,
        PubSubServer,
    )
    from streambench_tpu_torch.ops import minhash
    from streambench_tpu_torch.reach import oracle as ro
    from streambench_tpu_torch.reach.serve import ReachQueryServer

    path = data.extra("live", REACH_LIVE_EVENTS, REACH_LIVE_USERS,
                      REACH_SEED + 7)
    srv = ReachQueryServer(names, depth=512, batch=64)
    # the planes of every push, recorded on the fold's thread before the
    # server swaps them in: while a query is in flight the server answers
    # from pushed[n_sent - 2] or a later state up to pushed[n_recv - 1]
    pushed: list = []
    push = srv.update_state

    def recorded(mins, registers, epoch, shipped_ms=None, freshness=None):
        pushed.append((minhash.mins_numpy(mins), registers.cpu().numpy()))
        push(mins, registers, epoch, shipped_ms, freshness)

    srv.update_state = recorded
    engine.attach_reach(srv)
    ps = PubSubServer(port=0).start()
    ps.register_query("reach", srv.handle)
    host, port = ps.address
    errors: list = []
    folded = {"events": 0, "pushes": 0}
    answers: list = []      # (reply, pushes at send, pushes at receipt)
    masks = np.zeros((REACH_LIVE_QUERIES, len(names)), bool)
    rng = np.random.default_rng(77)

    def fold() -> None:
        try:
            with open(path, "rb") as f:
                lines = f.read().splitlines()
            for off in range(0, len(lines), 4 * REACH_BATCH):
                folded["events"] += engine.process_chunk(
                    lines[off:off + 4 * REACH_BATCH])
                engine.flush()
                folded["pushes"] += 1
        except Exception as e:
            errors.append(f"fold: {e!r}")

    def ask() -> None:
        try:
            c = PubSubClient(host, port, timeout_s=120)
            for i in range(REACH_LIVE_QUERIES):
                sel = rng.choice(len(names), size=int(rng.integers(1, 5)),
                                 replace=False)
                masks[i, sel] = True
                sent = len(pushed)
                c.request({"type": "reach", "id": i,
                           "campaigns": [names[j] for j in sel],
                           "op": "overlap" if i % 2 else "union"})
                answers.append((c.recv()["data"], sent, len(pushed)))
            c.close()
        except Exception as e:
            errors.append(f"client: {e!r}")

    both = data.sets(path)
    for c in both:
        both[c] |= sets[c]
    em, er = ro.expected_state(both, names, engine.k, engine.registers)
    fmasks, _ = _make_queries(REACH_FINAL_QUERIES, len(names),
                              REACH_SEED + 5)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=fold), threading.Thread(target=ask)]
    final = None
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        n_pushed = len(pushed)        # close() pushes once more below
        if not any(t.is_alive() for t in threads):
            # after the last push: the answers are the whole oracle's
            c = PubSubClient(host, port, timeout_s=120)
            for i in range(REACH_FINAL_QUERIES):
                c.request({"type": "reach", "id": i, "op": "overlap",
                           "campaigns": [names[j] for j in
                                         np.flatnonzero(fmasks[i])]})
            final = {}
            for _ in range(REACH_FINAL_QUERIES):
                d = c.recv()["data"]
                final[d["id"]] = d
            c.close()
        summary = srv.summary()
    finally:
        ps.close()
        srv.close()
    engine.close()
    wall_s = time.perf_counter() - t0
    k = engine.k
    # each pushed state's agree for every query, [pushes, Q]
    agrees = np.stack([ro.query_oracle_np(m, r, masks) for m, r in pushed])
    served = shed = 0
    bad, torn = [], []
    for i, (d, sent, recv) in enumerate(answers):
        if d.get("shed"):
            shed += 1
            continue
        if "jaccard" not in d:
            bad.append(d)
            continue
        served += 1
        got = int(round(d["jaccard"] * k))
        if got not in agrees[max(sent - 2, 0):recv, i]:
            torn.append((i, got, sent, recv,
                         agrees[max(sent - 2, 0):recv, i].tolist()))
    want_final = ro.query_oracle_np(em, er, fmasks)
    final_ok = bool(
        final is not None and len(final) == REACH_FINAL_QUERIES
        and all("jaccard" in final[i] for i in final)
        and np.array_equal(
            [round(final[i]["jaccard"] * k)
             for i in range(REACH_FINAL_QUERIES)], want_final))
    out = {"queries": REACH_LIVE_QUERIES, "answers": len(answers),
           "served": served, "shed": shed, "bad": len(bad),
           "pushes_recorded": n_pushed,
           "answers_of_a_pushed_state": served - len(torn),
           "final_queries_equal_oracle": final_ok,
           "folded_events": folded["events"], "pushes": folded["pushes"],
           "dispatches": summary["dispatches"],
           "p50_ms": summary.get("p50_ms"), "p99_ms": summary.get("p99_ms"),
           "wall_s": wall_s, "errors": errors}
    print(f"[reach_live] {json.dumps(out)}", flush=True)
    if (errors or bad or torn or not final_ok
            or len(answers) != REACH_LIVE_QUERIES
            or served + shed != REACH_LIVE_QUERIES
            or folded["events"] != REACH_LIVE_EVENTS
            or any(t.is_alive() for t in threads)):
        raise AssertionError(f"[reach_live] {out}; {bad[:3]}; "
                             f"not of a pushed state: {torn[:3]}")
    _planes_equal("live", engine, em, er)
    return out


def _reach_cli(data: ReachData, sets: dict, device: str,
               sharded: bool = False) -> dict:
    """19 (e): ``python -m streambench_tpu_torch.engine --engine reach
    --catchup`` on (a)'s journal and a tail over REACH_TAIL_CAMPAIGNS
    campaigns appended to it (once: a second call folds the same topic),
    with a delta ship log (a flush and a ship at every chunk: the chunks
    of the whole journal cut over to bases, those of the tail alone ship
    deltas), a RESP store process for its ``_reach`` hash, and a ``python
    -m streambench_tpu_torch.reach.replica`` process tailing the log; 64
    queries through the replica's pub/sub against the oracle over both,
    at least one delta shipped and folded by the replica.  With
    ``sharded`` (21 (b)) the engine runs ``--sharded`` on the (1, 1)
    mesh and ships to a log of its own."""
    import numpy as np
    import torch

    from streambench_tpu_torch.dimensions.pubsub import PubSubClient
    from streambench_tpu_torch.io.resp import RespClient
    from streambench_tpu_torch.ops import minhash
    from streambench_tpu_torch.reach import oracle as ro

    wd = data.workdir
    ship = os.path.join(wd, "ship_sharded" if sharded else "ship")
    os.makedirs(ship, exist_ok=True)
    if data.tail_path is None:
        data.tail_path = data.tail(REACH_TAIL_EVENTS, REACH_TAIL_USERS,
                                   REACH_SEED + 9, REACH_TAIL_CAMPAIGNS)
    tail_sets = data.sets(data.tail_path)
    sets = {c: sets[c] | tail_sets[c] for c in sets}
    events = data.events + REACH_TAIL_EVENTS
    rport = _free_port()
    cfg = data.config({"redis.host": "127.0.0.1", "redis.port": rport,
                       "jax.reach.k": REACH_K, "jax.reach.ship.dir": ship,
                       "jax.reach.ship.delta": "on",
                       "jax.flush.interval.ms": 0,
                       "jax.reach.ship.interval.ms": 1})
    conf = os.path.join(wd, "benchmarkConf.yaml")
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    procs = []
    t0 = time.perf_counter()
    try:
        redis = subprocess.Popen(
            [sys.executable, "-m", "streambench_tpu_torch.io.fakeredis",
             "--port", str(rport)], env=env, cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        procs.append(redis)
        replica = subprocess.Popen(
            [sys.executable, "-m", "streambench_tpu_torch.reach.replica",
             "--ship", ship, "--device", device, "--poll-ms", "50",
             "--max-staleness-ms", "600000"], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(replica)
        eng = subprocess.run(
            [sys.executable, "-m", "streambench_tpu_torch.engine",
             "--confPath", conf, "--workdir", wd, "--catchup",
             "--engine", "reach", "--device", device]
            + (["--sharded"] if sharded else []),
            env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
        engine_s = time.perf_counter() - t0
        if eng.returncode != 0:
            raise AssertionError(f"[reach_cli] engine exited "
                                 f"{eng.returncode}: {eng.stderr[-2000:]}")
        lines = eng.stdout.strip().splitlines()
        stats = json.loads(lines[-1])
        up = next((ln for ln in lines if ln.startswith("engine up:")), "")
        line = replica.stdout.readline()
        if not line.startswith("replica: pubsub="):
            raise AssertionError(f"[reach_cli] replica said {line!r}")
        host, port = line.split()[1].split("=")[1].rsplit(":", 1)
        names = list(data.campaigns)
        em, er = ro.expected_state(sets, names, REACH_K, REACH_CLI_R)
        masks, overlap = _make_queries(REACH_CLI_QUERIES, len(names),
                                       REACH_SEED + 3)
        want = ro.query_oracle_np(em, er, masks)
        got = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            c = PubSubClient(host, int(port), timeout_s=60)
            for i in range(REACH_CLI_QUERIES):
                c.request({"type": "reach", "id": i, "op": "overlap",
                           "campaigns": [names[j] for j in
                                         np.flatnonzero(masks[i])]})
            replies = {}
            for _ in range(REACH_CLI_QUERIES):
                d = c.recv()["data"]
                replies[d["id"]] = d
            c.close()
            if all("jaccard" in replies[i] for i in replies):
                got = np.asarray([round(replies[i]["jaccard"] * REACH_K)
                                  for i in range(REACH_CLI_QUERIES)])
                if np.array_equal(got, want):
                    break
            time.sleep(0.2)            # the final record not loaded yet
        with RespClient("127.0.0.1", rport) as rc:
            table = rc.hgetall(f"{cfg.redis_hashtable}_reach")
        est = minhash.estimate(torch.from_numpy(er).to(device)).cpu()
        rows = {n: str(int(round(float(e)))) for n, e in zip(names, est)
                if e > 0}
        replica.terminate()
        rep_out, rep_err = replica.communicate(timeout=60)
        rep_stats = json.loads(rep_out.strip().splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    ship_stats = stats["reach"].get("ship") or {}
    tailer = rep_stats.get("tailer") or {}
    out = {"engine_rc": eng.returncode, "replica_rc": replica.returncode,
           "engine_up": up,
           "events": stats["events"], "events_per_s": stats["events_per_s"],
           "tail_events": REACH_TAIL_EVENTS,
           "tail_campaigns": REACH_TAIL_CAMPAIGNS,
           "ship": ship_stats,
           "kernel_launches": stats["kernel_launches"],
           "agree_equal_oracle": bool(got is not None
                                      and np.array_equal(got, want)),
           "reach_rows": len(table), "reach_rows_equal": table == rows,
           "replica": {k: rep_stats.get(k) for k in
                       ("device", "plane_loads", "epoch_loads", "tailer")},
           "replica_served": rep_stats.get("serve", {}).get("served"),
           "wall_s": time.perf_counter() - t0, "engine_s": engine_s}
    print(f"[reach_cli] {json.dumps(out)}", flush=True)
    if (replica.returncode != 0 or stats["events"] != events
            or ("mesh=1x1" in up) != sharded
            or not out["agree_equal_oracle"] or table != rows
            or not ship_stats.get("deltas")
            or not tailer.get("deltas_folded")
            or rep_stats.get("device") != str(torch.device(device))):
        raise AssertionError(f"[reach_cli] {out}; replica stderr "
                             f"{rep_err[-1000:]}")
    return out


def phase_reach(device: str = "cuda", events: int = REACH_EVENTS,
                users: int = REACH_USERS, keep: bool = False):
    """Phase 19: reach serving on the card (module doc).  ``device`` and
    the size are arguments so the phase can be rehearsed on the CPU at a
    small size; the smoke runs it on ``cuda`` at the reference reach
    benchmark's large rung.  With ``keep`` it returns ``(result, kept)``:
    the journal (the caller removes it) and what phase 21 holds sharded
    reach to (the oracle's planes, which (a)'s engine's equal)."""
    from streambench_tpu_torch.reach import oracle as ro

    t0 = time.perf_counter()
    data = ReachData(events, REACH_CAMPAIGNS, users, REACH_SEED)
    out: dict = {"events": events, "users": users, "generate_s": data.gen_s,
                 "k": REACH_K, "registers": REACH_R, "batch": REACH_BATCH}
    kept = None
    try:
        t1 = time.perf_counter()
        sets = data.sets(data.journal)
        names = list(data.campaigns)
        mins, regs = ro.expected_state(sets, names, REACH_K, REACH_R)
        out["distinct_devices"] = len(set().union(*sets.values()))
        out["oracle_s"] = time.perf_counter() - t1
        # (a) the fold, its resume and its profile
        res, engine, _ = _reach_catchup(data, device)
        _planes_equal("catchup", engine, mins, regs)
        res["planes_equal_oracle"] = True
        out["catchup"] = res
        out["resume"] = _reach_resume(data, device, mins, regs)
        out["profile"] = _reach_profile(data, device)
        # (b) the queries, X7
        out["queries"] = _reach_queries(engine, sets, names, device)
        # (c) the storm and the shed rung
        out["storm"] = _reach_storm(engine, names, phase="storm",
                                    **REACH_STORM)
        out["shed"] = _reach_storm(engine, names, phase="shed",
                                   **REACH_SHED)
        # (d) serving while folding
        out["live"] = _reach_live(engine, data, names, sets, device)
        del engine
        # (e) the CLI and a replica, each its own process
        out["cli"] = _reach_cli(data, sets, device)
        if keep:
            kept = {"data": data, "sets": sets, "mins": mins, "regs": regs,
                    "ev": out["catchup"]["events_per_s"],
                    "x7_device_ms": out["queries"]["batch_query_device_ms"]}
    finally:
        if kept is None:
            data.remove()
    out["phase_s"] = time.perf_counter() - t0
    q, p = out["queries"], out["profile"]
    print(f"[reach] {out['distinct_devices']} devices; catchup "
          f"{out['catchup']['events_per_s']:.0f} ev/s "
          f"({out['catchup']['events_per_s_with_close']:.0f} with close), "
          f"peak {out['catchup']['peak_allocated_bytes']} B, planes equal "
          f"the oracle's; X6 {p['device_ops_per_dispatch']} device ops and "
          f"{p['device_ms_per_dispatch']} device ms a dispatch, "
          f"{out['catchup']['fold_host_ms_per_batch']:.3f} host ms a batch; "
          f"X7 batch_query {q['batch_query_device_ms']} device ms, "
          f"{q['batch_query_call_ms']:.3f} ms a call, "
          f"{q['batch_query_device_ops']} device ops, "
          f"{q['batch_query_peak_bytes']} B; storm {out['storm']['served']}"
          f" served in {out['storm']['dispatches']} dispatches, p50/p99 "
          f"{out['storm']['p50_ms']}/{out['storm']['p99_ms']} ms; shed "
          f"{out['shed']['shed']} of {out['shed']['sent']}; live "
          f"{out['live']['served']} served, {out['live']['shed']} shed; "
          f"CLI + replica agree exact; {out['phase_s']:.1f} s", flush=True)
    return (out, kept) if keep else out


def _reach_launches(reach: dict, kernel: str) -> dict:
    """A kernel's launches on phase 19's paths (none of them launches a
    hand-written kernel): (a)'s catchup and (e)'s engine process."""
    return {f"reach_{run}": reach[run]["kernel_launches"][kernel]
            for run in ("catchup", "cli")}


# ---------------------------------------------------------------------
# phase 20: the replica fleet
FLEET_SEED = 29
FLEET_EVENTS = 100_000            # (a): the writer's journal, folded in loops
FLEET_USERS = 40_000
FLEET_SCALEOUT = {"replica_counts": (1, 2), "queries_n": 240,
                  "gap_s": 0.004, "ship_ms": 400, "ingest_gap_s": 0.6}
FLEET_AGREE_QUERIES = 64          # (a): asked of each replica at the end
FLEET_READY_S = 30.0              # fleet_supervisor.wait_ready's default
# (b) at the reference's own smoke schedule (bench_reach.py:2231: 60
# queries over 10 epochs shipped 0.3 s apart): its defaults, 160 queries
# over 14 epochs, are 134 s of the plan's 1.5 s timeouts (PERF.md §4).
# The router waits 0.5 s for a replica, not the reference's 1.5 s
# (bench_reach.py:1278): ~70 s of the storm went to those waits, and a
# replica on the card answers in milliseconds, a delayed frame in 20 ms
FLEET_CHAOS = {"seed": 7, "replicas_n": 2, "epochs_n": 10,
               "queries_n": 60, "ship_gap_s": 0.3, "gap_s": 0.02,
               "max_staleness_ms": 10_000, "timeout_s": 0.5}
# (c) at the reference's reduced schedule (bench_reach.py:2237, 8 s + 8 s,
# 5 -> 30 qps): the defaults' 14 s + 7 s, 6 -> 36 qps do not fit the
# whole smoke's time (PERF.md §4)
FLEET_AUTOSCALE = {"seed": 13, "duration_s": 8.0, "tail_s": 8.0,
                   "qps0": 5.0, "qps1": 30.0, "burst_n": 24, "camps_n": 16,
                   "K": 8192, "R": 4096, "ship0_ms": 2000,
                   "objective_staleness_ms": 1000, "objective_p99_ms": 15,
                   "max_replicas": 3, "clients": 16}


def _used_bytes(device: str):
    """Device memory in use on the card by every process, contexts
    included (``torch.cuda.mem_get_info``), or "not measured" off the
    card."""
    import torch

    if device != "cuda":
        return "not measured"
    free, total = torch.cuda.mem_get_info()
    return total - free


def _merge_ns(raw: list) -> list:
    merged: list = []
    for s, e in sorted(raw):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _ask_until_served(host: str, port: int, campaign: str, tag: str,
                      timeout_s: float) -> float | None:
    """Seconds until ``host:port`` answers a reach query (not a shed),
    asking with a fresh id each time; None if it never does."""
    from streambench_tpu_torch.dimensions.pubsub import PubSubClient

    t0 = time.monotonic()
    deadline = t0 + timeout_s
    n = 0
    while time.monotonic() < deadline:
        n += 1
        try:
            c = PubSubClient(host, port, timeout_s=5)
            try:
                d = c.request({"type": "reach", "campaigns": [campaign],
                               "op": "union", "id": f"{tag}{n}"},
                              timeout_s=5.0)
            finally:
                c.close()
            if "estimate" in d:
                return time.monotonic() - t0
        except (TimeoutError, ConnectionError, OSError):
            pass
        time.sleep(0.05)
    return None


def _replica_stats(out_path: str) -> dict:
    """The last JSON line a replica process wrote (its exit stats)."""
    with open(out_path, encoding="utf-8", errors="replace") as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else {}


def _fleet_scaleout(device: str, *, events: int = FLEET_EVENTS,
                    users: int = FLEET_USERS, replica_counts=(1, 2),
                    queries_n: int = 240, gap_s: float = 0.004,
                    ship_ms: int = 400, ingest_gap_s: float = 0.6,
                    agree_queries: int = FLEET_AGREE_QUERIES,
                    ready_s: float = FLEET_READY_S) -> dict:
    """20 (a): ``bench_reach.py:run_replica_scaleout`` at its defaults on
    the port (module doc)."""
    import numpy as np

    from streambench_tpu_torch.chaos.fleet_supervisor import (
        FleetSupervisor,
        cli_spawn,
        wait_ready,
    )
    from streambench_tpu_torch.dimensions.pubsub import (
        PubSubClient,
        PubSubServer,
    )
    from streambench_tpu_torch.dimensions.store import (
        LOG_NAME,
        DurableDimensionStore,
    )
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.redis_schema import as_redis
    from streambench_tpu_torch.obs import MetricsSampler, SpanTracer
    from streambench_tpu_torch.reach import oracle as ro
    from streambench_tpu_torch.reach.replica import SnapshotShipper

    t_phase = time.perf_counter()
    data = ReachData(events, REACH_CAMPAIGNS, users, FLEET_SEED,
                     name="smoke_fleet")
    names = list(data.campaigns)
    fleet_dir = os.path.join(data.workdir, "fleet")
    os.makedirs(fleet_dir)
    engine = _reach_engine(data, data.config(), as_redis(make_store()),
                           device)
    engine.warmup()
    _reset_peak(device)
    ship_dir = os.path.join(data.workdir, "ship")
    store = DurableDimensionStore(ship_dir)
    ship_path = os.path.join(ship_dir, LOG_NAME)
    # the writer's pub/sub origin: the replicas ping it for their clock
    # offset, and every shipped record names it
    origin = PubSubServer(port=0).start()
    o_host, o_port = origin.address
    shipper = SnapshotShipper(store, names, interval_ms=ship_ms,
                              origin={"addr": f"{o_host}:{o_port}",
                                      "pid": os.getpid(), "role": "writer"})
    eng_lock = threading.Lock()
    with eng_lock:
        engine.attach_shipper(shipper)
    spans = SpanTracer(capacity=8192)
    folded = {"events0": engine.events_processed, "events": 0, "wall": 0.0}
    sampler = MetricsSampler(os.path.join(fleet_dir, "metrics.jsonl"),
                             interval_ms=250, role="writer")

    def collect(rec, dt_s):
        rec["events"] = folded["events"]
        rec["events_per_s"] = round(
            folded["events"] / max(folded["wall"], 1e-9), 1)
        rec["ship"] = shipper.summary()

    sampler.add_collector(collect)
    sampler.start()

    def force_ship(*_):
        with eng_lock:
            p = engine.planes()
            shipper.note_state(p["mins"], p["registers"], engine.reach_epoch,
                               int(engine.state.watermark), force=True,
                               folded_ms=engine._fold_wall_ms)

    ingest_stop = threading.Event()
    busy: list = []
    errors: list = []

    def ingest() -> None:
        try:
            t_start = time.monotonic()
            while not ingest_stop.is_set():
                with open(data.journal, "rb") as f:
                    carry = b""
                    while not ingest_stop.is_set():
                        chunk = f.read(128 << 10)
                        if not chunk:
                            break
                        chunk = carry + chunk
                        nl = chunk.rfind(b"\n") + 1
                        carry = chunk[nl:]
                        with eng_lock, spans.span("fold", cat="stage"):
                            engine.process_block(chunk[:nl])
                            t0 = time.monotonic_ns()
                            _sync(device)
                            busy.append((t0, time.monotonic_ns()))
                            engine.flush()      # ships at the cadence
                        folded["events"] = (engine.events_processed
                                            - folded["events0"])
                        folded["wall"] = time.monotonic() - t_start
                        ingest_stop.wait(ingest_gap_s)
        except Exception as e:
            errors.append(f"ingest: {e!r}")

    t_ing = threading.Thread(target=ingest, daemon=True)
    ladder: dict = {}
    all_waits: list = []
    stats_all: list = []
    out: dict = {"events": events, "users": users, "k": engine.k,
                 "registers": engine.registers,
                 "batch": engine.batch_size, "device": device,
                 "ship_interval_ms": ship_ms, "ingest_gap_s": ingest_gap_s,
                 "queries_n": queries_n, "gap_s": gap_s}
    mem: dict = {}
    env_pp = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = REPO + (os.pathsep + env_pp if env_pp
                                       else "")
    sup = None
    final_n = max(replica_counts)
    try:
        force_ship()                       # a record to load at once
        t_ing.start()
        for n_rep in replica_counts:
            rung_dir = (fleet_dir if n_rep == final_n
                        else os.path.join(data.workdir, f"r{n_rep}"))
            ports = [_free_port() for _ in range(n_rep)]
            spawn = cli_spawn(
                ship_path, rung_dir, ports=ports, poll_ms=150, fleet=True,
                metrics=True, device=device,
                extra_args=("--batch", "64", "--dump-queue-waits",
                            "--metrics-interval-ms", "250"))
            _sync(device)
            used_before = _used_bytes(device)
            sup = FleetSupervisor(spawn, n_rep, backoff_base_ms=40.0,
                                  backoff_cap_ms=400.0, healthy_after_s=0.3,
                                  seed=FLEET_SEED, on_restart=force_ship)
            t_spawn = time.monotonic()
            sup.start()
            addrs: list = [None] * n_rep
            ready: list = [None] * n_rep

            def await_ready(idx, d=rung_dir):
                try:
                    addrs[idx] = wait_ready(
                        os.path.join(d, f"replica_{idx}.out"),
                        timeout_s=ready_s)
                    line_s = time.monotonic() - t_spawn
                    first = _ask_until_served(*addrs[idx], names[0],
                                              f"warm{idx}-", ready_s)
                    ready[idx] = {"ready_line_s": line_s,
                                  "first_answer_s": (
                                      None if first is None
                                      else time.monotonic() - t_spawn)}
                except Exception as e:
                    errors.append(f"replica {idx} of {n_rep}: {e!r}")

            waits = [threading.Thread(target=await_ready, args=(i,))
                     for i in range(n_rep)]
            for t in waits:
                t.start()
            for t in waits:
                t.join(timeout=2 * ready_s + 10)
            if (errors or any(r is None or r["first_answer_s"] is None
                              for r in ready)):
                raise AssertionError(
                    f"[fleet_scaleout] {n_rep} replica(s) not ready within "
                    f"{ready_s} s on {device}: {ready}; {errors[:3]}")
            _sync(device)
            used_up = _used_bytes(device)
            if n_rep == 1 and device == "cuda":
                mem["replica_context_bytes"] = used_up - used_before
            answers: list = [[] for _ in range(n_rep)]

            def storm(ci: int) -> None:
                try:
                    c = PubSubClient(*addrs[ci], timeout_s=120)
                    rng = np.random.default_rng(1000 + ci)
                    pending = 0
                    for qi in range(queries_n):
                        sel = [names[j] for j in rng.choice(
                            len(names), size=int(rng.integers(1, 4)),
                            replace=False)]
                        c.request({"type": "reach", "campaigns": sel,
                                   "op": "overlap" if qi % 2 else "union",
                                   "id": qi})
                        pending += 1
                        while pending > 32:
                            answers[ci].append(c.recv()["data"])
                            pending -= 1
                        time.sleep(gap_s)
                    for _ in range(pending):
                        answers[ci].append(c.recv()["data"])
                    c.close()
                except Exception as e:
                    errors.append(f"storm {ci}: {e!r}")

            t0 = time.monotonic()
            threads = [threading.Thread(target=storm, args=(ci,))
                       for ci in range(n_rep)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            storm_s = time.monotonic() - t0
            if n_rep == final_n:
                # (d), while the writer still folds and ships (a fleet
                # replica's staleness anchors at the last fold): SIGKILL
                # replica 0; the supervisor respawns it at its pinned
                # port, and the card's memory in use comes back
                _sync(device)
                used_kill = _used_bytes(device)
                t_kill = time.monotonic()
                if not sup.kill(0):
                    raise AssertionError("[fleet_scaleout] replica 0 was "
                                         "not alive to kill")
                deadline = t_kill + ready_s
                while time.monotonic() < deadline:
                    sup.step()
                    if sup.slots[0].restarts and sup.alive(0):
                        break
                    time.sleep(0.02)
                respawned_s = time.monotonic() - t_kill
                first = _ask_until_served(*addrs[0], names[0], "respawn",
                                          ready_s)
                if first is None or not sup.slots[0].restarts:
                    with open(os.path.join(rung_dir, "replica_0.out"),
                              errors="replace") as f:
                        tail = f.read()[-2000:]
                    raise AssertionError(
                        f"[fleet_scaleout] the killed replica did not come "
                        f"back at {addrs[0]} within {ready_s} s: "
                        f"{sup.summary()}; its output: {tail}")
                _sync(device)
                used_back = _used_bytes(device)
                mem.update({"used_before_kill_bytes": used_kill,
                            "used_after_respawn_bytes": used_back,
                            "respawn_s": respawned_s,
                            "respawn_to_answer_s": time.monotonic()
                            - t_kill})
                # the end of the ingest: the last fold's planes, shipped,
                # and each replica's answers against the oracle on them
                ingest_stop.set()
                t_ing.join(timeout=120)
                force_ship()
                with eng_lock:
                    p = engine.planes()
                rng = np.random.default_rng(FLEET_SEED + 2)
                masks = np.zeros((agree_queries, len(names)), bool)
                for i in range(agree_queries):
                    # 4-6 campaigns: no set the storm asked (1-3), so no
                    # cached answer of older planes can come back
                    masks[i, rng.choice(len(names), size=int(
                        rng.integers(4, 7)), replace=False)] = True
                want = ro.query_oracle_np(p["mins"], p["registers"],
                                          masks)
                time.sleep(max(1.5, 10 * 0.15))   # ten tailer polls
                agree_ok = []
                for ci, addr in enumerate(addrs):
                    c = PubSubClient(*addr, timeout_s=60)
                    got = [c.request({"type": "reach", "op": "overlap",
                                      "id": f"agree{ci}-{i}",
                                      "campaigns": [names[j] for j in
                                                    np.flatnonzero(m)]},
                                     timeout_s=30.0)
                           for i, m in enumerate(masks)]
                    c.close()
                    agree_ok.append(all("jaccard" in d for d in got)
                                    and [round(d["jaccard"] * engine.k)
                                         for d in got] == want.tolist())
                out["agree_equal_oracle"] = agree_ok
            sup.stop(grace_s=30.0)
            codes = [s.handle.poll() for s in sup.slots]
            stats = [_replica_stats(os.path.join(rung_dir,
                                                 f"replica_{i}.out"))
                     for i in range(n_rep)]
            stats_all.extend(stats)
            flat = [d for got in answers for d in got]
            served = [d for d in flat if "estimate" in d]
            shed = [d for d in flat if d.get("shed")]
            stales = sorted(d["staleness_ms"] for d in served)
            hop_bad = [d for d in served if abs(
                sum(d["freshness"][f"{h}_ms"] for h in
                    ("fold_lag", "ship_wait", "tail_lag", "serve"))
                - d["freshness"]["staleness_ms"]) > 0.25
                or d["staleness_ms"] != d["freshness"]["staleness_ms"]]
            for s in stats:
                all_waits.extend(s.get("queue_waits_ns") or [])
            clocks = [s.get("clock") for s in stats]
            ladder[f"r{n_rep}"] = {
                "replicas": n_rep, "sent": n_rep * queries_n,
                "served": len(served), "shed": len(shed),
                "qps": len(served) / max(storm_s, 1e-9),
                "storm_s": storm_s,
                "staleness_p50_ms": (stales[len(stales) // 2]
                                     if stales else None),
                "staleness_p99_ms": (stales[min(len(stales) - 1, int(
                    len(stales) * 0.99))] if stales else None),
                "staleness_max_ms": stales[-1] if stales else None,
                "clock": clocks,
                "clock_applied": [bool((c or {}).get("applied"))
                                  for c in clocks],
                "cache_hits": sum(((s.get("serve") or {}).get("cache")
                                   or {}).get("hits", 0) for s in stats),
                "ready": ready, "exit_codes": codes,
                "peak_device_bytes": [
                    (s.get("device_memory") or {}).get(
                        "peak_allocated_bytes", "not measured")
                    for s in stats],
                "ingest_events_folded": folded["events"]}
            print(f"[fleet_scaleout] r{n_rep} "
                  f"{json.dumps(ladder[f'r{n_rep}'])}", flush=True)
            if (errors or len(flat) != n_rep * queries_n
                    or len(served) + len(shed) != n_rep * queries_n
                    or not served
                    or not all("plane_epoch" in d for d in flat)
                    or hop_bad or any(c is None for c in clocks)
                    or any(code != 0 for code in codes)):
                raise AssertionError(
                    f"[fleet_scaleout] r{n_rep}: {len(flat)} replies of "
                    f"{n_rep * queries_n}, {len(served)} served + "
                    f"{len(shed)} shed, hop sums off {hop_bad[:2]}, "
                    f"clocks {clocks}, exit codes {codes}; {errors[:3]}")
            sup = None
    finally:
        ingest_stop.set()
        t_ing.join(timeout=120)
        if sup is not None:
            sup.stop(grace_s=10.0)
        if env_pp is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = env_pp
        sampler.close()
        origin.close()
        store.close()
    spans.dump(os.path.join(fleet_dir, "trace_writer.json"),
               run="fleet-writer")
    from streambench_tpu_torch.obs.queryattr import _interval_overlap_ns

    merged_busy = _merge_ns([list(b) for b in busy])
    wait_total = sum(max(b - a, 0) for a, b in all_waits)
    overlap = sum(_interval_overlap_ns(a, b, merged_busy)
                  for a, b in all_waits if b > a)
    busy_ns = sum(e - s for s, e in merged_busy)
    span_ns = ((merged_busy[-1][1] - merged_busy[0][0]) if merged_busy
               else 0)
    out.update({
        "ladder": ladder,
        "offwriter_contention_ratio": (overlap / wait_total
                                       if wait_total else 0.0),
        "ingest_busy_duty": busy_ns / span_ns if span_ns else 0.0,
        "queue_wait_ms": wait_total / 1e6,
        "ingest_overlap_ms": overlap / 1e6, "busy_windows": len(busy),
        "ingest_events_folded": folded["events"],
        "ingest_events_per_s": folded["events"] / max(folded["wall"],
                                                      1e-9),
        "ships": shipper.ships, "writer_peak_device_bytes": _peak(device),
        "memory": mem})
    # the fleet read back by its own instruments
    import glob

    fleet = _obs_cli("fleet", fleet_dir)
    roles = sorted(a["role"] for a in fleet["roles"])
    traces = [f"writer={os.path.join(fleet_dir, 'trace_writer.json')}"]
    for i in range(final_n):
        traces += [f"replica={p}" for p in sorted(glob.glob(os.path.join(
            fleet_dir, f"replica_{i}", "trace_*.json")))]
    merged = _obs_cli("trace", *traces, "--merge", "--out",
                      os.path.join(fleet_dir, "merged_trace.json"))
    out["obs_fleet"] = {"roles": roles, "processes": fleet["processes"]}
    out["trace_merge"] = {"processes": merged["processes"],
                          "traces": len(traces)}
    stales = [s for r in ladder.values()
              for s in (r["staleness_p50_ms"], r["staleness_p99_ms"])]
    out["phase_s"] = time.perf_counter() - t_phase
    data.remove()
    brief = {k: v for k, v in out.items() if k != "ladder"}
    print(f"[fleet_scaleout] {json.dumps(brief)}", flush=True)
    ctx = mem.get("replica_context_bytes")
    if device == "cuda" and (
            not isinstance(ctx, int) or ctx <= 0
            or mem["used_after_respawn_bytes"]
            - mem["used_before_kill_bytes"] >= ctx):
        raise AssertionError(f"[fleet_scaleout] (d): device memory after "
                             f"the kill and respawn {mem}")
    if (not all(out["agree_equal_oracle"])
            or "writer" not in roles or roles.count("replica") < final_n
            or sorted(set(merged["processes"].values()))
            != ["replica", "writer"] or None in stales):
        raise AssertionError(f"[fleet_scaleout] agree {out['agree_equal_oracle']}"
                             f", obs fleet roles {roles}, merged trace "
                             f"{merged['processes']}")
    return out


def _fleet_chaos(device: str, *, seed: int = 7, replicas_n: int = 2,
                 epochs_n: int = 14, queries_n: int = 160,
                 ship_gap_s: float = 0.4, gap_s: float = 0.02,
                 max_staleness_ms: int = 10_000,
                 timeout_s: float = 1.5) -> dict:
    """20 (b): ``bench_reach.py:run_fleet_chaos`` at its defaults on the
    port (module doc): in-process replicas on ``device`` behind
    ``ChaosPubSub`` proxies and the router, the plan's network and
    ship-log faults, each replica killed once and respawned at its port."""
    import numpy as np

    from streambench_tpu_torch.chaos import (
        ChaosPubSub,
        FaultInjector,
        FaultPlan,
        FleetSupervisor,
        check_fleet_accounting,
        check_fleet_convergence,
        check_staleness_bound,
        ship_epoch_timeline,
    )
    from streambench_tpu_torch.dimensions.pubsub import PubSubClient
    from streambench_tpu_torch.dimensions.store import (
        LOG_NAME,
        DurableDimensionStore,
    )
    from streambench_tpu_torch.reach.replica import ReachReplica
    from streambench_tpu_torch.reach.router import ReachRouter
    from streambench_tpu_torch.utils.ids import now_ms

    t_phase = time.perf_counter()
    workdir = _workdir("smoke_fleet_chaos")
    camps = [f"fleet-c{i}" for i in range(8)]
    K, R = 64, 128

    def planes(epoch: int):
        rng = np.random.default_rng(seed * 1000 + epoch)
        mins = rng.integers(0, 1 << 32, size=(len(camps), K),
                            dtype=np.uint32)
        regs = rng.integers(0, 30, size=(len(camps), R)).astype(np.int32)
        return mins, regs

    # the clean arm: the fault-free ship log, written up front
    clean_dir = os.path.join(workdir, "fleet_clean")
    clean_store = DurableDimensionStore(clean_dir)
    for e in range(1, epochs_n + 1):
        m, r = planes(e)
        clean_store.put_reach_sketches(m, r, camps, e, submit_ms=now_ms(),
                                       folded_ms=now_ms())
    clean_store.close()
    # the chaos arm: a live writer at a cadence through the fault hook
    plan = FaultPlan.generate(
        seed, net_drop_rate=0.06, net_delay_rate=0.04, net_delay_ms=20,
        net_dup_rate=0.06, net_torn_rate=0.04, net_msgs=6000,
        partition_windows=((120, 30),), ship_rate=0.3, ship_ops=epochs_n)
    injector = FaultInjector(plan)
    chaos_dir = os.path.join(workdir, "fleet_chaos")
    chaos_store = DurableDimensionStore(chaos_dir)
    ship_filter = injector.attach_ship_chaos(chaos_store)
    chaos_log = os.path.join(chaos_dir, LOG_NAME)
    ship_lock = threading.Lock()
    last_epoch = {"e": 0}

    def ship(epoch: int) -> None:
        m, r = planes(epoch)
        with ship_lock:
            chaos_store.put_reach_sketches(m, r, camps, epoch,
                                           submit_ms=now_ms(),
                                           folded_ms=now_ms())
            last_epoch["e"] = max(last_epoch["e"], epoch)

    chaos_store.ship_fault_hook = None     # the boot record, intact
    ship(1)
    chaos_store.ship_fault_hook = ship_filter
    writer_stop = threading.Event()

    def writer() -> None:
        for e in range(2, epochs_n + 1):
            if writer_stop.wait(ship_gap_s):
                return
            ship(e)

    t_writer = threading.Thread(target=writer, daemon=True)
    rep_ports = [_free_port() for _ in range(replicas_n)]
    reps: dict = {}
    proxies: list = []
    kills: list = []

    class _Handle:
        """In-process stand-in for a replica process: a kill closes the
        live replica, drops its planes and severs its proxied
        connections; whether its plane tensors were freed is recorded."""

        def __init__(self, idx: int):
            self.idx = idx
            self.pid = os.getpid()
            self._code = None

        def poll(self):
            return self._code

        def kill(self):
            if self._code is not None:
                return
            rep = reps.pop(self.idx, None)
            if rep is not None:
                st = rep.server._state if rep.server is not None else None
                refs = (list(map(weakref.ref, st[:2])) if st is not None
                        else [])
                del st
                rep.close()
                del rep
                gc.collect()
                kills.append({"idx": self.idx, "planes": len(refs),
                              "freed": all(r() is None for r in refs)})
            proxies[self.idx].drop_conns()
            self._code = -9

        terminate = kill

    def spawn(idx: int, attempt: int):
        rep = ReachReplica(chaos_log, host="127.0.0.1",
                           port=rep_ports[idx], poll_ms=100,
                           max_staleness_ms=max_staleness_ms,
                           depth=256, batch=32, device=device).start()
        reps[idx] = rep
        return _Handle(idx)

    def on_restart(idx: int, attempt: int) -> None:
        # the restart-path forced ship: the respawned replica finds a
        # recent record instead of shedding stale until the cadence
        if last_epoch["e"]:
            ship(last_epoch["e"])

    sup = FleetSupervisor(spawn, replicas_n, backoff_base_ms=40.0,
                          backoff_cap_ms=400.0, max_restarts=5,
                          healthy_after_s=0.3, seed=seed,
                          on_restart=on_restart,
                          counters=injector.counters).start()
    for idx in range(replicas_n):
        proxies.append(ChaosPubSub(("127.0.0.1", rep_ports[idx]), injector,
                                   name=f"-r{idx}").start())
    watch_stop = threading.Event()

    def watch() -> None:
        while not watch_stop.is_set():
            sup.step()
            watch_stop.wait(0.05)

    t_watch = threading.Thread(target=watch, daemon=True)
    router = ReachRouter([f"{h}:{p}" for h, p in
                          (pr.address for pr in proxies)],
                         timeout_s=timeout_s, retries=1).start()
    r_host, r_port = router.address
    sent_ids: list = []
    replies: list = []
    stamped: list = []
    kill_at = {queries_n // 3: 0, (2 * queries_n) // 3: 1}
    rng = np.random.default_rng(seed)
    warm_s = []
    try:
        # warm each replica directly, off the proxies (no plan index spent)
        for idx in range(replicas_n):
            s = _ask_until_served("127.0.0.1", rep_ports[idx], camps[0],
                                  f"warm{idx}-", 60.0)
            if s is None:
                raise AssertionError(f"[fleet_chaos] replica {idx} never "
                                     "answered before the storm")
            warm_s.append(s)
        t_writer.start()
        t_watch.start()
        c = PubSubClient(r_host, r_port, timeout_s=120)
        t0 = time.monotonic()
        for qi in range(queries_n):
            idx = kill_at.get(qi)
            if idx is not None:
                sup.kill(idx)
            sel = sorted(camps[j] for j in rng.choice(
                len(camps), size=int(rng.integers(1, 4)), replace=False))
            qid = f"fc{qi}"
            submit_ms = now_ms()
            # the client's link to the router is clean: the router always
            # terminates a query, so ids stay one to one
            data = c.request({"type": "reach", "campaigns": sel,
                              "op": "overlap" if qi % 3 == 0 else "union",
                              "id": qid}, timeout_s=60.0)
            sent_ids.append(qid)
            replies.append(data)
            stamped.append((submit_ms, data))
            time.sleep(gap_s)
        storm_s = time.monotonic() - t0
        c.close()
        t_writer.join(timeout=60)
        # heal: respawns settle, then the clean close ship, twice (a
        # trailing torn stub eats one following append)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if all(sup.alive(i) for i in range(replicas_n)):
                break
            time.sleep(0.05)
        ship(epochs_n)
        ship(epochs_n)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            eps = [reps[i].server.epoch
                   if i in reps and reps[i].server is not None else None
                   for i in range(replicas_n)]
            if all(e == epochs_n for e in eps):
                break
            time.sleep(0.1)
        replica_epochs = [
            (reps[i].server.epoch
             if i in reps and reps[i].server is not None else None)
            for i in range(replicas_n)]
    finally:
        watch_stop.set()
        if t_watch.is_alive():
            t_watch.join(timeout=10)
        writer_stop.set()
        router.close()
        for rep in list(reps.values()):
            rep.close()
        for pr in proxies:
            pr.close()
        chaos_store.close()
    v = check_fleet_accounting(sent_ids, replies,
                               repro=f"chip_smoke.py phase 20 (b) "
                                     f"seed={seed}")
    check_staleness_bound(stamped, ship_epoch_timeline(chaos_log),
                          max_staleness_ms, verdict=v, slack_ms=50)
    check_fleet_convergence(chaos_log, replica_epochs,
                            clean_ship_path=os.path.join(clean_dir,
                                                         LOG_NAME),
                            verdict=v)
    rt = router.summary()
    proxy_stats: dict = {}
    for pr in proxies:
        for k2, n in pr.stats.items():
            proxy_stats[k2] = proxy_stats.get(k2, 0) + n
    sup_sum = sup.summary()
    out = {"seed": seed, "replicas": replicas_n, "epochs": epochs_n,
           "device": device, "sent": v.sent, "answered": v.answered,
           "shed": v.shed,
           "accounting_exact": not (v.duplicate_ids or v.missing_ids
                                    or v.unexpected_ids),
           "stale_violations": len(v.stale_violations),
           "max_staleness_ms": max_staleness_ms,
           "lagging_replicas": v.lagging_replicas,
           "bit_identical_final": not v.divergent,
           "writer_epoch": v.writer_epoch, "storm_s": storm_s,
           "warm_s": warm_s,
           "router": {k2: rt.get(k2) for k2 in
                      ("routed", "answered", "shed", "failovers",
                       "shed_ratio", "failover_p50_ms", "failover_p99_ms",
                       "qps")},
           "proxy": proxy_stats,
           "supervisor": {k2: sup_sum[k2] for k2 in
                          ("restarts", "kills", "gave_up")},
           "kills": kills, "faults": injector.counters.snapshot(),
           "phase_s": time.perf_counter() - t_phase}
    shutil.rmtree(workdir, ignore_errors=True)
    print(f"[fleet_chaos] {json.dumps(out)}", flush=True)
    if (not v.ok or sup_sum["restarts"] < replicas_n
            or rt.get("failovers", 0) < 1 or "failover_p99_ms" not in rt
            or len(kills) != replicas_n
            or not all(k["freed"] and k["planes"] == 2 for k in kills)):
        raise AssertionError(f"[fleet_chaos] {v.summary()}; supervisor "
                             f"{sup_sum}; router {rt}; kills {kills}")
    return out


def _qps_ramp_schedule(*, seed: int, duration_s: float, qps0: float,
                       qps1: float, ramp=(0.2, 0.7),
                       burst_rate_hz: float = 0.5,
                       burst_n: int = 8) -> list:
    """``bench_reach.py:qps_ramp_schedule``: seeded Poisson arrivals whose
    rate ramps ``qps0 -> qps1`` between the ``ramp`` fractions of the
    run, plus Poisson bursts of ``burst_n`` simultaneous arrivals."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = ramp
    t, out = 0.0, []
    while True:
        frac = min(t / duration_s, 1.0)
        if frac <= lo:
            rate = qps0
        elif frac >= hi:
            rate = qps1
        else:
            rate = qps0 + (qps1 - qps0) * (frac - lo) / (hi - lo)
        t += float(rng.exponential(1.0 / rate))
        if t >= duration_s:
            return out
        out.append(round(t, 4))
        if float(rng.random()) < burst_rate_hz / rate:
            out.extend([round(t, 4)] * (burst_n - 1))


def _fleet_autoscale(device: str, *, seed: int = 13,
                     duration_s: float = 14.0, tail_s: float = 7.0,
                     qps0: float = 6.0, qps1: float = 36.0,
                     burst_n: int = 24, camps_n: int = 16, K: int = 8192,
                     R: int = 4096, ship0_ms: int = 2000,
                     objective_staleness_ms: int = 1000,
                     objective_p99_ms: int = 15, max_replicas: int = 3,
                     clients: int = 16) -> dict:
    """20 (c): ``bench_reach.py:run_autoscale`` at its defaults on the
    port (module doc): one seeded ramp with bursts against in-process
    replicas on ``device``, without the controller and with it."""
    import numpy as np

    from streambench_tpu_torch.chaos import FleetSupervisor
    from streambench_tpu_torch.dimensions.pubsub import PubSubClient
    from streambench_tpu_torch.dimensions.store import (
        LOG_NAME,
        DurableDimensionStore,
    )
    from streambench_tpu_torch.obs import (
        AutoscaleController,
        FlightRecorder,
        MetricsRegistry,
        MetricsSampler,
        SpanTracer,
    )
    from streambench_tpu_torch.reach.replica import (
        ReachReplica,
        SnapshotShipper,
    )
    from streambench_tpu_torch.reach.router import ReachRouter
    from streambench_tpu_torch.utils.ids import now_ms

    t_phase = time.perf_counter()
    workdir = _workdir("smoke_fleet_autoscale")
    camps = [f"as-c{i}" for i in range(camps_n)]
    rng0 = np.random.default_rng(seed * 1000)
    mins0 = rng0.integers(0, 1 << 32, size=(len(camps), K),
                          dtype=np.uint32)
    regs0 = rng0.integers(0, 30, size=(len(camps), R)).astype(np.int32)
    objective = {"staleness_ms": objective_staleness_ms,
                 "p99_ms": objective_p99_ms}
    schedule = _qps_ramp_schedule(seed=seed, duration_s=duration_s,
                                  qps0=qps0, qps1=qps1, burst_n=burst_n)
    qrng = np.random.default_rng(seed + 1)
    qsets = [sorted(camps[j] for j in qrng.choice(
        len(camps), size=int(qrng.integers(2, 7)), replace=False))
        for _ in range(len(schedule))]
    fleet_dir = os.path.join(workdir, "autoscale_fleet")
    os.makedirs(fleet_dir)

    def arm(on: bool) -> dict:
        arm_dir = os.path.join(workdir, f"autoscale_{'on' if on else 'off'}")
        store = DurableDimensionStore(arm_dir)
        ship_log = os.path.join(arm_dir, LOG_NAME)
        shipper = SnapshotShipper(store, camps, interval_ms=ship0_ms)
        ship_lock = threading.Lock()
        folds = {"n": 0}
        writer_stop = threading.Event()

        def fold_tick(force: bool = False) -> None:
            # the epoch stays 1: due()'s epoch-bump bypass must not
            # defeat the cadence the controller tunes
            with ship_lock:
                folds["n"] += 1
                shipper.note_state(mins0, regs0, 1, watermark=folds["n"],
                                   force=force, folded_ms=now_ms())

        def writer() -> None:
            while not writer_stop.is_set():
                fold_tick()
                writer_stop.wait(0.2)

        rep_ports = [_free_port() for _ in range(max_replicas)]
        reps: dict = {}
        tracer = SpanTracer(capacity=8192) if on else None

        class _Handle:
            """In-process replica stand-in (as in (b))."""

            def __init__(self, idx: int):
                self.idx = idx
                self.pid = os.getpid()
                self._code = None

            def poll(self):
                return self._code

            def _stop(self, code: int) -> None:
                if self._code is not None:
                    return
                rep = reps.pop(self.idx, None)
                if rep is not None:
                    rep.close()
                self._code = code

            def kill(self):
                self._stop(-9)

            def terminate(self):
                self._stop(0)

        def spawn(idx: int, attempt: int):
            # cache off: under one epoch the result cache would absorb
            # the whole ramp; this rung loads the dispatch path
            rep = ReachReplica(ship_log, host="127.0.0.1",
                               port=rep_ports[idx], poll_ms=100,
                               max_staleness_ms=30_000, cache_capacity=0,
                               depth=2, batch=2, fleet=True, spans=tracer,
                               device=device).start()
            reps[idx] = rep
            return _Handle(idx)

        fold_tick(force=True)
        sup = FleetSupervisor(spawn, 1, backoff_base_ms=40.0,
                              backoff_cap_ms=400.0, healthy_after_s=0.3,
                              seed=seed).start()
        router = ReachRouter([f"127.0.0.1:{rep_ports[0]}"], timeout_s=5.0,
                             retries=1).start()
        r_host, r_port = router.address
        warm = _ask_until_served("127.0.0.1", rep_ports[0], camps[0],
                                 f"aswarm{int(on)}-", 60.0)
        if warm is None:
            raise AssertionError("[fleet_autoscale] the first replica "
                                 "never answered")
        ctrl = sampler = t_ctrl = None
        ctrl_stop = threading.Event()
        if on:
            registry = MetricsRegistry()
            ctrl_dir = os.path.join(fleet_dir, "controller")
            os.makedirs(ctrl_dir, exist_ok=True)
            sampler = MetricsSampler(os.path.join(ctrl_dir, "metrics.jsonl"),
                                     interval_ms=500, registry=registry,
                                     role="controller")
            flightrec = FlightRecorder(ctrl_dir)

            def collect():
                ts = now_ms()
                recs = []
                for idx, rep in list(reps.items()):
                    srv = rep.server
                    if srv is not None:
                        recs.append({"kind": "snapshot", "role": "replica",
                                     "pid": 1000 + idx, "ts_ms": ts,
                                     "reach_query": srv.summary()})
                recs.append({"kind": "snapshot", "role": "router",
                             "pid": os.getpid(), "ts_ms": ts,
                             "router": router.summary()})
                recs.append({"kind": "snapshot", "role": "writer",
                             "pid": os.getpid(), "ts_ms": ts,
                             "reach_ship": shipper.summary()})
                return recs

            def spawn_hook() -> bool:
                if len(sup.slots) >= len(rep_ports):
                    return False
                idx = sup.spawn()
                # a forced ship: the newcomer loads within one poll
                fold_tick(force=True)
                router.add_replica(f"127.0.0.1:{rep_ports[idx]}")
                return True

            def retire_hook() -> bool:
                for idx in range(len(sup.slots) - 1, 0, -1):
                    slot = sup.slots[idx]
                    if slot.retired or slot.gave_up or not sup.alive(idx):
                        continue
                    addr = f"127.0.0.1:{rep_ports[idx]}"
                    return sup.retire(
                        idx,
                        deregister=lambda i, a=addr: router.remove_replica(a),
                        drain_s=0.1, grace_s=2.0)
                return False

            ctrl = AutoscaleController(
                collect, objective=objective, spawn_replica=spawn_hook,
                retire_replica=retire_hook, shipper=shipper,
                min_ship_interval_ms=400, replicas=1, min_replicas=1,
                max_replicas=max_replicas, breach_ticks=2, healthy_ticks=4,
                cooldown_s=1.5, window_steps=6, sampler=sampler,
                flightrec=flightrec, registry=registry)

            def ctrl_loop() -> None:
                while not ctrl_stop.is_set():
                    with tracer.span("autoscale_step", cat="autoscale"):
                        dec = ctrl.step()
                    if dec is not None:
                        with tracer.span(f"autoscale_{dec['decision']}",
                                         cat="autoscale"):
                            pass
                        print(f"[fleet_autoscale] {dec['decision']} "
                              f"[{dec['verdict']}->{dec['knob']}] "
                              f"replicas={dec['replicas']}", flush=True)
                    ctrl_stop.wait(0.25)

            t_ctrl = threading.Thread(target=ctrl_loop, daemon=True)
            sampler.add_collector(lambda rec, dt_s: rec.__setitem__(
                "autoscale", ctrl.summary()))
            sampler.start()
        t_writer = threading.Thread(target=writer, daemon=True)
        results: list = []
        res_lock = threading.Lock()
        pos = {"i": 0}
        rep_finals: dict = {}
        try:
            t_writer.start()
            if t_ctrl is not None:
                t_ctrl.start()
            t0 = time.monotonic()

            def client_worker() -> None:
                c = PubSubClient(r_host, r_port, timeout_s=60)
                while True:
                    with res_lock:
                        i = pos["i"]
                        pos["i"] += 1
                    if i >= len(schedule):
                        break
                    wait = t0 + schedule[i] - time.monotonic()
                    if wait > 0:
                        time.sleep(wait)
                    submit = time.perf_counter()
                    try:
                        data = c.request(
                            {"type": "reach", "campaigns": qsets[i],
                             "op": "overlap" if i % 3 == 0 else "union",
                             "id": f"as{int(on)}-{i}"}, timeout_s=30.0)
                    except (TimeoutError, ConnectionError, OSError) as e:
                        data = {"error": f"transport:{e!r}"}
                    e2e_ms = (time.perf_counter() - submit) * 1000.0
                    with res_lock:
                        results.append((i, e2e_ms, data))
                c.close()

            workers = [threading.Thread(target=client_worker, daemon=True)
                       for _ in range(clients)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=duration_s + 90)
            storm_s = time.monotonic() - t0
            if on:
                # the post-ramp tail: traffic stops, the writer folds on,
                # and the controller may go healthy and retire
                deadline = time.monotonic() + tail_s
                while time.monotonic() < deadline:
                    if ctrl.actions.get("scale_down"):
                        break
                    time.sleep(0.2)
        finally:
            ctrl_stop.set()
            if t_ctrl is not None and t_ctrl.is_alive():
                t_ctrl.join(timeout=10)
            writer_stop.set()
            if t_writer.is_alive():
                t_writer.join(timeout=10)
            if sampler is not None:
                sampler.close(final={"autoscale": ctrl.summary()})
            for idx, rep in list(reps.items()):
                if rep.server is not None:
                    rep_finals[idx] = rep.server.summary()
            router.close()
            sup.stop(grace_s=2.0)
            for rep in list(reps.values()):
                rep.close()
            store.close()
        answered = shed = breaches = stale_breaches = lat_breaches = 0
        lat: list = []
        stales: list = []
        for _, e2e_ms, data in results:
            if data.get("shed"):
                shed += 1
                breaches += 1
                continue
            if data.get("error"):
                breaches += 1
                continue
            answered += 1
            lat.append(e2e_ms)
            st = data.get("staleness_ms")
            if isinstance(st, (int, float)):
                stales.append(float(st))
                if st > objective_staleness_ms:
                    stale_breaches += 1
                    breaches += 1
            if e2e_ms > objective_p99_ms:
                lat_breaches += 1
        stales.sort()
        lat.sort()
        rt = router.summary()
        res = {"sent": len(results), "answered": answered, "shed": shed,
               "breaches": breaches, "stale_breaches": stale_breaches,
               "lat_breaches": lat_breaches,
               "breach_ratio": (breaches / len(results) if results
                                else None),
               "staleness_p50_ms": (stales[len(stales) // 2]
                                    if stales else None),
               "staleness_p99_ms": (stales[min(len(stales) - 1, int(
                   len(stales) * 0.99))] if stales else None),
               "e2e_p50_ms": lat[len(lat) // 2] if lat else None,
               "e2e_p99_ms": (lat[min(len(lat) - 1, int(len(lat) * 0.99))]
                              if lat else None),
               "storm_s": storm_s, "warm_s": warm,
               "router": {k: rt.get(k) for k in
                          ("routed", "answered", "shed", "failovers",
                           "shed_ratio", "failover_p99_ms", "e2e_p50_ms",
                           "e2e_p99_ms", "qps")},
               "ship_interval_final_ms": shipper.interval_ms,
               "ships": shipper.ships}
        if on:
            sup_sum = sup.summary()
            res["controller"] = ctrl.summary()
            res["decisions"] = [
                {k: d.get(k) for k in ("decision", "verdict", "knob",
                                       "replicas", "step", "from_ms",
                                       "to_ms", "evidence") if k in d}
                for d in ctrl.decisions]
            res["replicas_max"] = len(sup.slots)
            res["retired"] = sup_sum["retired"]
            res["replica_finals"] = len(rep_finals)
            tracer.dump(os.path.join(fleet_dir, "trace_controller.json"),
                        run="autoscale")
        return res

    off = arm(False)
    on = arm(True)
    out = {"seed": seed, "device": device, "duration_s": duration_s,
           "tail_s": tail_s, "qps0": qps0, "qps1": qps1,
           "ramp_x": qps1 / qps0, "schedule_n": len(schedule),
           "objective": objective, "ship0_ms": ship0_ms, "K": K, "R": R,
           "off": off, "on": on,
           "breach_ratio_off": off["breach_ratio"],
           "breach_ratio_on": on["breach_ratio"],
           "decisions": on["controller"]["decisions"],
           "phase_s": time.perf_counter() - t_phase}
    shutil.rmtree(workdir, ignore_errors=True)
    print(f"[fleet_autoscale] {json.dumps(out)}", flush=True)
    missing = [d for d in on["decisions"]
               if not (d.get("evidence") or {}).get("hop_p99_ms")]
    if (off["breach_ratio"] is None or on["breach_ratio"] is None
            or not on["breach_ratio"] < off["breach_ratio"]
            or on["controller"]["scale_ups"] < 1
            or not on["decisions"] or missing):
        raise AssertionError(
            f"[fleet_autoscale] breach ratio {off['breach_ratio']} -> "
            f"{on['breach_ratio']}, controller {on['controller']}, "
            f"decisions without freshness-hop evidence {missing[:2]}")
    return out


def phase_fleet(device: str = "cuda", scaleout: dict | None = None,
                chaos: dict | None = None,
                autoscale: dict | None = None) -> dict:
    """Phase 20: the replica fleet (module doc).  ``device`` and the
    rungs' sizes are arguments so the phase can be rehearsed on the CPU
    at a small size; the smoke runs the reference's three fleet rungs at
    their own parameters on ``cuda``."""
    t0 = time.perf_counter()
    _reset_launches()                     # this path starts here
    out = {"scaleout": _fleet_scaleout(
        device, **(FLEET_SCALEOUT if scaleout is None else scaleout))}
    out["chaos"] = _fleet_chaos(device,
                                **(FLEET_CHAOS if chaos is None else chaos))
    out["autoscale"] = _fleet_autoscale(
        device, **(FLEET_AUTOSCALE if autoscale is None else autoscale))
    out["kernel_launches"] = _launches()  # this path ends here
    out["phase_s"] = time.perf_counter() - t0
    a, b, c = out["scaleout"], out["chaos"], out["autoscale"]
    print(f"[fleet] (a) off-writer contention "
          f"{a['offwriter_contention_ratio']:.4f} at ingest duty "
          f"{a['ingest_busy_duty']:.4f}; staleness p50/p99 "
          + ", ".join(f"{k} {r['staleness_p50_ms']}/{r['staleness_p99_ms']}"
                      " ms" for k, r in a["ladder"].items())
          + "; ready (line, first answer) s "
          + ", ".join(f"{k} {[(x['ready_line_s'], x['first_answer_s']) for x in r['ready']]}"
                      for k, r in a["ladder"].items())
          + f"; respawn to answer {a['memory'].get('respawn_to_answer_s')} s"
          f"; peak device bytes per replica "
          + ", ".join(f"{k} {r['peak_device_bytes']}"
                      for k, r in a["ladder"].items())
          + f", writer {a['writer_peak_device_bytes']}; memory {a['memory']}"
          f"; (b) {b['answered']} answered + {b['shed']} shed = "
          f"{b['sent']} sent, {b['supervisor']['restarts']} restarts, "
          f"failover p99 {b['router']['failover_p99_ms']} ms, shed ratio "
          f"{b['router']['shed_ratio']}, final record bit-identical; (c) "
          f"breach ratio {c['breach_ratio_off']:.4f} -> "
          f"{c['breach_ratio_on']:.4f}, {c['decisions']} decisions, "
          f"{c['on']['controller']['scale_ups']} scale-ups; launches "
          f"{out['kernel_launches']}; {out['phase_s']:.1f} s", flush=True)
    if any(v for v in out["kernel_launches"].values()):
        raise AssertionError(f"[fleet] a kernel launched on the fleet "
                             f"path: {out['kernel_launches']}")
    return out


def _fleet_launches(fleet: dict, kernel: str) -> dict:
    """A kernel's launches on phase 20's path, in this process (the
    replica processes of (a) launch no hand-written kernel either)."""
    return {"fleet": fleet["kernel_launches"][kernel]}


# ---------------------------------------------------------------------
# phase 21: the hyper-extended HLL engine (M14) and sharded reach (M16c)

# 21 (a)'s ops rung: bench_sketch.py:run_hllx (:318) at the reference
# bench's own size (:408)
HLLX_OPS = {"campaigns": 8, "groups": 8, "registers": 128,
            "keys": 150_000, "extra": 300_000, "cap": 120,
            "batch": 65_536, "seed": 5, "order_seed": 9}
# the reference's estimator bounds, tests/test_hllx.py:180-225
HLLX_DISTINCT_BOUND = 0.2
HLLX_LOGM_BOUND = 0.15
HLLX_PROFILE_EVENTS = 4 * 8 * 8192      # four packed-scan dispatches
# 21 (b): phase 19's journal alone, in a topic of its own (19 (e)
# appended its tail to the main one)
REACH21_TOPIC = "reach-sharded"


def _zipf_stream(n_keys: int, extra_events: int, seed: int):
    """``bench_sketch.py:zipf_stream`` (:98): every key once plus a
    Zipf(0.9) head of extra weight.  Returns (keys, weights) shuffled and
    the exact counts in key order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    p = ranks ** -0.9
    p /= p.sum()
    counts = 1 + np.floor(extra_events * p).astype(np.int64)
    keys = np.arange(n_keys, dtype=np.int32)
    order = rng.permutation(n_keys)
    return keys[order], counts[order].astype(np.int32), counts


def _hllx_ops_rung(device: str) -> dict:
    """21 (a): ``bench_sketch.py:run_hllx`` on the port's ops: 150,000
    Zipf keys with 300,000 extra events, each key's count capped at 120,
    folded as distinct (user, time) tokens over C = 8 campaigns (key mod
    8), G = 8 rungs, R = 128, in B = 65,536-row batches.  The distinct
    and log-moment mean relative errors against the exact statistics of
    each campaign's own keys under the reference test's bounds, F1
    exact."""
    import numpy as np
    import torch

    from streambench_tpu_torch.ops import hllx

    o = HLLX_OPS
    C, G, R, B = o["campaigns"], o["groups"], o["registers"], o["batch"]
    keys, weights, counts = _zipf_stream(o["keys"], o["extra"], o["seed"])
    weights = np.minimum(weights, o["cap"]).astype(np.int32)
    counts = np.minimum(counts, o["cap"])
    camp_of = (keys.astype(np.int64) % C).astype(np.int32)
    rep_keys = np.repeat(keys, weights)
    rep_camp = np.repeat(camp_of, weights)
    rep_time = (10 * np.arange(rep_keys.size)).astype(np.int32)
    order = np.random.default_rng(o["order_seed"]).permutation(
        rep_keys.size)
    n = rep_keys.size
    pad = (-n) % B

    def cols(a):
        return torch.from_numpy(np.pad(a[order], (0, pad))).to(
            device).view(-1, B)

    ad, user, tm = cols(rep_camp), cols(rep_keys), cols(rep_time)
    valid = torch.from_numpy(np.arange(n + pad) < n).to(device).view(-1, B)
    etype = torch.zeros(B, dtype=torch.int32, device=device)
    join = torch.tensor(list(range(C)) + [-1], dtype=torch.int32,
                        device=device)
    st = hllx.init_state(C, G, R, device=device)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(ad.shape[0]):
        st = hllx.step(st, join, ad[i], user[i], etype, tm[i], valid[i])
    _sync(device)
    fold_s = time.perf_counter() - t0
    m = {k: v.cpu().numpy() for k, v in hllx.moments(st).items()}
    errs_d, errs_l = [], []
    key_camp = np.arange(o["keys"]) % C       # counts are in key order
    for c in range(C):
        cs = counts[key_camp == c]
        errs_d.append(abs(float(m["distinct"][c]) - cs.size) / cs.size)
        true_l = float(np.log2(1 + cs).sum())
        errs_l.append(abs(float(m["log_moment"][c]) - true_l) / true_l)
    out = {"events": int(n), "batches": int(ad.shape[0]), "campaigns": C,
           "groups": G, "registers": R, "batch": B,
           "fold_s": fold_s, "events_per_s": n / fold_s,
           "distinct_rel_err_mean": float(np.mean(errs_d)),
           "distinct_rel_err_max": float(np.max(errs_d)),
           "log_moment_rel_err_mean": float(np.mean(errs_l)),
           "log_moment_rel_err_max": float(np.max(errs_l)),
           "f1_exact": int(m["totals"].sum()) == int(n)}
    print(f"[hllx_ops] {json.dumps(out)}", flush=True)
    if not (out["f1_exact"]
            and out["distinct_rel_err_max"] < HLLX_DISTINCT_BOUND
            and out["log_moment_rel_err_max"] < HLLX_LOGM_BOUND):
        raise AssertionError(f"[hllx_ops] {out}")
    return out


def _hllx_profile(data: Config5Data, device: str) -> dict:
    """X8's numbers: one packed-scan dispatch of the hllx fold under the
    profiler, over the first HLLX_PROFILE_EVENTS events."""
    cfg = data.config()
    return _scan_profile("hllx_profile",
                         _sketch_engine("hllx", cfg, data, None, device),
                         data.broker.reader(cfg.kafka_topic), device,
                         HLLX_PROFILE_EVENTS)


def _hllx_run(sk: dict, device: str) -> tuple:
    """21 (a) in this process: the hllx engine at the CLI's defaults (G =
    8, R = 128, phase 15's stock 100 campaigns) over phase 15's journal,
    timed after a warm engine; F1 against the journal's views; the same
    engine on the CPU (registers and totals bit-identical, moments within
    rtol 1e-6); a resume equal to the uninterrupted run; the
    ``<hashtable>_hllx`` rows; K1-K3 0 launches.  Returns (result, the
    card's registers, its totals)."""
    import numpy as np

    data = sk["data"]
    _reset_launches()                     # this path starts here
    res, r, eng = _sketch_catchup("hllx", "hllx", data, device)
    launches = _launches()                # this path ends here
    regs = eng.state.registers.cpu().numpy()
    totals = eng.state.totals.cpu().numpy()
    m = eng.moments()
    table = r.hgetall(f"{eng.cfg.redis_hashtable}_hllx")
    seen = int((totals > 0).sum())
    res.update(kernel_launches=launches,
               device_scan_ms=res["stages"].get("device_scan", {}).get(
                   "total_ms"),
               f1=int(totals.sum()), views=sk["views"], rows=len(table),
               campaigns_seen=seen,
               distinct_total=float(m["distinct"].sum()),
               log_moment_total=float(m["log_moment"].sum()))
    del eng, r
    ref_res, _, ref = _sketch_catchup("hllx_cpu", "hllx", data, "cpu")
    rm = ref.moments()
    res["cpu_equal"] = bool(
        np.array_equal(ref.state.registers.numpy(), regs)
        and np.array_equal(ref.state.totals.numpy(), totals))
    res["cpu_moments_max_rel_err"] = max(
        float(np.max(np.abs(m[k] - rm[k])
                     / np.maximum(np.abs(rm[k]), 1e-30)))
        for k in ("distinct", "softcap", "log_moment"))
    res["cpu_catchup_with_close_s"] = ref_res["catchup_with_close_s"]
    del ref
    res_r, _, b = _sketch_resume("hllx_resume", "hllx", data, device)
    res["resume"] = dict(res_r, equal=bool(
        np.array_equal(b.state.registers.cpu().numpy(), regs)
        and np.array_equal(b.state.totals.cpu().numpy(), totals)))
    del b
    res["profile"] = _hllx_profile(data, device)
    brief = {k: v for k, v in res.items() if k not in ("stages", "profile")}
    print(f"[hllx] {json.dumps(brief)}", flush=True)
    bad = [k for k, ok in (
        ("f1", res["f1"] == sk["views"]),
        ("launches", not any(launches.values())),
        ("cpu_equal", res["cpu_equal"]),
        ("cpu_moments", res["cpu_moments_max_rel_err"] <= 1e-6),
        ("resume", res["resume"]["equal"]),
        ("rows", len(table) == 11 * seen and sum(
            int(v) for k, v in table.items() if k.endswith(":views"))
         == sk["views"])) if not ok]
    if bad:
        raise AssertionError(f"[hllx] failed {bad}: {res}")
    return res, regs, totals


def _hllx_cli_start(data: Config5Data, device: str) -> dict:
    """21 (a): ``python -m streambench_tpu_torch.engine --engine hllx
    --catchup --checkpointDir D`` over phase 15's journal, started in the
    background (its conf a file of its own: this process rewrites the
    workdir's ``benchmarkConf.yaml``)."""
    data.config()
    conf = os.path.join(data.workdir, "hllx_cli.yaml")
    shutil.copyfile(os.path.join(data.workdir, "benchmarkConf.yaml"), conf)
    ckdir = os.path.join(data.workdir, "ckpt_hllx_cli")
    out_path = os.path.join(data.workdir, "hllx_cli.out")
    err_path = os.path.join(data.workdir, "hllx_cli.err")
    with open(out_path, "w") as fo, open(err_path, "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "streambench_tpu_torch.engine",
             "--confPath", conf, "--workdir", data.workdir, "--catchup",
             "--engine", "hllx", "--device", device, "--checkpointDir",
             ckdir], env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
            stdout=fo, stderr=fe)
    return {"proc": proc, "ckdir": ckdir, "out": out_path, "err": err_path,
            "t0": time.perf_counter()}


def _hllx_cli_finish(run: dict, data: Config5Data, regs, totals) -> dict:
    """Wait for the hllx CLI: exit 0, every event folded, K1-K3 0
    launches in its stats line, and its exit snapshot's registers and
    totals those of the in-process run."""
    import numpy as np

    from streambench_tpu_torch.checkpoint import Checkpointer

    proc = run["proc"]
    try:
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall_s = time.perf_counter() - run["t0"]
    lines = open(run["out"]).read().strip().splitlines()
    err = open(run["err"]).read()
    if rc != 0 or not lines:
        raise AssertionError(f"[hllx_cli] exited {rc}: {err[-2000:]}")
    stats = json.loads(lines[-1])
    up = next((ln for ln in lines if ln.startswith("engine up:")), "")
    snap = Checkpointer(run["ckdir"]).load()
    if snap is None:
        raise AssertionError("[hllx_cli] no snapshot at exit")
    out = {"rc": rc, "engine_up": up, "events": stats["events"],
           "events_per_s": stats["events_per_s"],
           "kernel_launches": stats["kernel_launches"],
           "snapshot_events": snap.meta.get("events_processed"),
           "equal": bool(np.array_equal(snap.extra["hllx_registers"], regs)
                         and np.array_equal(snap.extra["hllx_totals"],
                                            totals)),
           "wall_s": wall_s}
    print(f"[hllx_cli] {json.dumps(out)}", flush=True)
    if (stats["events"] != data.events or "engine=hllx" not in up
            or any(stats["kernel_launches"].values())
            or not out["equal"]):
        raise AssertionError(f"[hllx_cli] {out}")
    return out


def _reach_sharded(kept: dict, device: str) -> dict:
    """21 (b) in this process: ``ShardedReachEngine`` on a (1, 1) mesh
    (NCCL on the card) over phase 19's journal at the large rung: planes
    bit-identical to 19's engine's (the oracle's); 19 (b)'s 512 queries
    through ``batch_query`` and through a ``ReachQueryServer`` with the
    sharded evaluator installed, each answer equal to the unsharded
    ``batch_query``'s; 2 recorded collectives a query dispatch; one
    dispatch's device ms between CUDA events and its device operations
    (X9); K1-K3 0 launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from streambench_tpu_torch.engine import StreamRunner
    from streambench_tpu_torch.ops import minhash
    from streambench_tpu_torch.parallel import (
        ShardedReachEngine,
        build_mesh,
        collectives,
    )
    from streambench_tpu_torch.parallel.reach import reach_query
    from streambench_tpu_torch.reach import query as rq
    from streambench_tpu_torch.reach.serve import ReachQueryServer

    data = kept["data"]
    names = list(data.campaigns)
    t0 = time.perf_counter()
    with open(data.journal, "rb") as f, data.broker.writer(
            REACH21_TOPIC, append=False) as w:
        # whole lines only: the writer ends every append with a newline
        for lines in iter(lambda: f.readlines(1 << 24), []):
            w.append_bytes(b"".join(lines))
    cfg = data.config({"kafka.topic": REACH21_TOPIC})
    out: dict = {"topic_s": time.perf_counter() - t0}
    mesh = build_mesh(1, 1, device=device)
    try:
        out.update(mesh=repr(mesh), backend=mesh.backend)

        def make():
            return ShardedReachEngine(cfg, data.mapping, mesh,
                                      campaigns=names, k=REACH_K,
                                      registers=REACH_R, device=device)

        warm = make()
        warm.warmup()
        warm.close()
        del warm
        engine = make()
        reader = data.broker.reader(REACH21_TOPIC)
        _sync(device)
        _reset_peak(device)
        _reset_launches()                 # this path starts here
        t1 = time.perf_counter()
        stats = StreamRunner(engine, reader).run_catchup()
        run_s = time.perf_counter() - t1
        _sync(device)
        launches = _launches()            # this path ends here
        reader.close()
        stages = engine.tracer.as_dict()
        out.update(events=stats.events, run_catchup_s=run_s,
                   events_per_s=stats.events / run_s,
                   unsharded_events_per_s=kept["ev"],
                   device_scan_ms=stages.get("device_scan", {}).get(
                       "total_ms"),
                   peak_allocated_bytes=_peak(device),
                   kernel_launches=launches)
        _planes_equal("sharded_catchup", engine, kept["mins"], kept["regs"])
        out["planes_equal_phase19"] = True

        # 19 (b)'s 512 queries, unsharded on the oracle's planes (19's
        # engine's) and next to the shards, two dispatches each
        qb = rq.DEFAULT_BATCH
        masks, overlap = _make_queries(REACH_QUERIES, len(names),
                                       REACH_SEED + 1)
        mins_t = minhash.mins_tensor(kept["mins"], device)
        regs_t = torch.from_numpy(kept["regs"]).to(device)
        want = rq.query_chunks(mins_t, regs_t, masks, overlap, batch=qb)
        rec = collectives.Recorder()
        engine._recorder = rec
        try:
            parts = [engine.batch_query(masks[i:i + qb], overlap[i:i + qb])
                     for i in range(0, REACH_QUERIES, qb)]
        finally:
            engine._recorder = None
        got = [np.concatenate(x) for x in zip(*parts)]
        dispatches = len(parts)
        out.update(
            queries=REACH_QUERIES, dispatches=dispatches,
            collectives_per_dispatch=len(rec.ops) / dispatches,
            collective_kinds=sorted({op.kind for op in rec.ops}),
            collective_bytes_per_dispatch=sum(
                op.payload_bytes for op in rec.ops) / dispatches,
            answers_equal_unsharded=all(
                np.array_equal(a, b) for a, b in zip(got, want)))
        # the two all-reduces of one dispatch, each between CUDA events
        # on the card: the collectives' share of X9
        rep = engine.collective_report(k=1, timed=device == "cuda",
                                       query_batch=qb)["query"]
        out["report_query"] = rep["per_dispatch"]
        out["query_collectives_device_ms"] = rep.get("device_ms",
                                                     "not measured")

        # X9: one dispatch next to the shards on device tensors
        m_dev = torch.from_numpy(masks[:qb]).to(device)
        o_dev = torch.from_numpy(overlap[:qb]).to(device)
        st, axes = engine.state, engine._axes

        t = _query_timing(
            lambda: reach_query(st.mins, st.registers, m_dev, o_dev, axes),
            lambda: engine.batch_query(masks[:qb], overlap[:qb]), device)
        out.update(query_device_ms=t["device_ms"],
                   unsharded_query_device_ms=kept["x7_device_ms"],
                   query_call_ms=t["call_ms"],
                   query_device_ops=t["device_ops"])

        # the query server with the sharded evaluator installed
        srv = ReachQueryServer(names, depth=2 * REACH_QUERIES, batch=qb)
        engine.attach_reach(srv)
        replies: dict = {}
        done = threading.Event()

        def reply(d):
            replies[d.get("id")] = d
            if len(replies) == REACH_QUERIES:
                done.set()

        try:
            for i in range(REACH_QUERIES):
                srv.submit([names[j] for j in np.flatnonzero(masks[i])],
                           "overlap" if overlap[i] else "union", reply,
                           query_id=i)
            done.wait(120)
        finally:
            srv.close()
        est, _, _, agree = want
        served = [replies.get(i, {}) for i in range(REACH_QUERIES)]
        out["server"] = {
            "served": sum("estimate" in d for d in served),
            "dispatches": srv.dispatches,
            "sharded_evaluator": srv._query_fn == engine.query_callable(),
            "answers_equal_unsharded": all(
                d.get("estimate") == round(float(est[i]), 2)
                and round(d.get("jaccard", -1) * REACH_K) == int(agree[i])
                for i, d in enumerate(served))}
        engine.close()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[reach_sharded] {json.dumps(out)}", flush=True)
    bad = [k for k, ok in (
        ("events", out["events"] == data.events),
        ("launches", not any(launches.values())),
        ("answers", out["answers_equal_unsharded"]),
        ("collectives", out["collectives_per_dispatch"] == 2
         and out["collective_kinds"] == ["all-reduce"]
         and out["report_query"]["ops"] == 2),
        ("server", out["server"]["served"] == REACH_QUERIES
         and out["server"]["sharded_evaluator"]
         and out["server"]["answers_equal_unsharded"]),
        # X9's record: on the card every number was measured
        ("x9", device != "cuda" or all(
            isinstance(out[k], (int, float)) for k in (
                "query_device_ms", "query_device_ops",
                "query_collectives_device_ms")))) if not ok]
    if bad:
        raise AssertionError(f"[reach_sharded] failed {bad}: {out}")
    return out


def phase_hllx_reach(sk: dict, reach: dict, device: str = "cuda") -> dict:
    """Phase 21 (module doc): (b) sharded reach and (a) the hllx engine in
    this process, then the two engine CLIs side by side, each its own
    process (the sharded reach CLI beside a replica process).  ``sk`` and
    ``reach`` are what phases 15 and 19 kept; removes both journals.
    ``device`` is an argument so the phase can be rehearsed on the CPU
    (gloo) at a small size."""
    t0 = time.perf_counter()
    out: dict = {}
    try:
        out["sharded_reach"] = _reach_sharded(reach, device)
        out["hllx"], regs, totals = _hllx_run(sk, device)
        out["hllx_ops"] = _hllx_ops_rung(device)
        hllx_cli = _hllx_cli_start(sk["data"], device)
        box: dict = {}

        def reach_cli() -> None:
            try:
                box["out"] = _reach_cli(reach["data"], reach["sets"],
                                        device, sharded=True)
            except BaseException as e:     # re-raised on this thread
                box["error"] = e

        th = threading.Thread(target=reach_cli, name="sharded-reach-cli")
        th.start()
        try:
            out["hllx_cli"] = _hllx_cli_finish(hllx_cli, sk["data"], regs,
                                               totals)
        finally:
            th.join()
        if "error" in box:
            raise box["error"]
        out["sharded_reach_cli"] = box["out"]
    finally:
        sk["data"].remove()
        reach["data"].remove()
    out["phase_s"] = time.perf_counter() - t0
    h, b, ops = out["hllx"], out["sharded_reach"], out["hllx_ops"]
    print(f"[hllx_reach] (a) hllx {h['events_per_s']:.0f} ev/s "
          f"({h['events_per_s_with_close']:.0f} with close), device_scan "
          f"{h['device_scan_ms']} ms, peak {h['peak_allocated_bytes']} B, "
          f"F1 {h['f1']} = views, registers equal the CPU run's, moments "
          f"within {h['cpu_moments_max_rel_err']}; X8 "
          f"{h['profile']['device_ops_per_dispatch']} device ops and "
          f"{h['profile']['device_ms_per_dispatch']} device ms a dispatch; "
          f"ops rung {ops['events']} events, errors distinct "
          f"{ops['distinct_rel_err_mean']:.4f}, log moment "
          f"{ops['log_moment_rel_err_mean']:.4f}; CLI "
          f"{out['hllx_cli']['events_per_s']} ev/s.  (b) sharded reach "
          f"{b['events_per_s']:.0f} ev/s [phase 19 "
          f"{b['unsharded_events_per_s']:.0f}], "
          f"planes equal 19's, 512 answers equal, "
          f"{b['collectives_per_dispatch']} collectives a dispatch; X9 "
          f"{b['query_device_ms']} device ms [X7 "
          f"{b['unsharded_query_device_ms']}], {b['query_device_ops']} "
          f"device ops; CLI + replica agree exact; {out['phase_s']:.1f} s",
          flush=True)
    return out


def _hllx_reach_launches(p21: dict, kernel: str) -> dict:
    """A kernel's launches on phase 21's paths (none launches a
    hand-written kernel): the hllx catchup and CLI, the sharded reach
    catchup and CLI."""
    return {"hllx_catchup": p21["hllx"]["kernel_launches"][kernel],
            "hllx_cli": p21["hllx_cli"]["kernel_launches"][kernel],
            "sharded_reach_catchup":
                p21["sharded_reach"]["kernel_launches"][kernel],
            "sharded_reach_cli":
                p21["sharded_reach_cli"]["kernel_launches"][kernel]}


# ----------------------------------------------------------------------
# Phase 22: the fork's count-window micro-batch mode (M15a) with the
# columnar handoff, and the dimensional-aggregation family (M15b).

# (a): the stock conf/benchmarkConf.yaml (window.size 5000 over
# map.partitions 3: 1,666 events a partition a window), 300 windows
MB_EVENTS = 1_500_000
MB_SEED = 71
MB_CHECKPOINT_EVERY = 64
MB_STOP_AT = 100                   # the interrupted run's max_windows
MB_REDIS_WINDOWS = 30              # the Redis-barrier run's windows
MB_CPU_WINDOWS = 100               # the CPU twins' windows
MB_FOLD_CALLS = 50                 # eager fold calls timed
# (c): the Apex synthetic generator's 1M campaigns
# (DimensionTupleGenerateOperator.java:16) into a 2^20-key space
DIMS_EVENTS = 2_000_000
DIMS_CAMPAIGNS = 1_000_000
DIMS_KEYS = 1 << 20
DIMS_SLOTS = 16
DIMS_BATCH = 8192
DIMS_SEED = 5
DIMS_CLI_EVENTS = 100_000
# a view's ad and event time in the generator's wire format (the field
# order of gen.EventSource: user_id, page_id, ad_id, ad_type, event_type,
# event_time, ip_address)
MB_RE = re.compile(rb'"ad_id": "([^"]*)", "ad_type": "[^"]*", '
                   rb'"event_type": "view", "event_time": "(-?\d+)"')


class _ThreadLocalResp:
    """One RESP connection a thread to one server (each of the fork's
    partitions holds its own): the ``RedisLike`` calls the window barrier
    makes."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._local = threading.local()
        self._all: list = []
        self._lock = threading.Lock()

    def _client(self):
        c = getattr(self._local, "client", None)
        if c is None:
            from streambench_tpu_torch.io.resp import RespClient

            c = self._local.client = RespClient(self.host, self.port)
            with self._lock:
                self._all.append(c)
        return c

    def execute(self, *args):
        return self._client().execute(*args)

    def pipeline_execute(self, commands):
        return self._client().pipeline_execute(commands)

    def hgetall(self, key: str) -> dict:
        return self._client().hgetall(key)

    def hget(self, key: str, field: str):
        return self._client().hget(key, field)

    def close(self) -> None:
        for c in self._all:
            c.close()


class MicroBatchData:
    """Phase 22's dataset: the generator's journal at the stock
    configuration, generated on one partition (the native formatter's
    fast path) and kept whole as the topic ``STREAM_TOPIC`` (10 ms apart:
    (c)'s app folds it), then split round-robin over ``map.partitions``
    partitions of the configured topic as ``gen.do_setup(partitions=3)``
    writes it (event ``n`` to partition ``n % 3``); and its goldens by one
    regex pass over each partition's bytes: the views a window per
    campaign, and the views per (campaign, 10 s bucket)."""

    STREAM_TOPIC = "dims-events"


    def __init__(self, events: int = MB_EVENTS, seed: int = MB_SEED):
        import numpy as np

        self.workdir = _workdir("smoke_microbatch")
        self.cfg = _config(self.workdir)
        self.events = events
        (self.broker, self.mapping, self.campaigns, _,
         self.generate_s) = _generate(self.workdir, self.cfg, events, seed,
                                      store=False)
        t0 = time.perf_counter()
        topic, P = self.cfg.kafka_topic, self.cfg.map_partitions
        stream = self.broker.topic_path(self.STREAM_TOPIC, 0)
        os.replace(self.broker.topic_path(topic, 0), stream)
        with open(stream, "rb") as f:
            lines = f.read().split(b"\n")[:-1]
        for p in range(P):
            with open(self.broker.topic_path(topic, p), "wb") as f:
                f.write(b"\n".join(lines[p::P]) + b"\n")
        del lines
        self.psize = self.cfg.window_size // P
        index = {c: i for i, c in enumerate(self.campaigns)}
        ad_campaign = {a.encode(): index[c] for a, c in self.mapping.items()}
        C = len(self.campaigns)
        per_part, views = [], []
        for p in range(P):
            with open(self.broker.topic_path(topic, p), "rb") as f:
                blob = f.read()
            nl = np.flatnonzero(np.frombuffer(blob, np.uint8) == 10)
            # byte bounds of the partition's whole windows, then its tail
            bounds = [0] + (nl[self.psize - 1::self.psize] + 1).tolist()
            counts = []
            for k, lo in enumerate(bounds):
                hi = bounds[k + 1] if k + 1 < len(bounds) else len(blob)
                found = MB_RE.findall(blob, lo, hi)
                camp = np.asarray([ad_campaign[a] for a, _ in found],
                                  np.int64)
                views.append(np.stack([camp, np.asarray(
                    [int(t) for _, t in found], np.int64)], 1).reshape(-1, 2))
                if k + 1 < len(bounds):
                    counts.append(np.bincount(camp, minlength=C))
            per_part.append(counts)
        self.views = np.concatenate(views)
        self.windows = min(len(counts) for counts in per_part)
        golden = sum(np.asarray(counts[:self.windows], np.int64)
                     for counts in per_part)
        self.golden = np.asarray(golden, np.int64).reshape(self.windows, C)
        self.golden_s = time.perf_counter() - t0

    def bucket_views(self) -> dict:
        """The views per (campaign name, 10 s bucket start)."""
        import numpy as np

        pairs, n = np.unique(
            np.stack([self.views[:, 0], self.views[:, 1] // 10_000 * 10_000],
                     1), axis=0, return_counts=True)
        return {(self.campaigns[int(c)], int(b)): int(k)
                for (c, b), k in zip(pairs, n)}

    def remove(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def _mb_run(data: MicroBatchData, device: str, **kw) -> dict:
    """One ``run_microbatch`` over ``data``'s topic, its kernel launches
    counted from 0 just before it."""
    from streambench_tpu_torch.engine.microbatch import run_microbatch

    _sync(device)
    _reset_launches()
    t0 = time.perf_counter()
    merged, results = run_microbatch(data.cfg, data.broker, data.mapping,
                                     campaigns=data.campaigns, device=device,
                                     **kw)
    _sync(device)
    return {"merged": merged, "results": results,
            "secs": time.perf_counter() - t0, "launches": _launches()}


def _merged_equal(tag: str, got: dict, want, what: str) -> None:
    """``got`` (window -> [C]) equal to ``want``'s first windows."""
    import numpy as np

    if sorted(got) != list(range(len(got))) or len(got) > len(want):
        raise AssertionError(f"[{tag}] windows {len(got)} against {what}'s "
                             f"{len(want)}")
    for k in range(len(got)):
        if not np.array_equal(np.asarray(got[k], np.int64),
                              np.asarray(want[k], np.int64)):
            raise AssertionError(f"[{tag}] window {k} differs from {what}")


def _mb_launch_check(tag: str, run: dict, want_k1: int,
                     device: str) -> None:
    """K1 ``want_k1`` times on the card (its plain version on the CPU
    launches nothing), K2 and K3 never."""
    got = run["launches"]
    want_k1 = want_k1 if device == "cuda" else 0
    if got != {"count_cells": want_k1, "decode_rows": 0, "cms_rows": 0}:
        raise AssertionError(f"[{tag}] launches {got}, want K1 {want_k1} "
                             f"and K2, K3 0")


def _mb_fold_timing(data: MicroBatchData, device: str) -> dict:
    """The exact window fold on window 0 of partition 0: its device time
    (CUDA graph replays, the columns already on the card) and the time of
    one eager fold as a mapper calls it (columns in, fold, counts back)."""
    import numpy as np
    import torch

    from streambench_tpu_torch.encode.native_encoder import make_encoder
    from streambench_tpu_torch.engine.microbatch import (
        _make_family,
        window_campaign_counts,
    )

    cfg = data.cfg
    enc = make_encoder(data.mapping, data.campaigns,
                       divisor_ms=cfg.jax_time_divisor_ms,
                       lateness_ms=cfg.jax_allowed_lateness_ms)
    with data.broker.reader(cfg.kafka_topic, 0) as r:
        batch = enc.encode(r.poll(max_records=data.psize), data.psize)
    join = torch.from_numpy(np.asarray(enc.join_table, np.int32)).to(device)
    fam = _make_family("exact", enc, join)
    cols = [torch.from_numpy(a).to(device)
            for a in (batch.ad_idx, batch.event_type, batch.valid)]
    C = enc.num_campaigns
    out = {"rows": int(batch.batch_size)}
    if device == "cuda":
        out["device_ms"] = _device_ms(
            lambda: window_campaign_counts(join, *cols, num_campaigns=C))
    else:
        out["device_ms"] = "not measured"
    fam.fold(batch)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(MB_FOLD_CALLS):
        fam.fold(batch)
    out["call_ms"] = (time.perf_counter() - t0) * 1e3 / MB_FOLD_CALLS
    return out


def _microbatch(data: MicroBatchData, device: str) -> dict:
    """22 (a): the exact run with the in-process barrier (and the fork's
    latency hash), the same on the CPU, HLL on both, the Redis barrier
    over the RESP server, an interrupted checkpointed run and its
    resume."""
    import numpy as np

    from streambench_tpu_torch.engine.microbatch import (
        MicroBatchCheckpointer,
        RedisWindowBarrier,
    )
    from streambench_tpu_torch.io.fakeredis import FakeRedisServer, make_store
    from streambench_tpu_torch.io.redis_schema import (
        as_redis,
        read_latency_hash,
    )

    P, W = data.cfg.map_partitions, data.windows
    out: dict = {"windows": W, "partitions": P, "rows_per_window": data.psize,
                 "events": data.events, "generate_s": data.generate_s,
                 "golden_s": data.golden_s}
    # exact, the in-process barrier, the fork's latency hash
    store = as_redis(make_store())
    run = _mb_run(data, device, redis=store)
    _merged_equal("microbatch", run["merged"], data.golden, "the golden")
    if len(run["merged"]) != W:
        raise AssertionError(f"[microbatch] {len(run['merged'])} windows "
                             f"of {W}")
    # one launch a window a partition, and the warm-up's one
    _mb_launch_check("microbatch", run, W * P + 1, device)
    res = run["results"]
    if not all(r.windows == W and r.events == W * data.psize for r in res):
        raise AssertionError(f"[microbatch] partitions "
                             f"{[(r.windows, r.events) for r in res]}")
    if any(r.stamps != res[0].stamps for r in res):
        raise AssertionError("[microbatch] stamps differ across partitions")
    running, per_idx = read_latency_hash(store, data.cfg.redis_hashtable)
    if (set(per_idx) != set(range(1, P + 1)) or set(running) != set(per_idx)
            or store.execute("HGET", data.cfg.redis_hashtable,
                             "thread_idx") != str(P)
            or not all(per_idx.values())):
        raise AssertionError(f"[microbatch] latency hash: thread_idx, "
                             f"{sorted(per_idx)}, {running}")
    lat = [v for r in res for v in r.latency.values()]
    out["exact"] = {
        "secs": run["secs"], "windows_per_s": W / run["secs"],
        "events_per_s": W * P * data.psize / run["secs"],
        "window_latency": _percentiles(lat),
        "kernel_launches": run["launches"],
        "latency_hash": {"thread_idx": P,
                         "stamps": {i: len(v) for i, v in per_idx.items()},
                         "running_time_ms": running},
        "total_views": int(data.golden.sum())}
    exact = run["merged"]
    # the same on the CPU, over the first MB_CPU_WINDOWS windows
    n_cpu = min(MB_CPU_WINDOWS, W)
    cpu = _mb_run(data, "cpu", max_windows=n_cpu)
    _merged_equal("microbatch_cpu", cpu["merged"], exact, "the card's run")
    out["cpu_equal"] = len(cpu["merged"]) == n_cpu
    out["cpu_windows"], out["cpu_secs"] = n_cpu, cpu["secs"]
    # HLL over the same windows, registers window by window against the
    # CPU's
    hll = _mb_run(data, device, engine="hll", max_windows=n_cpu)
    hll_cpu = _mb_run(data, "cpu", engine="hll", max_windows=n_cpu)
    _mb_launch_check("microbatch_hll", hll, 0, device)
    for a, b in zip(hll["results"], hll_cpu["results"], strict=True):
        if sorted(b.counts) != list(range(n_cpu)) or not all(
                np.array_equal(a.counts[k], b.counts[k]) for k in b.counts):
            raise AssertionError(f"[microbatch_hll] partition {a.partition}'s"
                                 f" registers differ from the CPU's")
    est_diff = max(int(np.abs(hll["merged"][k].astype(np.int64)
                              - hll_cpu["merged"][k]).max())
                   for k in hll_cpu["merged"])
    if len(hll["merged"]) != n_cpu or est_diff > 1:
        raise AssertionError(f"[microbatch_hll] {len(hll['merged'])} "
                             f"windows, estimates differ by {est_diff}")
    out["hll"] = {"windows": n_cpu, "secs": hll["secs"], "events_per_s":
                  n_cpu * P * data.psize / hll["secs"],
                  "registers_equal_cpu": True, "estimate_max_diff": est_diff,
                  "kernel_launches": hll["launches"]}
    # the Redis barrier over the RESP server
    srv = FakeRedisServer().start()
    client = _ThreadLocalResp(srv.host, srv.port)
    try:
        barrier = RedisWindowBarrier(client, "mb_barrier", P)
        red = _mb_run(data, device, barrier=barrier,
                      max_windows=MB_REDIS_WINDOWS)
        fields = client.hgetall("mb_barrier")
    finally:
        client.close()
        srv.stop()
    _merged_equal("microbatch_redis", red["merged"], exact, "the exact run")
    _mb_launch_check("microbatch_redis", red,
                     len(red["merged"]) * P + 1, device)
    if (len(red["merged"]) != min(MB_REDIS_WINDOWS, W)
            or fields.get("partition_count") != "0"
            or sum(k.startswith("start_time:") for k in fields)
            != len(red["merged"])):
        raise AssertionError(f"[microbatch_redis] {len(red['merged'])} "
                             f"windows; barrier fields {sorted(fields)[:8]}")
    out["redis"] = {"windows": len(red["merged"]), "secs": red["secs"],
                    "windows_per_s": len(red["merged"]) / red["secs"],
                    "kernel_launches": red["launches"]}
    # a checkpointed run stopped at MB_STOP_AT, resumed to the end
    ckdir = os.path.join(data.workdir, "ckpt_microbatch")
    stop = min(MB_STOP_AT, W - 1)
    first = _mb_run(data, device, checkpoint_dir=ckdir,
                    checkpoint_every=MB_CHECKPOINT_EVERY, max_windows=stop)
    k0 = MicroBatchCheckpointer(ckdir).load()[0]
    resumed = _mb_run(data, device, checkpoint_dir=ckdir,
                      checkpoint_every=MB_CHECKPOINT_EVERY)
    _merged_equal("microbatch_resume", resumed["merged"], exact,
                  "the exact run")
    _mb_launch_check("microbatch_resume", resumed, (W - k0) * P + 1,
                     device)
    if len(resumed["merged"]) != W or not k0:
        raise AssertionError(f"[microbatch_resume] {len(resumed['merged'])}"
                             f" windows from window {k0}")
    out["resume"] = {"stopped_at": stop, "resumed_from": k0,
                     "chunks": len(os.listdir(ckdir)),
                     "secs": first["secs"] + resumed["secs"],
                     "kernel_launches": resumed["launches"]}
    out["fold"] = _mb_fold_timing(data, device)
    return out


def _handoff(device: str) -> dict:
    """22 (b): the handoff CLI's entry at the reference's defaults (20
    windows of 5,000 events, the first dropped), in this process."""
    import contextlib
    import io

    from streambench_tpu_torch import handoff

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = handoff._main(["--inprocessRedis", "--device", device])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or line["windows"] != 19 or line["batch_size"] != 5000:
        raise AssertionError(f"[handoff] rc {rc}: {line}")
    line["secs"] = time.perf_counter() - t0
    return line


class _Timed:
    """Host seconds and calls of methods, by name, while installed."""

    def __init__(self, targets: dict):
        self.targets = targets           # name -> (owner, attribute)
        self.secs = {n: 0.0 for n in targets}
        self.calls = {n: 0 for n in targets}
        self._saved: dict = {}

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            fn = getattr(owner, attr)
            self._saved[name] = fn

            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.secs[_name] += time.perf_counter() - t0
                    self.calls[_name] += 1

            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for name, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._saved[name])


def _synthetic_oracle(n: int, batch: int, seed: int):
    """``run_synthetic``'s rows by numpy, from the same seeded draws:
    ``(codes, events)``, sorted, a row's code ``campaign number * WIDS +
    window id`` (clicks are 1 each)."""
    import numpy as np

    from streambench_tpu_torch.dimensions.synthetic import (
        SyntheticDimensionSource,
    )

    src = SyntheticDimensionSource(num_campaigns=DIMS_CAMPAIGNS,
                                   rng=random.Random(seed))
    draw = src.rng.randrange
    keys = np.fromiter((draw(DIMS_CAMPAIGNS) for _ in range(n)), np.int64, n)
    times, t = [], 0
    for off in range(0, n, batch):
        m = min(batch, n - off)
        ts = t + np.arange(m, dtype=np.int64) * src._step_us // 1000
        t = int(ts[-1]) + 1
        times.append(ts)
    wid = np.concatenate(times) // 10_000
    return np.unique(keys * _WIDS + wid, return_counts=True)


#: window ids a synthetic run spans at most (2^20 s of 10 s buckets)
_WIDS = 1 << 17


def _synthetic_rows(rows):
    """``run_synthetic``'s named rows as the oracle's ``(codes,
    events)``, sorted."""
    import numpy as np

    prefix, m = len("campaign-"), len(rows)
    codes = (np.fromiter((int(r[0][prefix:]) for r in rows), np.int64, m)
             * _WIDS + np.fromiter((r[1] for r in rows), np.int64, m))
    events = np.fromiter((r[2]["clicks:SUM"] for r in rows), np.int64, m)
    order = np.argsort(codes, kind="stable")
    return codes[order], events[order]


def _dims_synthetic(device: str, events: int) -> dict:
    """22 (c): ``run_synthetic`` at the Apex generator's 1M campaigns into
    2^20 keys, held to the numpy oracle; K1 once a step (the presence
    plane; the synthetic schema is clicks:SUM); the interner's and the row
    build's (``flush_closed``) share of the run."""
    import numpy as np
    import torch

    from streambench_tpu_torch.dimensions import compute
    from streambench_tpu_torch.dimensions.schema import parse_schema
    from streambench_tpu_torch.dimensions.synthetic import (
        SYNTH_SCHEMA,
        run_synthetic,
    )

    _sync(device)
    _reset_peak(device)
    _reset_launches()
    timed = _Timed({"intern": (compute.KeyInterner, "intern_many"),
                    "step": (compute.DimensionsComputation, "step"),
                    "flush": (compute.DimensionsComputation,
                              "flush_closed")})
    t0 = time.perf_counter()
    with timed:
        rows, interner, dropped = run_synthetic(
            n_events=events, batch=DIMS_BATCH, num_campaigns=DIMS_CAMPAIGNS,
            key_capacity=DIMS_KEYS, window_slots=DIMS_SLOTS,
            rng=random.Random(DIMS_SEED), device=device)
    _sync(device)
    secs = time.perf_counter() - t0
    launches = _launches()
    peak = _peak(device)
    t1 = time.perf_counter()
    want = _synthetic_oracle(events, DIMS_BATCH, DIMS_SEED)
    got = _synthetic_rows(rows)
    oracle_s = time.perf_counter() - t1
    steps = timed.calls["step"]
    equal = all(np.array_equal(g, w) for g, w in zip(got, want))
    if not equal or dropped:
        raise AssertionError(f"[dims] rows {len(rows)} against the "
                             f"oracle's {len(want)}, equal {equal}, "
                             f"dropped {dropped}")
    _mb_launch_check("dims", {"launches": launches}, steps, device)
    out = {"events": events, "steps": steps, "rows": len(rows),
           "keys_interned": len(interner.index), "dropped": dropped,
           "secs": secs, "events_per_s": events / secs,
           "intern_share": timed.secs["intern"] / secs,
           "step_host_share": timed.secs["step"] / secs,
           "row_build_share": timed.secs["flush"] / secs,
           "peak_allocated_bytes": peak, "kernel_launches": launches,
           "oracle_s": oracle_s}
    # the fold's device time a step, on a scratch state
    if device == "cuda":
        dc = compute.DimensionsComputation(
            parse_schema(SYNTH_SCHEMA), num_keys=DIMS_KEYS,
            window_slots=DIMS_SLOTS, lateness_ms=0, device=device)
        st = dc.init_state()
        g = torch.Generator().manual_seed(DIMS_SEED)
        key = torch.randint(0, DIMS_CAMPAIGNS, (DIMS_BATCH,),
                            generator=g, dtype=torch.int32).to(device)
        tt = (torch.arange(DIMS_BATCH, dtype=torch.int32) // 100).to(device)
        ok = torch.ones(DIMS_BATCH, dtype=torch.bool, device=device)
        ones = torch.ones(DIMS_BATCH, dtype=torch.int32, device=device)
        out["fold_device_ms"] = _device_ms(lambda: compute._fold(
            st, key, tt, ok, [ones], kinds=dc.kinds, divisor_ms=10_000,
            lateness_ms=0), reps=20)
        del st
    else:
        out["fold_device_ms"] = "not measured"
    return out


def _dims_app(data: MicroBatchData, device: str) -> dict:
    """22 (c): ``DimensionApp`` (the default schema: clicks:SUM,
    latency:MAX) over (a)'s journal, whole and in order (its 8192-event
    batches span 81.9 s of event time, inside the 16-bucket ring): every
    (campaign, 10 s bucket) stored with ``clicks:SUM`` the journal's views
    and ``latency:MAX`` >= 0, none dropped, K1 once a step."""
    from streambench_tpu_torch.dimensions import compute
    from streambench_tpu_torch.dimensions.app import DimensionApp
    from streambench_tpu_torch.dimensions.store import DurableDimensionStore

    store_dir = os.path.join(data.workdir, "dims_store")
    _sync(device)
    _reset_launches()
    timed = _Timed({"step": (compute.DimensionsComputation, "step")})
    t0 = time.perf_counter()
    with timed:
        app = DimensionApp(None, data.mapping, store_dir,
                           campaigns=data.campaigns, device=device)
        with data.broker.reader(data.STREAM_TOPIC, 0) as reader:
            while True:
                # a batch a poll, flushed after each, as the dimensions
                # CLI's broker mode runs it: the ring holds 16 buckets,
                # and only a flush frees the closed ones
                lines = reader.poll(max_records=8192)
                if not lines:
                    break
                app.process_lines(lines)
                app.flush()
        app.close()
    _sync(device)
    secs = time.perf_counter() - t0
    launches = _launches()
    stored = DurableDimensionStore(store_dir)
    got = {key: aggs["clicks:SUM"] for key, aggs in stored.items()}
    want = data.bucket_views()
    lat_ok = all(aggs["latency:MAX"] >= 0 for _, aggs in stored.items())
    steps = timed.calls["step"]
    if got != want or app.dropped or app.invalid_tuples or not lat_ok:
        raise AssertionError(f"[dims_app] {len(got)} rows against the "
                             f"journal's {len(want)} (equal {got == want}), "
                             f"dropped {app.dropped}, invalid "
                             f"{app.invalid_tuples}, latency >= 0 {lat_ok}")
    _mb_launch_check("dims_app", {"launches": launches}, steps, device)
    return {"events": app.events, "steps": steps, "rows": len(got),
            "secs": secs, "events_per_s": app.events / secs,
            "kernel_launches": launches}


def _cli(argv: list, out_path: str) -> dict:
    with open(out_path, "w") as fo:
        proc = subprocess.Popen(
            [sys.executable, "-m", *argv], env=dict(os.environ,
                                                    PYTHONPATH=REPO),
            cwd=REPO, stdout=fo, stderr=subprocess.STDOUT)
    return {"proc": proc, "out": out_path, "t0": time.perf_counter()}


def _cli_finish(tag: str, run: dict) -> dict:
    proc = run["proc"]
    try:
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = open(run["out"]).read().strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"[{tag}] exited {rc}: {lines[-20:]}")
    stats = json.loads(lines[-1])
    stats["wall_s"] = time.perf_counter() - run["t0"]
    return stats


def phase_microbatch_dims(device: str = "cuda", mb_events: int = MB_EVENTS,
                          dims_events: int = DIMS_EVENTS) -> dict:
    """Phase 22 (module doc): (a) the micro-batch mode, (b) the handoff,
    then the two CLIs, each its own process, started side by side and
    running while (c) the dimensional family runs in this process.
    ``device`` and the sizes are arguments so the phase can be rehearsed
    on the CPU at a small size."""
    t0 = time.perf_counter()
    out: dict = {}
    data = MicroBatchData(mb_events)
    clis: list = []
    try:
        out["microbatch"] = _microbatch(data, device)
        out["handoff"] = _handoff(device)
        clis.append(_cli(["streambench_tpu_torch.engine", "--confPath",
                          os.path.join(data.workdir, "benchmarkConf.yaml"),
                          "--workdir", data.workdir, "--microbatch",
                          "--device", device],
                         os.path.join(data.workdir, "microbatch_cli.out")))
        clis.append(_cli(["streambench_tpu_torch.dimensions", "--generate",
                          str(DIMS_CLI_EVENTS), "--storeDir",
                          os.path.join(data.workdir, "dims_cli_store"),
                          "--device", device],
                         os.path.join(data.workdir, "dims_cli.out")))
        out["dims"] = _dims_synthetic(device, dims_events)
        out["dims_app"] = _dims_app(data, device)
        mb_stats = _cli_finish("microbatch_cli", clis.pop(0))
        dims_stats = _cli_finish("dims_cli", clis.pop(0))
    finally:
        for run in clis:                   # stop what a failure left
            run["proc"].kill()
            run["proc"].wait()
        data.remove()
    want_views = out["microbatch"]["exact"]["total_views"]
    if (mb_stats["total_views"] != want_views
            or mb_stats["windows"] != data.windows
            or mb_stats["partitions"] != data.cfg.map_partitions):
        raise AssertionError(f"[microbatch_cli] {mb_stats}, want "
                             f"{want_views} views")
    if (dims_stats["events"] != DIMS_CLI_EVENTS or dims_stats["invalid"]
            or dims_stats["dropped"] or not dims_stats["stored_rows"]):
        raise AssertionError(f"[dims_cli] {dims_stats}")
    out["microbatch_cli"], out["dims_cli"] = mb_stats, dims_stats
    out["phase_s"] = time.perf_counter() - t0
    a, b, c = out["microbatch"], out["handoff"], out["dims"]
    e = a["exact"]
    print(f"[microbatch_dims] (a) {a['windows']} windows x "
          f"{a['partitions']} x {a['rows_per_window']} rows: "
          f"{e['windows_per_s']:.1f} windows/s, {e['events_per_s']:.0f} "
          f"ev/s, window latency p50/p99 {e['window_latency']['p50_ms']}/"
          f"{e['window_latency']['p99_ms']} ms, fold "
          f"{a['fold']['device_ms']} device ms, {a['fold']['call_ms']:.4f} "
          f"ms a call; K1 {e['kernel_launches']['count_cells']}; equal the "
          f"golden and the CPU; HLL registers equal the CPU's; Redis "
          f"barrier {a['redis']['windows']} windows equal; resume from "
          f"window {a['resume']['resumed_from']} equal; CLI "
          f"{mb_stats['total_views']} views.  (b) r2c p50/max "
          f"{b['r2c_ms_p50']}/{b['r2c_ms_max']} ms, c2r "
          f"{b['c2r_ms_p50']}/{b['c2r_ms_max']} ms.  (c) "
          f"{c['events_per_s']:.0f} ev/s, {c['rows']} rows equal the "
          f"oracle, fold {c['fold_device_ms']} device ms a step, peak "
          f"{c['peak_allocated_bytes']} B, interner "
          f"{c['intern_share']:.3f} and row build "
          f"{c['row_build_share']:.3f} of the run; app "
          f"{out['dims_app']['events_per_s']:.0f} ev/s, "
          f"{out['dims_app']['rows']} rows equal; CLI "
          f"{dims_stats['stored_rows']} rows; {out['phase_s']:.1f} s",
          flush=True)
    return out


def _microbatch_dims_launches(p22: dict, kernel: str) -> dict:
    """A kernel's launches on phase 22's in-process paths."""
    a = p22["microbatch"]
    return {"microbatch_exact": a["exact"]["kernel_launches"][kernel],
            "microbatch_hll": a["hll"]["kernel_launches"][kernel],
            "microbatch_redis": a["redis"]["kernel_launches"][kernel],
            "microbatch_resume": a["resume"]["kernel_launches"][kernel],
            "dims_synthetic": p22["dims"]["kernel_launches"][kernel],
            "dims_app": p22["dims_app"]["kernel_launches"][kernel]}


# ----------------------------------------------------------------------
# phase 23: the multi-tenant host (M15c)
#: (a): each tenant's share of the topic (250,000, not the 500,000 the
#: phase was drawn up with: the cut that pays for (d) ending before (a))
TENANTS_EVENTS = 250_000
TENANTS_SEED = 31
TENANTS_SPEC = "ex:exact,se:session,hl:hll,rc:reach"
TENANTS_SAMPLE_EVERY = 4           # (a): 1 dispatch in 4 timed to its end
TENANTS_CLI_SPEC = "ex:exact,se:session,rc:reach"
#: (d): the CLI's own topic, the journal's first events (it ends before
#: (a) and (b), whose speeds another process on the card would skew)
TENANTS_CLI_TOPIC = "tenants-cli"
TENANTS_CLI_EVENTS = 100_000
#: (b): bench_multitenant.py's --smoke schedule (:544-545, :193-207)
TENANTS_FLASH = {"duration_s": 8.0, "crowd": (2.0, 6.0), "tail_s": 20.0,
                 "steady_n": 150, "crowd_n": 8000, "qps": 20.0, "seed": 19,
                 "campaigns": 20, "batch_size": 1024, "objective_ms": 12}
TENANTS_FLASH_ADMISSION = {"breach_burn": 12.0, "breach_ticks": 2,
                           "healthy_ticks": 16, "escalate_ticks": 400,
                           "cooldown_s": 1.0}
#: (c): batches each of the two tenants queues before its script runs
TENANTS_ACTUATOR_BATCHES = 10
TENANTS_ACTUATOR_QUEUE = 8         # script 2: 2 of 10 batches dropped
#: (c) script 1: burn by control step (priming, a breach the hysteresis
#: confirms, the gate up through two more breaching steps, health)
TENANTS_SCRIPT_DEFER = (0.0, 5.0, 5.0, 5.0, 5.0, 0.0, 0.0, 0.0)
TENANTS_SCRIPT_SHED = (0.0,) + (5.0,) * 11
TENANTS_ADMISSION = {"breach_ticks": 2, "healthy_ticks": 3,
                     "cooldown_s": 1.0}
TENANT_CLASSES = {"exact": ("engine.pipeline", "AdAnalyticsEngine"),
                  "session": ("engine.sketches", "SessionCMSEngine"),
                  "hll": ("engine.sketches", "HLLDistinctEngine"),
                  "reach": ("engine.sketches", "ReachSketchEngine")}


class TenantsData:
    """Phase 23's dataset: the generator's journal at the stock
    configuration (``conf/benchmarkConf.yaml``: 100 campaigns x 10 ads,
    16 window slots, 10 s windows), cut into the configured batches."""

    def __init__(self, events: int = TENANTS_EVENTS,
                 seed: int = TENANTS_SEED):
        self.workdir = _workdir("smoke_tenants")
        self.cfg = _config(self.workdir)
        self.events = events
        (self.broker, self.mapping, self.campaigns, _,
         self.generate_s) = _generate(self.workdir, self.cfg, events, seed,
                                      store=False)
        with open(self.broker.topic_path(self.cfg.kafka_topic, 0),
                  "rb") as f:
            lines = f.read().split(b"\n")[:-1]
        B = self.cfg.jax_batch_size
        self.batches = [lines[i:i + B] for i in range(0, len(lines), B)]

    def store(self):
        from streambench_tpu_torch.io.fakeredis import make_store
        from streambench_tpu_torch.io.redis_schema import (
            as_redis,
            seed_campaigns,
        )

        r = as_redis(make_store())
        seed_campaigns(r, self.campaigns)
        return r

    def remove(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def _tenant_rows(kind: str, engine) -> dict:
    """What a tenant of ``kind`` left in its store: the window rows
    (exact, HLL), the heavy hitters (session), the reach estimates."""
    from streambench_tpu_torch.io.redis_schema import read_seen_counts

    r = engine.redis
    if kind in ("exact", "hll"):
        return {(c, w): n for c, ws in read_seen_counts(r).items()
                for w, n in ws.items()}
    table = {"session": "_hh", "reach": "_reach"}[kind]
    return r.hgetall(f"{engine.cfg.redis_hashtable}{table}")


def _rows_agree(tag: str, kind: str, got: dict, want: dict) -> int:
    """``got`` against ``want``: bit for bit, HLL and reach estimates
    within 1 (the float32 sum order).  Returns the largest difference."""
    if set(got) != set(want) or not want:
        raise AssertionError(f"[{tag}] {len(got)} rows against {len(want)} "
                             f"alone ({len(set(got) ^ set(want))} differ)")
    diff = 0
    for k, w in want.items():
        g = got[k]
        if kind in ("hll", "reach"):
            diff = max(diff, abs(int(g) - int(w)))
        elif str(g) != str(w):
            raise AssertionError(f"[{tag}] {k}: {g} under the host, {w} "
                                 "alone")
    if diff > 1:
        raise AssertionError(f"[{tag}] estimates differ by {diff} from the "
                             "engine alone")
    return diff


def _tenants_solo(data: TenantsData, kind: str, batches: list,
                  device: str) -> dict:
    """One engine of ``kind`` alone on ``device`` over ``batches``, each
    through ``process_lines`` as the host folds it; its launches counted
    from 0 after its warm-up to after its close.  ``calls_s`` sums the
    ``process_lines`` calls, as (a) times each tenant under the host;
    ``wall_s`` is the loop ended by ``_sync``, as (a) times the host's."""
    import importlib

    mod, name = TENANT_CLASSES[kind]
    cls = getattr(importlib.import_module(f"streambench_tpu_torch.{mod}"),
                  name)
    engine = cls(data.cfg, data.mapping, campaigns=data.campaigns,
                 redis=data.store(), device=device)
    engine.warmup()
    _sync(device)
    _reset_launches()
    calls_s = 0.0
    t0 = time.perf_counter()
    for lines in batches:
        t_call = time.perf_counter()
        engine.process_lines(lines)
        calls_s += time.perf_counter() - t_call
    _sync(device)
    wall = time.perf_counter() - t0
    engine.flush(final=True)
    planes = engine.planes() if kind == "reach" else None
    engine.close()
    return {"rows": _tenant_rows(kind, engine), "planes": planes,
            "events": engine.telemetry()["events"], "calls_s": calls_s,
            "wall_s": wall, "launches": _launches()}


def _tenants_host(data: TenantsData, device: str, spec: str, **kw):
    from streambench_tpu_torch.engine.tenants import (
        MultiTenantHost,
        parse_tenants,
    )
    from streambench_tpu_torch.obs import MetricsRegistry

    kw.setdefault("registry", MetricsRegistry())
    return MultiTenantHost(data.cfg, parse_tenants(spec), data.mapping,
                           campaigns=data.campaigns,
                           redis_factory=data.store, device=device, **kw)


def _tenants_isolation_run(data: TenantsData, device: str) -> dict:
    """(a)'s runs: four tenants under one host, admission off, the same
    batches offered to each and folded by ``step()``, then each engine
    alone over the same batches.  Both sides are timed the same way:
    each tenant by the sum of its ``process_lines`` calls (inside
    ``step()`` under the host), and the host's loop against the engines'
    loops alone, each ended by ``_sync``.  No other process runs on the
    card meanwhile.  ``_tenants_isolation`` checks what they left."""
    host = _tenants_host(data, device, TENANTS_SPEC,
                         sample_every=TENANTS_SAMPLE_EVERY)
    names = host.tenants()
    host_s = dict.fromkeys(names, 0.0)

    def timed(name, inner):
        def process_lines(lines):
            t0 = time.perf_counter()
            n = inner(lines)
            host_s[name] += time.perf_counter() - t0
            return n
        return process_lines

    for name in names:
        eng = host.tenant(name).engine
        eng.process_lines = timed(name, eng.process_lines)
    host.warmup()
    _sync(device)
    _reset_launches()
    t0 = time.perf_counter()
    for lines in data.batches:
        for name in names:
            host.offer(name, lines)
        if host.step() != len(names):
            raise AssertionError("[tenants_a] a step folded fewer batches "
                                 "than the tenants queued")
    _sync(device)
    wall = time.perf_counter() - t0
    summary = host.close()
    launches = _launches()
    kinds = {n: host.tenant(n).kind for n in names}
    return {"host": host, "summary": summary, "launches": launches,
            "wall_s": wall, "host_s": host_s, "kinds": kinds,
            "rows": {n: _tenant_rows(kinds[n], host.tenant(n).engine)
                     for n in names},
            "planes": {n: host.tenant(n).engine.planes() for n in names
                       if kinds[n] == "reach"},
            "solo": {n: _tenants_solo(data, kinds[n], data.batches, device)
                     for n in names}}


def _tenants_isolation(data: TenantsData, run: dict, device: str) -> dict:
    """(a)'s gates over ``_tenants_isolation_run``'s ``run``: each
    tenant's rows (and reach planes) under the host equal the engine's
    alone, the exact rows pass the oracle, the launches under the host
    equal the engines' alone, the partition check holds and each
    tenant's attributed busy is its sampler's."""
    host, summary, launches = run["host"], run["summary"], run["launches"]
    kinds, rows, planes = run["kinds"], run["rows"], run["planes"]
    names, host_s = list(kinds), run["host_s"]
    mt = summary["multitenant"]
    part = mt["partition"]
    if not part["ok"]:
        raise AssertionError(f"[tenants_a] partition check failed: {part}")
    busy = {}
    for n in names:
        att, meas = host.ledger.busy_ns[n], host.tenant(n).occupancy.busy_ns
        if att != meas:
            raise AssertionError(f"[tenants_a] {n}: {att} ns attributed, "
                                 f"its sampler measured {meas} ns")
        busy[n] = att / 1e6
    oracle = _oracle(host.tenant("ex").engine.redis, data.workdir,
                     data.cfg.jax_time_divisor_ms)
    solo, solo_launches, max_diff = {}, dict.fromkeys(launches, 0), {}
    for n in names:
        s = run["solo"][n]
        ev = summary["tenants"][n]["events"]
        if ev != s["events"] or ev != data.events:
            raise AssertionError(f"[tenants_a] {n}: {ev} events under the "
                                 f"host, {s['events']} alone, "
                                 f"{data.events} in the topic")
        max_diff[n] = _rows_agree(f"tenants_a {n}", kinds[n], rows[n],
                                  s["rows"])
        if n in planes:
            for key in ("mins", "registers"):
                if not _np_equal(planes[n][key], s["planes"][key]):
                    raise AssertionError(f"[tenants_a] {n}: the {key} "
                                         "plane differs from the engine "
                                         "alone")
        for k, v in s["launches"].items():
            solo_launches[k] += v
        solo[n] = {"events_per_s": s["events"] / s["calls_s"],
                   "calls_s": s["calls_s"], "wall_s": s["wall_s"],
                   "launches": s["launches"]}
    if launches != solo_launches:
        raise AssertionError(f"[tenants_a] launches under the host "
                             f"{launches}, alone {solo_launches}")
    if device == "cuda" and not (launches["count_cells"]
                                 and launches["cms_rows"]):
        raise AssertionError(f"[tenants_a] K1 or K3 never launched under "
                             f"the host: {launches}")
    return {"tenants": kinds, "events": data.events,
            "batches": len(data.batches),
            "sample_every": TENANTS_SAMPLE_EVERY, "wall_s": run["wall_s"],
            "alone_wall_s": sum(solo[n]["wall_s"] for n in names),
            "kernel_launches": launches, "solo_launches": solo_launches,
            "host_s": host_s,
            "events_per_s_host": {n: data.events / host_s[n]
                                  for n in names},
            "events_per_s_alone": {n: solo[n]["events_per_s"]
                                   for n in names},
            "attributed_busy_ms": busy, "offdiag_ratio": mt["offdiag_ratio"],
            "blame_ms": mt["matrix_ms"], "wait_ms": mt["wait_ms"],
            "partition": part, "max_estimate_diff": max_diff,
            "oracle": oracle, "solo": solo}


def _np_equal(a, b) -> bool:
    import numpy as np

    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def _flash_world(f: dict):
    """``bench_multitenant.py:make_world`` / ``make_schedule`` /
    ``make_queries`` with the port's generator: the seeded campaigns and
    ads, one ingest schedule ``[(t_s, tenant, lines)]`` both arms replay,
    and the fixed-rate query plan ``[(t_s, campaigns, op)]``."""
    from streambench_tpu_torch.datagen.gen import EventSource
    from streambench_tpu_torch.utils.ids import make_ids

    rng = random.Random(f["seed"])
    n = f["campaigns"]
    campaigns = make_ids(n, rng)
    ads = make_ids(n * 10, rng)
    mapping = {a: campaigns[i // 10] for i, a in enumerate(ads)}
    src = EventSource(ads=ads, user_ids=make_ids(2000, rng),
                      page_ids=make_ids(100, rng), rng=rng)
    clock = [1_700_000_000_000]

    def batch(k: int):
        ts = [clock[0] + 10 * i for i in range(k)]
        clock[0] += 10 * k
        return [s.encode() for s in src.events_at(ts)]

    sched, (c0, c1), t = [], f["crowd"], 0.0
    while t < f["duration_s"]:
        sched.append((t, "alpha", batch(f["steady_n"])))
        if c0 <= t < c1:
            sched.append((t, "beta", batch(f["crowd_n"])))
            sched.append((t + 0.05, "beta", batch(f["crowd_n"])))
        else:
            sched.append((t, "beta", batch(f["steady_n"])))
        if round(t * 10) % 20 == 0:                      # every 2 s
            sched.append((t, "gamma", batch(64)))
        t = round(t + 0.1, 3)
    sched.sort(key=lambda x: x[0])
    qrng = random.Random(f["seed"] * 31 + 7)
    queries = []
    for i in range(int(f["duration_s"] * f["qps"])):
        subset = qrng.sample(campaigns, qrng.randint(2, 5))
        queries.append((i / f["qps"], subset,
                        "overlap" if i % 3 == 0 else "union"))
    return campaigns, mapping, sched, queries


def _flash_arm(on: bool, world: tuple, device: str, workdir: str,
               f: dict) -> dict:
    """One arm of ``bench_multitenant.py:run_arm`` (admission ``on`` or
    off) on ``device``: alpha session, beta reach, gamma reach serving
    with a ``reach_p99_ms`` objective and a query client at ``qps``.
    Every defer or shed decision is recorded with the victim's blame row
    as the ledger held it at that step."""
    from streambench_tpu_torch.config import default_config
    from streambench_tpu_torch.engine.tenants import MultiTenantHost
    from streambench_tpu_torch.obs import MetricsRegistry, MetricsSampler

    campaigns, mapping, sched, queries = world
    arm_dir = os.path.join(workdir, f"mt_{'on' if on else 'off'}")
    os.makedirs(arm_dir, exist_ok=True)
    registry = MetricsRegistry()
    sampler = MetricsSampler(os.path.join(arm_dir, "metrics.jsonl"),
                             interval_ms=250, registry=registry,
                             role="host")
    specs = [{"name": "alpha", "kind": "session"},
             {"name": "beta", "kind": "reach"},
             {"name": "gamma", "kind": "reach", "serve": True,
              "reach_p99_ms": f["objective_ms"], "fast_s": 2.0,
              "slow_s": 6.0}]
    host = MultiTenantHost(
        default_config(jax_batch_size=f["batch_size"]), specs, mapping,
        campaigns=campaigns, registry=registry, sampler=sampler,
        sample_every=1, admission=on,
        admission_kw=dict(TENANTS_FLASH_ADMISSION), device=device)
    host.warmup()
    _sync(device)
    _reset_launches()
    serve = host.tenant("gamma").serve
    for name in host.tenants():                  # the primer
        host.offer(name, sched[0][2][:32])
    host.step()
    host.flush_all()

    def ask(n: int, tag: str, pace_s: float = 0.0) -> None:
        done = threading.Semaphore(0)
        for i in range(n):
            serve.submit(queries[i % len(queries)][1],
                         "union" if i % 2 else "overlap",
                         lambda data: done.release(),
                         query_id=f"{tag}{int(on)}-{i}")
            time.sleep(pace_s)
        for _ in range(n):
            if not done.acquire(timeout=60):
                raise AssertionError(f"[tenants_b] a {tag} query got no "
                                     "reply in 60 s")

    ask(4, "warm")
    sampler.start()
    stop = threading.Event()
    decisions: list = []
    errors: list = []

    def fold_loop():
        try:
            last_ctrl = last_flush = time.monotonic()
            while not stop.is_set():
                folded = host.step()
                now = time.monotonic()
                if on and now - last_ctrl >= 0.25:
                    dec = host.control_step()
                    if dec is not None:
                        dec = dict(dec)
                        if dec["decision"] != "release":
                            dec["blame_row_ms"] = host.ledger.blame_matrix(
                            )["matrix_ms"].get(dec["victim"], {})
                        decisions.append(dec)
                    last_ctrl = now
                if now - last_flush >= 1.0:
                    host.flush_all()
                    last_flush = now
                if not folded:
                    host.drain_waits()
                    time.sleep(0.002)
        except BaseException as e:      # re-raised by the main thread
            errors.append(e)

    results: list = []
    lock = threading.Lock()

    def query_loop(t0: float):
        pending = threading.Semaphore(256)
        for i, (t_s, subset, op) in enumerate(queries):
            wait = t0 + t_s - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            pending.acquire()
            t_submit = time.perf_counter()

            def cb(data, t_submit=t_submit):
                with lock:
                    results.append(((time.perf_counter() - t_submit) * 1e3,
                                    data))
                pending.release()

            serve.submit(subset, op, cb, query_id=f"mt{int(on)}-{i}")

    folder = threading.Thread(target=fold_loop, daemon=True)
    folder.start()
    try:
        ask(6, "settle", pace_s=0.4)    # warm-up residue ages out first
        t0 = time.monotonic()
        client = threading.Thread(target=query_loop, args=(t0,),
                                  daemon=True)
        client.start()
        for t_s, name, lines in sched:
            wait = t0 + t_s - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            host.offer(name, lines)
        client.join(timeout=f["duration_s"] + 120)
        deadline = time.monotonic() + f["tail_s"]
        while time.monotonic() < deadline and any(
                host.tenant(n).queue for n in host.tenants()):
            time.sleep(0.05)
        t_end = time.monotonic() + 5.0
        while len(results) < len(queries) and time.monotonic() < t_end:
            time.sleep(0.05)
    finally:
        stop.set()
        folder.join(timeout=30)
    backlog = {n: len(host.tenant(n).queue) for n in host.tenants()
               if host.tenant(n).queue}
    summary = host.close()
    _sync(device)
    launches = _launches()
    sampler.close(final={"multitenant": summary["multitenant"]})
    if errors:
        raise errors[0]
    lat = sorted(ms for ms, data in results
                 if not (data.get("shed") or data.get("error")))
    shed = len(results) - len(lat)
    breaches = shed + sum(1 for ms in lat if ms > f["objective_ms"])
    mt = summary["multitenant"]
    arm = {
        "sent": len(queries), "replied": len(results), "answered": len(lat),
        "shed": shed, "breaches": breaches,
        "breach_ratio": breaches / len(results) if results else None,
        "e2e_p50_ms": lat[len(lat) // 2] if lat else None,
        "e2e_p99_ms": (lat[min(len(lat) - 1, int(len(lat) * 0.99))]
                       if lat else None),
        "events": {n: b["events"] for n, b in summary["tenants"].items()},
        "folded_batches": {n: b["folded_batches"]
                           for n, b in summary["tenants"].items()},
        "dropped_batches": {n: b["dropped_batches"]
                            for n, b in summary["tenants"].items()},
        "backlog": backlog, "offdiag_ratio": mt["offdiag_ratio"],
        "blame_ms": mt["matrix_ms"], "busy_ms": mt["busy_ms"],
        "wait_ms": mt["wait_ms"], "partition": mt["partition"],
        "decisions": decisions, "admission": summary.get("admission"),
        "kernel_launches": launches}
    if backlog:
        raise AssertionError(f"[tenants_b] {'on' if on else 'off'} arm: "
                             f"tenants {sorted(backlog)} kept a backlog "
                             f"after the {f['tail_s']} s tail: {backlog}")
    if not mt["partition"]["ok"]:
        raise AssertionError(f"[tenants_b] partition check failed: "
                             f"{mt['partition']}")
    if len(results) != len(queries):
        raise AssertionError(f"[tenants_b] {len(results)} replies to "
                             f"{len(queries)} queries")
    for d in decisions:
        if d["decision"] == "release":
            continue
        row = d["blame_row_ms"]
        if (d["tenant"] == d["victim"] or not d["blame_ms"] > 0
                or not row.get(d["tenant"], 0) > 0):
            raise AssertionError(f"[tenants_b] a decision without "
                                 f"cross-tenant evidence: {d}")
    return arm


def _tenants_flash(device: str, workdir: str, f: dict, world: tuple
                   ) -> dict:
    """(b): the reference's flash crowd on schedule ``f`` over
    ``_flash_world(f)``'s ``world``, in an off and an on arm.  What holds
    at any speed is gated; the breach ratios, p99s, offdiag ratio and
    decision counts are findings."""
    off = _flash_arm(False, world, device, workdir, f)
    on = _flash_arm(True, world, device, workdir, f)
    if off["events"] != on["events"]:
        raise AssertionError(f"[tenants_b] the arms folded {off['events']} "
                             f"and {on['events']} events")
    return {"schedule": {k: (list(v) if isinstance(v, tuple) else v)
                         for k, v in f.items()},
            "admission_kw": TENANTS_FLASH_ADMISSION,
            "events": sum(len(lines) for _, _, lines in world[2]),
            "off": off, "on": on}


def _actuator_script(data: TenantsData, device: str, burns: tuple,
                     workdir: str, tag: str, escalate_ticks: int,
                     queue_max: int) -> dict:
    """(c): ``rb:reach`` first in the fold order and ``ex:exact`` after
    it, each with queued batches, every dispatch timed
    (``sample_every=1``), so each of ex's waits spans rb's timed
    dispatch.  The controller is built on the host's ledger with its own
    arguments: ``burns`` scripted by control step, the step as its
    clock.  Each control step is followed by one fold pass."""
    from streambench_tpu_torch.obs import (
        AdmissionController,
        FlightRecorder,
        MetricsRegistry,
        MetricsSampler,
    )

    registry = MetricsRegistry()
    journal = os.path.join(workdir, f"metrics_{tag}.jsonl")
    sampler = MetricsSampler(journal, interval_ms=1000, registry=registry,
                             role="host")
    flightrec = FlightRecorder(workdir)
    host = _tenants_host(data, device, "rb:reach,ex:exact",
                         registry=registry, sampler=sampler, sample_every=1,
                         queue_max=queue_max)
    tick = {"step": 0}
    script = iter(burns)
    host.admission = AdmissionController(
        host.ledger, lambda: {"ex": next(script)}, registry=registry,
        sampler=sampler, flightrec=flightrec,
        escalate_ticks=escalate_ticks, clock=lambda: float(tick["step"]),
        **TENANTS_ADMISSION)
    host.warmup()
    _sync(device)
    _reset_launches()
    batches = data.batches[:TENANTS_ACTUATOR_BATCHES]
    for lines in batches:
        host.offer("rb", lines)
        host.offer("ex", lines)
    trail = []
    for tick["step"] in range(1, len(burns) + 1):
        dec = host.control_step()
        aggressor = host.ledger.aggressor_for("ex")
        host.step()
        rb = host.tenant("rb")
        trail.append({"step": tick["step"], "decision": dec,
                      "aggressor_for_ex": aggressor,
                      "rb_folded": rb.folded_batches,
                      "rb_queued": len(rb.queue),
                      "ex_folded": host.tenant("ex").folded_batches})
    while host.step():
        pass
    _sync(device)
    summary = host.close()
    launches = _launches()
    planes = host.tenant("rb").engine.planes()
    sampler.close()
    dump = flightrec.dump(f"admission_{tag}")
    with open(journal) as fj:
        journaled = [json.loads(ln) for ln in fj]
    with open(dump) as fd:
        flown = [json.loads(ln) for ln in fd]
    key = ("decision", "tenant", "victim", "step")
    want = [tuple(d[k] for k in key) for d in host.admission.decisions]
    in_journal = [tuple(r.get(k) for k in key) for r in journaled
                  if r.get("event") == "admission_decision"]
    in_flight = [tuple(r.get(k) for k in key) for r in flown
                 if r.get("kind") == "admission"]
    if not want or in_journal != want or in_flight != want:
        raise AssertionError(f"[tenants_c {tag}] decisions {want}, "
                             f"metrics.jsonl {in_journal}, flight recorder "
                             f"{in_flight}")
    if not summary["multitenant"]["partition"]["ok"]:
        raise AssertionError(f"[tenants_c {tag}] partition check failed")
    return {"trail": trail, "decisions": list(host.admission.decisions),
            "admission": summary["admission"], "planes": planes,
            "offered": len(batches),
            "tenants": {n: {k: summary["tenants"][n][k] for k in (
                "events", "folded_batches", "queued_batches",
                "dropped_batches")} for n in summary["tenants"]},
            "blame_ms": summary["multitenant"]["matrix_ms"],
            "kernel_launches": launches}


def _tenants_actuator(data: TenantsData, device: str) -> dict:
    """(c): script 1, a breach then health: the defer at priming plus
    ``breach_ticks``, naming rb by the card-measured matrix, rb's folds
    held while the gate is up, the release after ``healthy_ticks``, and
    rb's planes after the drain equal to the reach engine alone; script
    2, a breach that persists: the shed after ``escalate_ticks`` and
    offered = folded + shed + dropped per tenant."""
    adm = TENANTS_ADMISSION
    s1 = _actuator_script(data, device, TENANTS_SCRIPT_DEFER, data.workdir,
                          "defer", escalate_ticks=100,
                          queue_max=TENANTS_ACTUATOR_BATCHES)
    decs = s1["decisions"]
    if [d["decision"] for d in decs] != ["defer", "release"]:
        raise AssertionError(f"[tenants_c] script 1 decisions {decs}")
    defer, release = decs
    want_step = 1 + adm["breach_ticks"]
    row = next(t for t in s1["trail"] if t["step"] == defer["step"])
    if (defer["step"] != want_step or defer["tenant"] != "rb"
            or defer["victim"] != "ex" or not defer["blame_ms"] > 0
            or row["aggressor_for_ex"] is None
            or (defer["tenant"], defer["blame_ms"])
            != tuple(row["aggressor_for_ex"])):
        raise AssertionError(f"[tenants_c] the defer {defer}, want step "
                             f"{want_step} naming rb as "
                             f"aggressor_for('ex') {row['aggressor_for_ex']}")
    gated = [t for t in s1["trail"]
             if defer["step"] <= t["step"] < release["step"]]
    if not gated or len({(t["rb_folded"], t["rb_queued"])
                         for t in gated}) != 1 or not gated[0]["rb_queued"]:
        raise AssertionError(f"[tenants_c] rb moved under the gate: "
                             f"{gated}")
    # steps count from 1: the healthy run starts at the first 0 burn
    # after the priming step
    want_release = TENANTS_SCRIPT_DEFER.index(0.0, 1) + adm["healthy_ticks"]
    if (release["step"] != want_release
            or release["step"] != defer["step"] + len(gated)):
        raise AssertionError(f"[tenants_c] the release {release}, want "
                             f"step {want_release}")
    solo = _tenants_solo(data, "reach",
                         data.batches[:TENANTS_ACTUATOR_BATCHES], device)
    for key in ("mins", "registers"):
        if not _np_equal(s1["planes"][key], solo["planes"][key]):
            raise AssertionError(f"[tenants_c] rb's {key} plane after the "
                                 "drain differs from the engine alone")
    s2 = _actuator_script(data, device, TENANTS_SCRIPT_SHED, data.workdir,
                          "shed", escalate_ticks=3,
                          queue_max=TENANTS_ACTUATOR_QUEUE)
    d2 = s2["decisions"]
    if ([d["decision"] for d in d2] != ["defer", "shed"]
            or d2[1]["step"] != d2[0]["step"] + 3
            or not d2[1].get("escalated")):
        raise AssertionError(f"[tenants_c] script 2 decisions {d2}")
    shed = {"rb": s2["admission"]["batches_shed"], "ex": 0}
    for n, t in s2["tenants"].items():
        if (s2["offered"] != t["folded_batches"] + shed[n]
                + t["dropped_batches"] or t["queued_batches"]):
            raise AssertionError(f"[tenants_c] {n}: offered "
                                 f"{s2['offered']}, folded "
                                 f"{t['folded_batches']}, shed {shed[n]}, "
                                 f"dropped {t['dropped_batches']}")
    if not shed["rb"]:
        raise AssertionError("[tenants_c] script 2 shed nothing")
    for s in (s1, s2):
        del s["planes"]
    return {"defer": s1, "shed": s2, "admission_kw": dict(adm),
            "kernel_launches": {k: s1["kernel_launches"][k]
                                + s2["kernel_launches"][k]
                                for k in s1["kernel_launches"]}}


def _tenants_cli_start(data: TenantsData, device: str) -> dict:
    """(d): the engine CLI's ``--tenants`` over a topic of the journal's
    first ``TENANTS_CLI_EVENTS`` events, its own process, started at the
    phase's start and read before (a)."""
    lines = [ln for b in data.batches for ln in b][:TENANTS_CLI_EVENTS]
    with data.broker.writer(TENANTS_CLI_TOPIC, append=False) as w:
        w.append_bytes(b"\n".join(lines) + b"\n")
    conf_dir = os.path.join(data.workdir, "cli")
    os.makedirs(conf_dir)
    _config(conf_dir, {"kafka.topic": TENANTS_CLI_TOPIC})
    run = _cli(["streambench_tpu_torch.engine", "--confPath",
                os.path.join(conf_dir, "benchmarkConf.yaml"),
                "--workdir", data.workdir, "--brokerDir",
                os.path.join(data.workdir, "broker"), "--tenants",
                TENANTS_CLI_SPEC, "--catchup", "--device", device],
               os.path.join(data.workdir, "tenants_cli.out"))
    run["events"] = len(lines)
    return run


def _tenants_cli_finish(run: dict) -> dict:
    stats = _cli_finish("tenants_cli", run)
    names = [s.split(":")[0] for s in TENANTS_CLI_SPEC.split(",")]
    if (stats.get("engine") != "multitenant"
            or stats.get("partition_ok") is not True
            or sorted(stats["tenants"]) != sorted(names)
            or any(t["events"] != run["events"]
                   for t in stats["tenants"].values())):
        raise AssertionError(f"[tenants_cli] {stats}, want every tenant "
                             f"at the topic's {run['events']} events")
    return stats


def phase_tenants(device: str = "cuda",
                  events: int = TENANTS_EVENTS) -> dict:
    """Phase 23 (module doc): the multi-tenant host.  (d)'s CLI runs as
    its own process beside (c), whose gates hold at any speed, and ends
    before (a) and (b), whose speeds are findings.  ``device`` and the
    size are arguments so the phase can be rehearsed on the CPU."""
    t0 = time.perf_counter()
    data = TenantsData(events)
    cli = None
    out: dict = {"generate_s": data.generate_s}
    lap = Laps()
    parts = out["parts_s"] = lap.seconds
    try:
        run = _tenants_isolation_run(data, device)
        lap("isolation_runs")
        # (d) beside what holds at any speed: (a)'s checks, (c) and the
        # flash crowd's world
        cli = _tenants_cli_start(data, device)
        out["isolation"] = _tenants_isolation(data, run, device)
        lap("isolation")
        out["actuator"] = _tenants_actuator(data, device)
        lap("actuator")
        f = dict(TENANTS_FLASH)
        world = _flash_world(f)
        lap("flash_world")
        out["cli"] = _tenants_cli_finish(cli)
        cli = None
        lap("cli")
        out["flash"] = _tenants_flash(device, data.workdir, f, world)
        lap("flash")
    finally:
        if cli is not None:                # stop what a failure left
            cli["proc"].kill()
            cli["proc"].wait()
        data.remove()
    out["phase_s"] = time.perf_counter() - t0
    a, b, c = out["isolation"], out["flash"], out["actuator"]
    print(f"[tenants] (a) {a['tenants']} over {a['events']} events each "
          f"({a['batches']} batches, sample_every {a['sample_every']}): "
          f"rows equal each engine alone, the oracle exact, launches "
          f"{a['kernel_launches']} = alone; ev/s by process_lines "
          f"time under the host "
          + ", ".join(f"{n} {v:.0f}" for n, v in
                      a["events_per_s_host"].items())
          + "; alone " + ", ".join(f"{n} {v:.0f}" for n, v in
                                   a["events_per_s_alone"].items())
          + f"; the host's loop {a['wall_s']:.3f} s, the engines' loops "
          f"alone {a['alone_wall_s']:.3f} s"
          + "; attributed busy ms " + ", ".join(
              f"{n} {v:.3f}" for n, v in a["attributed_busy_ms"].items())
          + f"; offdiag_ratio {a['offdiag_ratio']}", flush=True)
    for arm in ("off", "on"):
        r = b[arm]
        print(f"[tenants] (b) {arm} arm: victim breach ratio "
              f"{r['breach_ratio']} (objective {TENANTS_FLASH['objective_ms']}"
              f" ms), e2e p50/p99 {r['e2e_p50_ms']}/{r['e2e_p99_ms']} ms, "
              f"offdiag_ratio {r['offdiag_ratio']}, decisions "
              f"{[d['decision'] for d in r['decisions']]}, events "
              f"{r['events']}, busy ms {r['busy_ms']}", flush=True)
    script1 = [(d["decision"], d["step"], d["blame_ms"])
               for d in c["defer"]["decisions"]]
    script2 = [(d["decision"], d["step"]) for d in c["shed"]["decisions"]]
    print(f"[tenants] (c) script 1 {script1}, script 2 {script2}"
          f" shed {c['shed']['admission']['batches_shed']}; (d) CLI "
          f"{out['cli']['events']} events ({out['cli']['wall_s']:.1f} s), "
          f"partition_ok; {out['phase_s']:.1f} s, parts "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()), flush=True)
    return out


def _tenants_launches(p23: dict, kernel: str) -> dict:
    """A kernel's launches on phase 23's in-process paths (the engines
    alone in (a) are the comparison, listed apart)."""
    return {"tenants_host": p23["isolation"]["kernel_launches"][kernel],
            "tenants_alone": p23["isolation"]["solo_launches"][kernel],
            "tenants_flash_off":
                p23["flash"]["off"]["kernel_launches"][kernel],
            "tenants_flash_on": p23["flash"]["on"]["kernel_launches"][kernel],
            "tenants_actuator": p23["actuator"]["kernel_launches"][kernel]}


def _sketch_phases(lap, keep_sketch: bool = False) -> tuple:
    """Phases 15, 16 and 18: the sketch engines, then their sharded forms
    over the same journals.  Returns ((phase 15, phase 16), phase 18,
    what phase 15 kept): with ``keep_sketch`` its journal stays for
    phase 21 (the caller removes it)."""
    sketch, sk_keep = phase_sketches(keep=True)
    lap("15 sketches")
    try:
        session, ses_keep = phase_session(keep=True)
    except BaseException:
        sk_keep["data"].remove()
        raise
    lap("16 session")
    sharded = phase_sharded_sketches(sk_keep, ses_keep,
                                     keep_sketch=keep_sketch)
    lap("18 sharded sketches")
    return (sketch, session), sharded, sk_keep


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
    ap.add_argument("--events", type=int, default=1_000_000,
                    help="catchup events for the end-to-end phase")
    ap.add_argument("--out", help="also write every phase's result to "
                    "this JSON file")
    ap.add_argument("--only-sketches", action="store_true",
                    help="a diagnostic: the device, the build, the kernel "
                    "cases and phase 15 alone (no result line)")
    ap.add_argument("--only-session", action="store_true",
                    help="a diagnostic: phases 1-3 and 16 alone (no result "
                    "line)")
    ap.add_argument("--only-sharded-sketches", action="store_true",
                    help="a diagnostic: phases 1-3 (K1 and K3 cases), 15, "
                    "16 and 18 alone (no result line)")
    ap.add_argument("--only-reach", action="store_true",
                    help="a diagnostic: phases 1-3 and 19 alone (no result "
                    "line)")
    ap.add_argument("--only-fleet", action="store_true",
                    help="a diagnostic: phases 1-3 and 20 alone (no result "
                    "line)")
    ap.add_argument("--only-hllx-reach", action="store_true",
                    help="a diagnostic: phases 1-3, 15, 19 and 21 alone (no "
                    "result line)")
    ap.add_argument("--only-microbatch-dims", action="store_true",
                    help="a diagnostic: phases 1-3 and 22 alone (no result "
                    "line)")
    ap.add_argument("--only-tenants", action="store_true",
                    help="a diagnostic: phases 1-3 and 23 alone (no result "
                    "line)")
    ap.add_argument("--only-sharded-ranks", action="store_true",
                    help="a diagnostic: phases 1-3 and 17 (d), --sharded "
                    "over 2 ranks from the engine CLI, alone over a config "
                    "#5 journal of RANKS_ONLY_EVENTS (no result line)")
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
    if args.only_sharded_sketches:
        cms_cases = phase_cms_kernels(floor)
        lap("1-3 device, build, K1 and K3 cases")
        sketch, sharded, _ = _sketch_phases(lap)
        laps = lap.as_dict()
        print(f"[smoke] seconds by phase {json.dumps(laps)}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"kernel_cases": cases, "cms_cases": cms_cases,
                           "sketches": sketch[0], "session": sketch[1],
                           "sharded_sketches": sharded,
                           "phase_seconds": laps, "nvidia_smi": smi}, f,
                          indent=1)
        print(smi, flush=True)
        return 0
    if args.only_reach:
        lap("1-3 device, build, K1 cases")
        reach = phase_reach()
        lap("19 reach")
        laps = lap.as_dict()
        print(f"[smoke] seconds by phase {json.dumps(laps)}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"kernel_cases": cases, "reach": reach,
                           "phase_seconds": laps, "nvidia_smi": smi}, f,
                          indent=1)
        print(smi, flush=True)
        return 0
    if args.only_fleet:
        lap("1-3 device, build, K1 cases")
        fleet = phase_fleet()
        lap("20 fleet")
        laps = lap.as_dict()
        print(f"[smoke] seconds by phase {json.dumps(laps)}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"kernel_cases": cases, "fleet": fleet,
                           "phase_seconds": laps, "nvidia_smi": smi}, f,
                          indent=1)
        print(smi, flush=True)
        return 0
    if args.only_hllx_reach:
        lap("1-3 device, build, K1 cases")
        sketch, sk_keep = phase_sketches(keep=True)
        lap("15 sketches")
        try:
            reach, reach_keep = phase_reach(keep=True)
        except BaseException:
            sk_keep["data"].remove()
            raise
        lap("19 reach")
        hllx_reach = phase_hllx_reach(sk_keep, reach_keep)
        lap("21 hllx, sharded reach")
        laps = lap.as_dict()
        print(f"[smoke] seconds by phase {json.dumps(laps)}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"kernel_cases": cases, "sketches": sketch,
                           "reach": reach, "hllx_reach": hllx_reach,
                           "phase_seconds": laps, "nvidia_smi": smi}, f,
                          indent=1)
        print(smi, flush=True)
        return 0
    if args.only_microbatch_dims:
        lap("1-3 device, build, K1 cases")
        mb_dims = phase_microbatch_dims()
        lap("22 micro-batch, handoff, dimensions")
        laps = lap.as_dict()
        print(f"[smoke] seconds by phase {json.dumps(laps)}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"kernel_cases": cases, "microbatch_dims": mb_dims,
                           "phase_seconds": laps, "nvidia_smi": smi}, f,
                          indent=1, default=str)
        print(smi, flush=True)
        return 0
    if args.only_tenants:
        lap("1-3 device, build, K1 cases")
        tenants = phase_tenants()
        lap("23 tenants")
        laps = lap.as_dict()
        print(f"[smoke] seconds by phase {json.dumps(laps)}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"kernel_cases": cases, "tenants": tenants,
                           "phase_seconds": laps, "nvidia_smi": smi}, f,
                          indent=1, default=str)
        print(smi, flush=True)
        return 0
    if args.only_sharded_ranks:
        lap("1-3 device, build, K1 cases")
        data = Config5Data(RANKS_ONLY_EVENTS, name="smoke_ranks")
        try:
            ranks = _RanksCli(data).finish(None)
        finally:
            data.remove()
        lap("17 (d) sharded over ranks")
        laps = lap.as_dict()
        print(f"[smoke] seconds by phase {json.dumps(laps)}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"kernel_cases": cases, "sharded_ranks": ranks,
                           "phase_seconds": laps, "nvidia_smi": smi}, f,
                          indent=1)
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
        # the cut that pays for phase 18: (c)'s at-least-once check
        chaos = phase_chaos(config5, check_config5=False,
                            config5_keys=CHAOS_CONFIG5_KEYS)
        lap("14 chaos")
        sharded = phase_sharded(config5, large_rows, large)
        lap("17 config #5 sharded")
    finally:
        config5.remove()
    del large_rows
    (sketch, session), sharded_sketch, sk_keep = _sketch_phases(
        lap, keep_sketch=True)
    try:
        reach, reach_keep = phase_reach(keep=True)
    except BaseException:
        sk_keep["data"].remove()
        raise
    lap("19 reach")
    try:
        fleet = phase_fleet()
    except BaseException:
        sk_keep["data"].remove()
        reach_keep["data"].remove()
        raise
    lap("20 fleet")
    hllx_reach = phase_hllx_reach(sk_keep, reach_keep)
    lap("21 hllx, sharded reach")
    mb_dims = phase_microbatch_dims()
    lap("22 micro-batch, handoff, dimensions")
    tenants = phase_tenants()
    lap("23 tenants")
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
            # by rank; on one card the path is refused, not run
            f"sharded_config5_{RANKS}_ranks": sharded["multi_rank"].get(
                "count_cells_launches_by_rank",
                f"not run: {sharded['multi_rank']['multi_rank']}"),
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
               for k in SESSION_RUNS},
            **{f"sharded_sketch_{k}":
               sharded_sketch[k]["count_cells_launches"]
               for k in SHARDED_SKETCH_RUNS},
            **_reach_launches(reach, "count_cells"),
            **_fleet_launches(fleet, "count_cells"),
            **_hllx_reach_launches(hllx_reach, "count_cells"),
            **_microbatch_dims_launches(mb_dims, "count_cells"),
            **_tenants_launches(tenants, "count_cells")},
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
                chaos["decode"]["decode_rows_launches"],
            **_reach_launches(reach, "decode_rows"),
            **_fleet_launches(fleet, "decode_rows"),
            **_hllx_reach_launches(hllx_reach, "decode_rows"),
            **_microbatch_dims_launches(mb_dims, "decode_rows"),
            **_tenants_launches(tenants, "decode_rows")},
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
            **{f"session_{k}": session[k]["cms_rows_launches"]
               for k in SESSION_RUNS},
            **{f"sharded_session_{k}":
               sharded_sketch[k]["cms_rows_launches"]
               for k in ("fixed", "salsa")},
            **_reach_launches(reach, "cms_rows"),
            **_fleet_launches(fleet, "cms_rows"),
            **_hllx_reach_launches(hllx_reach, "cms_rows"),
            **_microbatch_dims_launches(mb_dims, "cms_rows"),
            **_tenants_launches(tenants, "cms_rows")},
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
                       "sharded_sketches": sharded_sketch,
                       "reach": reach,
                       "fleet": fleet,
                       "hllx_reach": hllx_reach,
                       "microbatch_dims": mb_dims,
                       "tenants": tenants,
                       "nvidia_smi": smi,
                       "ptxas": ptxas}, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
