"""Engine process CLI for the PyTorch port.

Loads the config, builds the engine ``--engine`` names on the requested
device (``--device``, default ``cuda``): ``exact`` (default), the exact
count of BASELINE config #1; ``hll``, HLL distinct users per window
(config #2); ``sliding``, sliding-window counts with t-digest latency
quantiles (config #3); ``session``, session windows of per-user clicks
feeding a count-min sketch whose top-k heavy hitters go to
``<hashtable>_hh`` at close (config #4; ``jax.cms.mode``,
``jax.cms.cell.bits`` and ``jax.cms.stages`` pick the sketch).  It
tails the broker topic, flushes the canonical Redis window schema, and
at the end (catchup drained, duration,
idle timeout, or SIGTERM) closes the engine and prints the same JSON stats
line as ``python -m streambench_tpu.engine``.  ``--sharded`` runs the exact
engine on the ``(data, campaign)`` mesh of ``jax.mesh.shape``
(``parallel.ShardedWindowEngine``, one rank: NCCL on the card, gloo on the
CPU), as ``bench.py`` runs BASELINE #5.  Any key space the config
names runs (config #5's 1,000,000 campaigns take the large-key-space
drains); ``--checkpointDir`` saves (offset, state) snapshots there and
resumes from the newest one at start; ``jax.sink.exactly_once: true``
turns on the fenced exactly-once writeback.

The source side: the broker is the file journal, the fake Kafka broker
(``kafka.fake: true``; in process, or the ``START_KAFKA`` server named by
``kafka.bootstrap``) or a real cluster (``kafka.bootstrap`` with
confluent-kafka installed; without it the CLI fails, never falls back).
``jax.ingest.pipeline`` (off/on/auto) overlaps read, encode and fold on
their own threads; ``jax.encode.workers > 1`` encodes on a pool of native
encoders; ``jax.deadletter.enabled`` journals malformed events to
``<topic>-deadletter``.  ``jax.decode.device`` (off/on/auto) decodes
raw journal blocks on the device (``ops.devdecode``: the host probes,
the decode kernel K2 turns bytes into columns, K1 counts them).

Observability (``obs/``, all default-off) takes the JAX CLI's keys:
``jax.metrics.interval.ms`` / ``jax.metrics.port`` (the
``metrics.jsonl`` sampler and the Prometheus endpoint),
``jax.obs.lifecycle``, ``jax.obs.flightrec.enabled`` (a
``flight_sigterm.jsonl`` dump on SIGTERM), ``jax.obs.spans``
(``trace_<pid>.json``), ``jax.obs.occupancy``, ``jax.obs.xfer``,
``jax.obs.devmem``, ``jax.obs.capture.*`` (``torch.profiler`` windows on
an SLO breach, SIGUSR2 or a one-shot) and ``jax.slo.*``; ``--traceDir``
profiles the whole run.

    python -m streambench_tpu_torch.engine --confPath conf/benchmarkConf.yaml \
        --workdir RUN_DIR --catchup [--engine exact|hll|sliding|session] \
        [--device cuda|cpu] [--checkpointDir D] [--sharded]

``jax.obs.shard`` with ``--sharded`` adds the per-shard skew
(``shard_skew`` in the stats line and the sampler's records).

Options and config keys that need parts of the JAX engine not ported yet
(the reach and hllx engines, ``--sharded`` with any engine but exact or
with more than one process, the fork's micro-batch mode, tenants, the
reach query and fleet observability) are refused with exit 2.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

import torch.distributed as dist

from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import ConfigError, find_and_read_config_file
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine.pipeline import AdAnalyticsEngine
from streambench_tpu_torch.engine.runner import StreamRunner
from streambench_tpu_torch.engine.sketches import (
    HLLDistinctEngine,
    SessionCMSEngine,
    SlidingTDigestEngine,
)
from streambench_tpu_torch.io.fakeredis import make_store
from streambench_tpu_torch.io.kafka import make_broker
from streambench_tpu_torch.io.redis_schema import as_redis
from streambench_tpu_torch.io.resp import RespClient
from streambench_tpu_torch.obs import (
    CaptureManager,
    DeviceMemoryLedger,
    FlightRecorder,
    MetricsRegistry,
    MetricsSampler,
    MetricsServer,
    OccupancySampler,
    ShardSkew,
    SloTracker,
    SpanTracer,
    TransferLedger,
    engine_collector,
    kafka_collector,
)
from streambench_tpu_torch.ops import cmsrows
from streambench_tpu_torch.ops.count import count_cells
from streambench_tpu_torch.ops.decode import decode_rows
from streambench_tpu_torch.parallel import ShardedWindowEngine, mesh_from_config
from streambench_tpu_torch.parallel.mesh import CAMPAIGN_AXIS, DATA_AXIS
from streambench_tpu_torch.trace import device_trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="streambench-torch-engine")
    p.add_argument("--confPath", default="./benchmarkConf.yaml")
    p.add_argument("--workdir", default=".",
                   help="where the id/mapping files from -n/-s live")
    p.add_argument("--brokerDir", default=None)
    p.add_argument("--duration", type=float, default=None,
                   help="seconds to run (default: until SIGTERM)")
    p.add_argument("--idleTimeout", type=float, default=None,
                   help="exit after this many idle seconds")
    p.add_argument("--maxEvents", type=int, default=None)
    p.add_argument("--catchup", action="store_true",
                   help="drain the journal at full speed, then exit")
    p.add_argument("--device", default="cuda",
                   help="torch device to fold on: cuda (default) or cpu")
    p.add_argument("--checkpointDir", default=None,
                   help="enable (offset, state) snapshots here; on start, "
                        "resume from the newest one if present")
    p.add_argument("--traceDir", default=None,
                   help="capture a torch.profiler trace of the whole run "
                        "into DIR/trace.json")
    p.add_argument("--engine", default="exact",
                   help="aggregation engine: exact window counts "
                        "(default), hll (HLL distinct users), sliding "
                        "(sliding-window counts + t-digest latency "
                        "quantiles) or session (session windows + "
                        "count-min heavy hitters): BASELINE configs #1-#4")
    p.add_argument("--sharded", action="store_true",
                   help="run the mesh-sharded exact engine (jax.mesh.shape;"
                        " one process: NCCL on cuda, gloo on cpu)")
    # flags of the JAX CLI whose machinery is not ported yet: accepted
    # only to refuse them with a clear message
    p.add_argument("--microbatch", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--tenants", default=None, help=argparse.SUPPRESS)
    return p


#: engines the port runs, by ``--engine`` name
ENGINES = {"exact": AdAnalyticsEngine, "hll": HLLDistinctEngine,
           "sliding": SlidingTDigestEngine, "session": SessionCMSEngine}


def unsupported(args, cfg) -> list[str]:
    """What this run asks for beyond what the port runs: the exact-count,
    HLL, sliding and session engines on one device, at any key space, with
    checkpoint/resume, the exactly-once sink, the staged ingest pipeline,
    the encode pool, the dead-letter queue, the Kafka source, device
    decode (exact engine), the single-engine observability layer, and the
    sharded exact engine in one process (``--sharded``)."""
    out = []
    ranks = int(os.environ.get("STREAMBENCH_NUM_PROCESSES", "1"))
    for flag, on in (("--sharded --engine " + str(args.engine),
                      args.sharded and args.engine != "exact"),
                     (f"--sharded over {ranks} processes",
                      args.sharded and ranks > 1),
                     ("--engine " + str(args.engine),
                      args.engine not in ENGINES),
                     ("--microbatch", args.microbatch),
                     ("--tenants", args.tenants)):
        if on:
            out.append(flag)
    for key, on in (
            ("jax.tenants", cfg.jax_tenants),
            ("jax.obs.query", cfg.jax_obs_query),
            ("jax.obs.fleet", cfg.jax_obs_fleet)):
        if on:
            out.append(key)
    return out


def load_mapping(cfg, workdir: str) -> tuple[dict[str, str], list[str] | None]:
    """Resolve the ad->campaign join table the way the fork does: an explicit
    ``ad_to_campaign_path`` wins (``AdvertisingTopologyNative.java:47-56``),
    else the workdir files written by the generator's ``-n``/``-s`` modes."""
    path = cfg.ad_to_campaign_path or os.path.join(
        workdir, gen.AD_TO_CAMPAIGN_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"ad->campaign mapping not found at {path}; run the generator "
            "-n or -s mode first (or set ad_to_campaign_path)")
    mapping = gen.load_ad_mapping_file(path)
    ids = gen.load_ids(workdir)
    campaigns = ids[0] if ids else None
    return mapping, campaigns


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        cfg = find_and_read_config_file(args.confPath)
    except ConfigError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    missing = unsupported(args, cfg)
    if missing:
        print("error: not ported to the PyTorch engine yet (it runs the "
              "exact, hll, sliding and session engines with checkpoints, "
              "the exactly-once sink, the ingest pipeline, the encode pool, "
              "the dead-letter queue, the Kafka source, the "
              "single-engine observability layer and the sharded exact "
              "engine in one process): " + ", ".join(missing),
              file=sys.stderr)
        return 2

    mapping, campaigns = load_mapping(cfg, args.workdir)
    if cfg.redis_host == ":inprocess:":
        redis = as_redis(make_store())
    else:
        redis = RespClient(cfg.redis_host, cfg.redis_port)
    engine_cls = ENGINES[args.engine]
    mesh = None
    if args.sharded:
        # one rank: a world-size-1 group, NCCL on the card, gloo on the CPU
        try:
            mesh = mesh_from_config(cfg, device=args.device)
        except ValueError as e:
            print(f"error: --sharded: {e}", file=sys.stderr)
            return 2

    def make_engine(r):
        if mesh is not None:
            return ShardedWindowEngine(cfg, mapping, mesh,
                                       campaigns=campaigns, redis=r,
                                       device=args.device)
        return engine_cls(cfg, mapping, campaigns=campaigns, redis=r,
                          device=args.device)

    engine = make_engine(redis)

    broker = make_broker(cfg.kafka_bootstrap_servers,
                         args.brokerDir
                         or os.path.join(args.workdir, "broker"),
                         fake=cfg.kafka_fake)
    broker.create_topic(cfg.kafka_topic)
    # Dead-letter queue (off by default): malformed events are journaled
    # to <topic>-deadletter instead of only bumping bad_lines.  Wired to
    # the primary encoder; encode pool workers still count rejects but
    # journal only from the primary.
    deadletter = None
    if cfg.jax_deadletter_enabled:
        deadletter = broker.writer(f"{cfg.kafka_topic}-deadletter")
        engine.encoder.set_deadletter(deadletter)
    n_parts = len(broker.partitions(cfg.kafka_topic))
    # one consumer over the whole topic, every partition
    reader = (broker.multi_reader(cfg.kafka_topic) if n_parts > 1
              else broker.reader(cfg.kafka_topic))
    checkpointer = (Checkpointer(args.checkpointDir) if args.checkpointDir
                    else None)
    # Crash flight recorder (obs.flightrec, default-off): a bounded ring
    # the runner and the ingest stages feed at flush cadence, dumped to
    # <workdir>/flight_<reason>.jsonl on a crash or SIGTERM.
    flightrec = None
    if cfg.jax_obs_flightrec:
        flightrec = FlightRecorder(
            args.workdir, capacity=cfg.jax_obs_flightrec_capacity)
    # Span tracer (obs.spans, default-off): the bounded ring of closed
    # stage/read spans, dumped as Chrome trace JSON at exit; flight dumps
    # embed its tail.
    spans = None
    if cfg.jax_obs_spans:
        spans = SpanTracer(capacity=cfg.jax_obs_spans_capacity)
        if flightrec is not None:
            flightrec.span_source = spans.tail
    runner = StreamRunner(engine, reader, checkpointer=checkpointer,
                          ingest_pipeline=cfg.jax_ingest_pipeline,
                          flightrec=flightrec, spans=spans)
    if runner.resume():
        print(f"resumed from checkpoint: offset={runner._reader_position()} "
              f"events={engine.events_processed}", flush=True)
    # The handlers only set flags: the flight dump and the capture
    # trigger take locks the host loop may hold when a signal lands, so
    # they run on the host loop (the dump once the run has stopped, the
    # capture at the next flush tick).
    signals = {"sigterm": False, "sigusr2": False}

    def _on_sigterm(*_):
        signals["sigterm"] = True
        runner.stop()

    signal.signal(signal.SIGTERM, _on_sigterm)
    signal.signal(signal.SIGINT, lambda *_: runner.stop())

    # Build the kernels and run every device path once on a throwaway
    # engine before announcing readiness, so the load phase never waits
    # on a compiler.
    warm = make_engine(None)
    warm.settle_decode(runner._pipeline_on())
    warm.warmup()
    warm.close()
    del warm

    # Live telemetry (obs/, default-off): jax.metrics.interval.ms > 0
    # starts the sampler journaling snapshots to <workdir>/metrics.jsonl;
    # jax.metrics.port >= 0 serves the localhost Prometheus endpoint
    # (0 = ephemeral, the chosen port is printed below).
    sampler = metrics_server = occupancy = slo = None
    xfer = devmem = capture = shard = None
    slo_wanted = cfg.jax_slo_p99_ms > 0 or cfg.jax_slo_rate_evps > 0
    shard_wanted = cfg.jax_obs_shard and mesh is not None
    flush_hooks = []
    if (cfg.jax_metrics_interval_ms > 0 or cfg.jax_metrics_port >= 0
            or cfg.jax_obs_lifecycle or cfg.jax_obs_spans
            or cfg.jax_obs_occupancy or slo_wanted
            or cfg.jax_obs_xfer or cfg.jax_obs_devmem
            or cfg.jax_obs_capture or shard_wanted):
        registry = MetricsRegistry()
        # jax.obs.occupancy: sampled CUDA-event-timed dispatches -> the
        # MEASURED device_busy_ratio, plus the kernel-library build
        # detector (mark_steady below, once everything is built)
        if cfg.jax_obs_occupancy:
            occupancy = OccupancySampler(
                registry, sample_every=cfg.jax_obs_occupancy_sample)
        # jax.obs.xfer: host->device transfer ledger — exact payload
        # bytes per dispatch by wire format + 1-in-N timed copies
        if cfg.jax_obs_xfer:
            xfer = TransferLedger(registry,
                                  sample_every=cfg.jax_obs_xfer_sample)
        # jax.obs.shard: per-shard routed-row skew gauges (the sharded
        # engine only; the flag is inert without --sharded)
        if cfg.jax_obs_shard and mesh is not None:
            shard = ShardSkew(registry, n_shards=mesh.shape[CAMPAIGN_AXIS])
        engine.attach_obs(registry, lifecycle=cfg.jax_obs_lifecycle,
                          spans=spans, occupancy=occupancy, xfer=xfer,
                          shard=shard)
        # jax.obs.devmem: K1's launch footprints once, the allocator
        # census on the host loop at flush cadence
        if cfg.jax_obs_devmem:
            devmem = DeviceMemoryLedger(registry)
            devmem.analyze_engine(engine)
            devmem.poll()
            flush_hooks.append(devmem.poll)
        metrics_path = os.path.join(args.workdir, "metrics.jsonl")
        sampler = MetricsSampler(
            metrics_path,
            interval_ms=cfg.jax_metrics_interval_ms or 1000,
            registry=registry,
            max_bytes=cfg.jax_metrics_max_bytes)
        sampler.add_collector(engine_collector(
            engine, reader=reader, runner=runner, registry=registry))
        # Kafka delivery ledger: the adapter's shared FaultCounters carry
        # the produced/delivered/redelivered accounting
        if getattr(broker, "counters", None) is not None:
            sampler.add_collector(kafka_collector(
                broker.counters, lag=getattr(reader, "lag", None),
                registry=registry))
        if devmem is not None:
            sampler.add_collector(devmem.collect)
        # jax.obs.capture.*: bounded triggered torch.profiler windows
        # into <workdir>/xprof_<ms>_<reason>/ on an SLO breach, SIGUSR2
        # or the one-shot, started and stopped on the host loop
        if cfg.jax_obs_capture:
            capture = CaptureManager(
                args.workdir,
                cooldown_s=cfg.jax_obs_capture_cooldown_s,
                max_captures=cfg.jax_obs_capture_max,
                window_s=cfg.jax_obs_capture_window_s,
                registry=registry, flightrec=flightrec,
                annotate=sampler.annotate, device=engine.device)
            capture.warm()
            signal.signal(signal.SIGUSR2,
                          lambda *_: signals.__setitem__("sigusr2", True))
            oneshot = [cfg.jax_obs_capture_oneshot]

            def capture_tick() -> None:
                if signals["sigusr2"]:
                    signals["sigusr2"] = False
                    capture.trigger("sigusr2")
                # the config one-shot traces the first window_s of the
                # stream: it fires at the first flush with events folded
                # (a paced run's engine is up before its generator)
                if oneshot[0] and engine.events_processed:
                    oneshot[0] = False
                    capture.trigger("oneshot")
                capture.poll()

            flush_hooks.append(capture_tick)
        # SLO burn-rate tracking (obs.slo): collects AFTER the engine
        # collector so rec["events"]/["events_per_s"] feed the rate
        # objective; breach transitions are journaled and recorded
        if slo_wanted:
            slo = SloTracker(
                registry, p99_ms=cfg.jax_slo_p99_ms,
                rate_evps=cfg.jax_slo_rate_evps,
                budget=cfg.jax_slo_budget, fast_s=cfg.jax_slo_fast_s,
                slow_s=cfg.jax_slo_slow_s,
                use_lifecycle=cfg.jax_obs_lifecycle,
                annotate=sampler.annotate, flightrec=flightrec,
                capture=capture)
            sampler.add_collector(slo.collect)
        sampler.start()
        endpoint = ""
        if cfg.jax_metrics_port >= 0:
            metrics_server = MetricsServer(registry,
                                           port=cfg.jax_metrics_port,
                                           refresh=sampler.collect_now)
            endpoint = f" endpoint={metrics_server.url}"
        print(f"metrics: interval={sampler.interval_ms}ms "
              f"jsonl={metrics_path}{endpoint}", flush=True)
    runner.flush_hooks = tuple(flush_hooks)
    # everything is built now; a build from here on is a mid-run stall
    if occupancy is not None:
        occupancy.mark_steady()
    # the kernels' launches over the run itself (warmup's excluded); CPU
    # folds take the plain versions and launch nothing
    count_cells.launches = 0
    decode_rows.launches = 0
    cmsrows.reset_launches()

    print(f"engine up: engine={args.engine} topic={cfg.kafka_topic} "
          f"redis={cfg.redis_host}:"
          f"{cfg.redis_port} batch={engine.batch_size} "
          f"device={engine.device} method={engine.method} "
          f"pipeline={'on' if runner._pipeline_on() else 'off'} "
          f"decode={'device' if engine._devdecode is not None else 'host'} "
          f"encode_workers={cfg.jax_encode_workers}"
          + (f" mesh={mesh.shape[DATA_AXIS]}x{mesh.shape[CAMPAIGN_AXIS]} "
             f"backend={mesh.backend}" if mesh is not None else ""),
          flush=True)
    try:
        with device_trace(args.traceDir, engine.device):
            if args.catchup:
                stats = runner.run_catchup(max_events=args.maxEvents)
            else:
                stats = runner.run(duration_s=args.duration,
                                   idle_timeout_s=args.idleTimeout,
                                   max_events=args.maxEvents)
    finally:
        if signals["sigterm"] and flightrec is not None:
            flightrec.record("signal", event="sigterm")
            flightrec.dump("sigterm")
    if capture is not None:
        # stop any in-flight capture (host loop's thread) and record
        # where the evidence lives
        capture.close()
    close_err: BaseException | None = None
    try:
        engine.close()
    except RuntimeError as e:
        # rows declared lost at shutdown: counted in rows_lost by the
        # writer; finish the stats line and exit non-zero
        close_err = e
        print(f"error: {e}", file=sys.stderr, flush=True)
    reader.close()
    if deadletter is not None:
        deadletter.close()
    rows_lost = engine.faults.get("rows_lost")
    if rows_lost:
        stats.faults = dict(stats.faults, rows_lost=rows_lost)
        if flightrec is not None:
            flightrec.dump("rows_lost", terminal={
                "kind": "fault", "event": "rows_lost",
                "rows_lost": rows_lost, "error": repr(close_err)})
    print(engine.tracer.report(), file=sys.stderr, flush=True)
    print(engine.latency_tracker.report(), file=sys.stderr, flush=True)
    if runner._pipeline is not None:
        print(f"ingest pipeline: {json.dumps(runner._pipeline.telemetry())}",
              file=sys.stderr, flush=True)
    if runner.stall_detector.stalls:
        print(f"flush stalls: {runner.stall_detector.stalls}",
              file=sys.stderr, flush=True)
    stats_line = {
        "events": stats.events, "batches": stats.batches,
        "windows_written": stats.windows_written,
        "events_per_s": round(stats.events_per_s, 1),
        "dropped": engine.dropped, "wall_s": round(stats.wall_s, 2),
        "faults": stats.faults,
        "kernel_launches": {"count_cells": count_cells.launches,
                            "decode_rows": decode_rows.launches,
                            "cms_rows": cmsrows.kernel_launches()},
    }
    if occupancy is not None:
        # the MEASURED busy ratio + the steady-state build invariant
        occ_sum = occupancy.summary()
        stats_line["device_busy_ratio"] = occ_sum["device_busy_ratio"]
        stats_line["occupancy"] = occ_sum
        steady = (occ_sum.get("compiles") or {}).get("compiles_steady")
        if steady:
            print(f"WARNING: {steady} kernel-library build(s) landed "
                  "after warmup", file=sys.stderr, flush=True)
            if flightrec is not None:
                flightrec.record("steady_compiles", count=steady)
        occupancy.close()
    if slo is not None:
        stats_line["slo"] = slo.verdict()
    if engine._obs_lifecycle is not None:
        # what the attribution's clamping added, beside its sums
        stats_line["attribution_clamps"] = engine._obs_lifecycle.clamps()
    if xfer is not None:
        stats_line["xfer"] = xfer.summary()
    if devmem is not None:
        devmem.refresh_census()
        stats_line["devmem"] = devmem.summary()
    if capture is not None:
        stats_line["capture"] = capture.summary()
    if shard is not None:
        shard_sum = shard.summary()
        if shard_sum is not None:
            stats_line["shard_skew"] = shard_sum
    if spans is not None:
        trace_path = os.path.join(args.workdir,
                                  f"trace_{os.getpid()}.json")
        spans.dump(trace_path, run=cfg.kafka_topic)
        print(f"trace: {trace_path} ({len(spans)} spans, "
              f"{spans.dropped} dropped)", file=sys.stderr, flush=True)
    if sampler is not None:
        # final telemetry record AFTER close(): the writer has drained,
        # so the record's counters and the run_stats it carries agree
        sampler.close(final=stats_line)
    if metrics_server is not None:
        metrics_server.close()
    print(json.dumps(stats_line), flush=True)
    if mesh is not None:
        dist.destroy_process_group()
    return 1 if close_err is not None else 0


if __name__ == "__main__":
    sys.exit(main())
