"""Engine process CLI for the PyTorch port — exact count only.

Loads the config, builds the ``AdAnalyticsEngine`` on the requested device
(``--device``, default ``cuda``), tails the file-journal topic, flushes the
canonical Redis window schema, and at the end (catchup drained, duration,
idle timeout, or SIGTERM) closes the engine and prints the same JSON stats
line as ``python -m streambench_tpu.engine``.  Any key space the config
names runs (config #5's 1,000,000 campaigns take the large-key-space
drains); ``--checkpointDir`` saves (offset, state) snapshots there and
resumes from the newest one at start; ``jax.sink.exactly_once: true``
turns on the fenced exactly-once writeback.

    python -m streambench_tpu_torch.engine --confPath conf/benchmarkConf.yaml \
        --workdir RUN_DIR --catchup [--device cuda|cpu] [--checkpointDir D]

Options and config keys that need parts of the JAX engine not ported yet
(other engines, sharding, device traces, the fork's micro-batch mode,
tenants, the staged ingest pipeline, device decode, the encode pool, the
dead-letter queue, Kafka, observability, SLOs) are refused with exit 2.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import ConfigError, find_and_read_config_file
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine.pipeline import AdAnalyticsEngine
from streambench_tpu_torch.engine.runner import StreamRunner
from streambench_tpu_torch.io.fakeredis import make_store
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import as_redis
from streambench_tpu_torch.io.resp import RespClient


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
    # flags of the JAX CLI whose machinery is not ported yet: accepted
    # only to refuse them with a clear message
    p.add_argument("--sharded", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--engine", default="exact", help=argparse.SUPPRESS)
    p.add_argument("--traceDir", default=None, help=argparse.SUPPRESS)
    p.add_argument("--microbatch", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--tenants", default=None, help=argparse.SUPPRESS)
    return p


def unsupported(args, cfg) -> list[str]:
    """What this run asks for beyond what the port runs: the exact-count
    engine on one device, at any key space, with checkpoint/resume and
    the exactly-once sink."""
    out = []
    for flag, on in (("--sharded", args.sharded),
                     ("--engine " + str(args.engine), args.engine != "exact"),
                     ("--traceDir", args.traceDir),
                     ("--microbatch", args.microbatch),
                     ("--tenants", args.tenants)):
        if on:
            out.append(flag)
    for key, on in (
            ("jax.tenants", cfg.jax_tenants),
            ("jax.ingest.pipeline", cfg.jax_ingest_pipeline != "off"),
            ("jax.decode.device", cfg.jax_decode_device != "off"),
            ("jax.encode.workers", cfg.jax_encode_workers > 1),
            ("jax.deadletter.enabled", cfg.jax_deadletter_enabled),
            ("kafka.bootstrap", cfg.kafka_bootstrap),
            ("kafka.fake", cfg.kafka_fake),
            ("jax.metrics.interval.ms", cfg.jax_metrics_interval_ms > 0),
            ("jax.metrics.port", cfg.jax_metrics_port >= 0),
            ("jax.obs.*", any((cfg.jax_obs_lifecycle, cfg.jax_obs_flightrec,
                               cfg.jax_obs_spans, cfg.jax_obs_occupancy,
                               cfg.jax_obs_xfer, cfg.jax_obs_devmem,
                               cfg.jax_obs_shard, cfg.jax_obs_capture,
                               cfg.jax_obs_query, cfg.jax_obs_fleet))),
            ("jax.slo.*", cfg.jax_slo_p99_ms > 0 or cfg.jax_slo_rate_evps > 0)):
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
              "exact count with checkpoints and the exactly-once sink): "
              + ", ".join(missing), file=sys.stderr)
        return 2

    mapping, campaigns = load_mapping(cfg, args.workdir)
    if cfg.redis_host == ":inprocess:":
        redis = as_redis(make_store())
    else:
        redis = RespClient(cfg.redis_host, cfg.redis_port)
    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                               redis=redis, device=args.device)

    broker = FileBroker(args.brokerDir
                        or os.path.join(args.workdir, "broker"))
    broker.create_topic(cfg.kafka_topic)
    n_parts = len(broker.partitions(cfg.kafka_topic))
    # one consumer over the whole topic, every partition
    reader = (broker.multi_reader(cfg.kafka_topic) if n_parts > 1
              else broker.reader(cfg.kafka_topic))
    checkpointer = (Checkpointer(args.checkpointDir) if args.checkpointDir
                    else None)
    runner = StreamRunner(engine, reader, checkpointer=checkpointer)
    if runner.resume():
        print(f"resumed from checkpoint: offset={runner._reader_position()} "
              f"events={engine.events_processed}", flush=True)
    signal.signal(signal.SIGTERM, lambda *_: runner.stop())
    signal.signal(signal.SIGINT, lambda *_: runner.stop())

    # Build the kernels and run every device path once on a throwaway
    # engine before announcing readiness, so the load phase never waits
    # on a compiler.
    warm = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                             device=args.device)
    warm.warmup()
    warm.close()
    del warm

    print(f"engine up: topic={cfg.kafka_topic} redis={cfg.redis_host}:"
          f"{cfg.redis_port} batch={engine.batch_size} "
          f"device={engine.device} method={engine.method}", flush=True)
    if args.catchup:
        stats = runner.run_catchup(max_events=args.maxEvents)
    else:
        stats = runner.run(duration_s=args.duration,
                           idle_timeout_s=args.idleTimeout,
                           max_events=args.maxEvents)
    close_err: BaseException | None = None
    try:
        engine.close()
    except RuntimeError as e:
        # rows declared lost at shutdown: counted in rows_lost by the
        # writer; finish the stats line and exit non-zero
        close_err = e
        print(f"error: {e}", file=sys.stderr, flush=True)
    reader.close()
    rows_lost = engine.faults.get("rows_lost")
    if rows_lost:
        stats.faults = dict(stats.faults, rows_lost=rows_lost)
    print(engine.tracer.report(), file=sys.stderr, flush=True)
    print(engine.latency_tracker.report(), file=sys.stderr, flush=True)
    if runner.stall_detector.stalls:
        print(f"flush stalls: {runner.stall_detector.stalls}",
              file=sys.stderr, flush=True)
    print(json.dumps({
        "events": stats.events, "batches": stats.batches,
        "windows_written": stats.windows_written,
        "events_per_s": round(stats.events_per_s, 1),
        "dropped": engine.dropped, "wall_s": round(stats.wall_s, 2),
        "faults": stats.faults,
    }), flush=True)
    return 1 if close_err is not None else 0


if __name__ == "__main__":
    sys.exit(main())
