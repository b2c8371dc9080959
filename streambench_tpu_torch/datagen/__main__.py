"""CLI for the generator/oracle — flag-compatible with the reference
(``cli-options``, ``core.clj:259-271``); the port's copy of
``streambench_tpu/datagen/__main__.py``:

    python -m streambench_tpu_torch.datagen -n  --configPath conf.yaml
    python -m streambench_tpu_torch.datagen -r -t 1000 [-w] --configPath conf.yaml
    python -m streambench_tpu_torch.datagen -g  --configPath conf.yaml
    python -m streambench_tpu_torch.datagen -s  --configPath conf.yaml
    python -m streambench_tpu_torch.datagen -c  --configPath conf.yaml

Extra (new-framework) flags: ``--brokerDir`` (file-broker directory; defaults
next to the workdir), ``--duration`` / ``--maxEvents`` bounds for ``-r``, and
``--workdir`` for the id/journal files (reference uses the cwd).
"""

from __future__ import annotations

import argparse
import sys

from streambench_tpu_torch.config import ConfigError, load_config_or_default
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.io.kafka import make_broker
from streambench_tpu_torch.io.resp import RespClient


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="streambench-datagen")
    p.add_argument("-s", "--setup", action="store_true",
                   help="Set up for catchup-simulation-mode")
    p.add_argument("-c", "--check", action="store_true",
                   help="Check catchup-mode data was processed correctly")
    p.add_argument("-n", "--new", action="store_true",
                   help="Set up redis for a new real-time simulation")
    p.add_argument("--reuse-ids", action="store_true",
                   help="with -n: seed from the workdir's existing "
                        "campaign/ad id files instead of regenerating "
                        "(checkpoint resume: snapshots and journaled "
                        "events are keyed to those ids)")
    p.add_argument("-r", "--run", action="store_true",
                   help="Emit events to the broker at a fixed frequency")
    p.add_argument("-t", "--throughput", type=int, default=0,
                   help="events/sec for -r")
    p.add_argument("-w", "--with-skew", action="store_true",
                   help="Add minor skew and late tuples into the mix")
    p.add_argument("-g", "--get-stats", action="store_true",
                   help="Collect end-to-end latency stats from redis")
    p.add_argument("-a", "--configPath", default="./benchmarkConf.yaml")
    p.add_argument("--workdir", default=".")
    p.add_argument("--brokerDir", default=None)
    p.add_argument("--duration", type=float, default=None,
                   help="seconds to run -r for (default: until killed)")
    p.add_argument("--partition", type=int, default=0,
                   help="broker partition -r writes to (several generator "
                        "processes can shard one paced load across "
                        "partitions, like parallel Kafka producers)")
    p.add_argument("--maxEvents", type=int, default=None)
    p.add_argument("--users", type=int, default=100,
                   help="paced-mode user-id universe (default 100, the "
                        "reference's; session workloads need a larger "
                        "one for inter-arrival gaps to exceed the "
                        "session gap)")
    p.add_argument("--eventsNum", type=int, default=None,
                   help="override events.num for -s")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    parser_default = build_parser().get_default("configPath")
    try:
        cfg = load_config_or_default(
            args.configPath,
            is_default_path=args.configPath == parser_default)
    except ConfigError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    broker = make_broker(cfg.kafka_bootstrap_servers,
                         args.brokerDir or f"{args.workdir}/broker",
                         fake=cfg.kafka_fake)

    def redis():
        if cfg.redis_host == ":inprocess:":
            # An in-process store cannot survive across CLI invocations, so
            # -n/-g/-c against it would silently see an empty database.
            print("error: redis.host ':inprocess:' is only valid for "
                  "embedded runs, not the datagen CLI", file=sys.stderr)
            raise SystemExit(2)
        return RespClient(cfg.redis_host, cfg.redis_port)

    if args.setup and args.check:
        print("Specify either --setup OR --check")
        return 2
    if args.setup:
        n = gen.do_setup(redis(), cfg, broker=broker,
                         events_num=args.eventsNum,
                         num_campaigns=cfg.jax_num_campaigns,
                         ads_per_campaign=cfg.jax_ads_per_campaign,
                         workdir=args.workdir,
                         # one broker partition per kafka.partition, so a
                         # count-windowed consumer (map.partitions) can
                         # align with the dataset (stream-bench.sh:107-115)
                         partitions=max(cfg.kafka_partitions, 1),
                         progress=lambda k: print(k, flush=True)
                         if k % 1_000_000 == 0 else None)
        print(f"wrote {n} events")
    elif args.check:
        correct, differ, missing = gen.check_correct(
            redis(), workdir=args.workdir,
            time_divisor_ms=cfg.jax_time_divisor_ms)
        print(f"CORRECT={correct} DIFFER={differ} MISSING={missing}")
        return 0 if differ == 0 and missing == 0 else 1
    elif args.new:
        if args.reuse_ids and gen.do_reseed(redis(),
                                            workdir=args.workdir):
            print("Writing campaigns data to Redis (existing ids).")
        else:
            gen.do_new_setup(redis(), num_campaigns=cfg.jax_num_campaigns,
                             ads_per_campaign=cfg.jax_ads_per_campaign,
                             workdir=args.workdir)
            print("Writing campaigns data to Redis.")
    elif args.run:
        if args.throughput <= 0:
            print("-r requires -t THROUGHPUT > 0")
            return 2
        print(f"Running, emitting {args.throughput} tuples per second.",
              flush=True)
        # STOP_LOAD stops the generator with SIGTERM (stream-bench.sh:231):
        # the handler only raises a flag that run_paced checks between
        # batches, so "emitted N" counts exactly the records that reached
        # the broker, and the writer context still flushes on the way out.
        import signal
        import threading

        stopping = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stopping.set())
        broker.create_topic(cfg.kafka_topic,
                            max(cfg.kafka_partitions, args.partition + 1))
        with broker.writer(cfg.kafka_topic, args.partition) as sink:
            sent = gen.run_paced(
                sink, args.throughput, duration_s=args.duration,
                max_events=args.maxEvents, with_skew=args.with_skew,
                workdir=args.workdir, num_users=args.users,
                on_behind=lambda ms: print(f"Falling behind by: {ms:.0f}ms"),
                stop=stopping.is_set,
            )
        print(f"emitted {sent} events")
    elif args.get_stats:
        stats = gen.get_stats(redis(), workdir=args.workdir)
        print(f"collected {len(stats)} windows")
    else:
        build_parser().print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
