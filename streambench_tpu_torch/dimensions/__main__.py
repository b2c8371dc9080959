"""Dimension-computation app CLI of the PyTorch port.

The port of ``python -m streambench_tpu.dimensions``, with ``--device``
(``cuda`` by default; without CUDA it raises, ``cpu`` only when asked
for).  Peer of the Apex app launches (``stream-bench.sh:268``: ``apex
launch -local``): either self-contained with an in-process JSON generator
(``ApplicationWithGenerator.java:22-58`` — seeds its own join table) or
consuming a broker topic produced by the generator CLI.  Optional pub/sub
query endpoint (the gateway analog; see ``dimensions.pubsub``).

    python -m streambench_tpu_torch.dimensions --generate 100000 \
        --storeDir ./dim-store [--pubsubPort 8890] [--schema schema.json] \
        [--device cuda|cpu]
    python -m streambench_tpu_torch.dimensions --confPath conf.yaml \
        --workdir RUN_DIR --brokerDir DIR --storeDir ./dim-store
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="streambench-torch-dimensions")
    p.add_argument("--confPath", default=None)
    p.add_argument("--workdir", default=".")
    p.add_argument("--brokerDir", default=None)
    p.add_argument("--storeDir", required=True)
    p.add_argument("--schema", default=None,
                   help="eventSchema.json-shaped file (default: built-in "
                        "campaignId / clicks:SUM / latency:MAX)")
    p.add_argument("--generate", type=int, default=None,
                   help="self-contained mode: generate N events in-process "
                        "instead of reading a broker topic")
    p.add_argument("--numCampaigns", type=int, default=100)
    p.add_argument("--adsPerCampaign", type=int, default=10)
    p.add_argument("--pubsubPort", type=int, default=None)
    p.add_argument("--noJoin", action="store_true",
                   help="sentinel-campaign mode (includeRedisJoin=false)")
    p.add_argument("--device", default="cuda",
                   help="torch device the cube folds on: cuda (default) "
                        "or cpu")
    args = p.parse_args(argv)

    import random

    from streambench_tpu_torch.utils.device import resolve_device

    # without CUDA this raises before any server starts
    resolve_device(args.device)

    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.dimensions import DimensionApp, PubSubServer
    from streambench_tpu_torch.dimensions.schema import parse_schema
    from streambench_tpu_torch.utils.ids import now_ms

    schema = None
    if args.schema:
        schema = parse_schema(open(args.schema).read())

    pubsub = None
    if args.pubsubPort is not None:
        pubsub = PubSubServer(port=args.pubsubPort).start()
        print(f"pubsub listening on {pubsub.address[0]}:{pubsub.address[1]}",
              flush=True)

    if args.generate is not None:
        # ApplicationWithGenerator mode: build our own join table
        rng = random.Random(77)
        campaigns = gen.make_ids(args.numCampaigns, rng)
        ads = gen.make_ids(args.numCampaigns * args.adsPerCampaign, rng)
        mapping = {a: campaigns[i % len(campaigns)]
                   for i, a in enumerate(ads)}
        src = gen.EventSource(ads=ads, user_ids=gen.make_ids(100, rng),
                              page_ids=gen.make_ids(100, rng), rng=rng)
        app = DimensionApp(schema, mapping, args.storeDir,
                           campaigns=campaigns,
                           include_join=not args.noJoin, pubsub=pubsub,
                           device=args.device)
        start = now_ms()
        chunk = 8192
        done = 0
        while done < args.generate:
            n = min(chunk, args.generate - done)
            lines = [e.encode() for e in src.events_at(
                start + 10 * (done + i) for i in range(n))]
            app.process_lines(lines)
            app.flush()
            done += n
    else:
        from streambench_tpu_torch.config import find_and_read_config_file
        from streambench_tpu_torch.io.journal import FileBroker

        if not args.confPath:
            print("error: --confPath required without --generate",
                  file=sys.stderr)
            return 2
        cfg = find_and_read_config_file(args.confPath)
        mapping = gen.load_ad_mapping_file(
            cfg.ad_to_campaign_path
            or os.path.join(args.workdir, gen.AD_TO_CAMPAIGN_FILE))
        ids = gen.load_ids(args.workdir)
        campaigns = ids[0] if ids else None
        app = DimensionApp(schema, mapping, args.storeDir,
                           campaigns=campaigns,
                           include_join=not args.noJoin, pubsub=pubsub,
                           device=args.device)
        broker = FileBroker(args.brokerDir
                            or os.path.join(args.workdir, "broker"))
        with broker.multi_reader(cfg.kafka_topic) as reader:
            while True:
                lines = reader.poll(max_records=8192)
                if not lines:
                    break
                app.process_lines(lines)
                app.flush()

    report = app.close()
    print(report, file=sys.stderr, flush=True)
    print(json.dumps({
        "events": app.events, "invalid": app.invalid_tuples,
        "dropped": app.dropped, "stored_rows": len(app.store.index),
    }), flush=True)
    if pubsub is not None:
        pubsub.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
