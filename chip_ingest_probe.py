#!/usr/bin/env python3
"""Where the stock catchup's host time goes with and without the staged
ingest pipeline and the encode pool, on one card.

A diagnostic beside ``chip_smoke.py``, whose journal and configuration
helpers it uses; the smoke's phases hold the oracle, this script only
times.  It needs a CUDA card and the port's libraries (built at first
use).

One generated stock journal (``--events``, seed 42, as in the smoke's
phase 4) goes through ``StreamRunner.run_catchup`` on ``cuda`` in each
arm below, every arm twice, the rounds in turns (A B C D E, then E D C B
A), each through a fresh engine and in-process store:

- ``serial``: pipeline off, one encoder (the smoke's phase 4);
- ``pool``: pipeline off, four encode workers;
- ``pipeline``: pipeline on, one encoder;
- ``pipeline+pool``: pipeline on, four encode workers (phase 8);
- ``pipeline+pool, switch 0.5 ms``: the same under
  ``sys.setswitchinterval(0.0005)`` (Python's default is 5 ms: how long a
  thread that wants the GIL waits for one that holds it).

Per run: ev/s of ``run_catchup``, the process's CPU seconds over the run
(``time.process_time``), the engine's stage spans, K1's launches and,
when the pipeline is on, its telemetry.  One JSON line per run and a
summary line of medians; ``--out FILE`` keeps them together.

    python3 chip_ingest_probe.py [--events N] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import time

from chip_smoke import _config, _generate, _workdir

ARMS = (
    ("serial", {"jax.ingest.pipeline": "off", "jax.encode.workers": 1},
     None),
    ("pool", {"jax.ingest.pipeline": "off", "jax.encode.workers": 4}, None),
    ("pipeline", {"jax.ingest.pipeline": "on", "jax.encode.workers": 1},
     None),
    ("pipeline+pool", {"jax.ingest.pipeline": "on",
                       "jax.encode.workers": 4}, None),
    ("pipeline+pool, switch 0.5 ms", {"jax.ingest.pipeline": "on",
                                      "jax.encode.workers": 4}, 0.0005),
)


def run_arm(workdir, keys, switch, broker, mapping, campaigns) -> dict:
    import torch

    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.redis_schema import as_redis, seed_campaigns
    from streambench_tpu_torch.ops.count import count_cells

    cfg = _config(workdir, keys)
    r = as_redis(make_store())
    seed_campaigns(r, campaigns)
    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns, redis=r,
                               device="cuda")
    reader = broker.reader(cfg.kafka_topic)
    runner = StreamRunner(engine, reader)
    old_switch = sys.getswitchinterval()
    if switch is not None:
        sys.setswitchinterval(switch)
    try:
        count_cells.launches = 0
        cpu0, t0 = time.process_time(), time.perf_counter()
        stats = runner.run_catchup()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        cpu_s = time.process_time() - cpu0
        launches = count_cells.launches
    finally:
        sys.setswitchinterval(old_switch)
    engine.close()
    reader.close()
    pipe = runner._pipeline
    return {"events": stats.events, "run_catchup_s": run_s,
            "events_per_s": stats.events / run_s, "cpu_s": cpu_s,
            "count_cells_launches": launches,
            "pipeline": pipe.telemetry() if pipe is not None else None,
            "stages": engine.tracer.as_dict()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--events", type=int, default=10_000_000)
    ap.add_argument("--out", help="also write every line to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_ingest_probe: needs a CUDA card", file=sys.stderr)
        return 1
    workdir = _workdir("ingest_probe")
    lines = []
    try:
        cfg = _config(workdir)
        broker, mapping, campaigns, _, gen_s = _generate(
            workdir, cfg, args.events, 42,
            num_campaigns=cfg.jax_num_campaigns,
            ads_per_campaign=cfg.jax_ads_per_campaign)
        print(json.dumps({"generated": args.events, "generate_s": gen_s}),
              flush=True)
        order = list(ARMS) + list(reversed(ARMS))
        runs: dict = {name: [] for name, _, _ in ARMS}
        for name, keys, switch in order:
            out = run_arm(workdir, keys, switch, broker, mapping, campaigns)
            if out["events"] != args.events:
                raise AssertionError(f"{name}: folded {out['events']} of "
                                     f"{args.events}")
            runs[name].append(out)
            line = {"arm": name, **out}
            lines.append(line)
            print(json.dumps(line), flush=True)
        summary = {name: {
            "events_per_s": statistics.median(r["events_per_s"] for r in rs),
            "cpu_s": statistics.median(r["cpu_s"] for r in rs),
            "encode_ms": statistics.median(
                r["stages"]["encode"]["total_ms"] for r in rs),
            "device_step_ms": statistics.median(
                r["stages"].get("device_step", {}).get("total_ms", 0.0)
                for r in rs)}
            for name, rs in runs.items()}
        lines.append({"summary": summary})
        print(json.dumps({"summary": summary}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
