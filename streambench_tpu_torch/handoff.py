"""Host<->device columnar handoff benchmark (the fork's r2c/c2r experiment).

The port of ``streambench_tpu/handoff.py``.  The reference fork measured
the cost of a windowed row->column transpose into a page-aligned mmap'd
shared file and the column->row read-back — the shape of a
host->accelerator batch handoff (``WindowedArrowFormatBolter``,
``AdvertisingTopologyNative.java:278-356``) — and persisted three
per-window latencies to Redis hashes ``<table>_window`` / ``<table>_r2c``
/ ``<table>_c2r`` keyed by window start (``LatencyRecordBolter``,
``:358-385``).

Measured here, per window of ``batch_size`` events:

- ``window``: queueing delay — receive time minus window start (same as
  the reference's ``receive_time - start_time``).
- ``r2c``  : row->column *and* host->device — parse/int-encode the raw
  JSON rows into dense int32 columns (the encoder is the transpose), copy
  the six columns to the run's device and synchronise it.
- ``c2r``  : column->row read-back — the device columns copied back to
  host numpy and reassembled into row tuples, like the reference's
  column->row loop.

Same Redis schema as the reference, so the same tooling can read both.

    python -m streambench_tpu_torch.handoff [--confPath C] [--windows N]
        [--batchSize B] [--inprocessRedis] [--device cuda|cpu]
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from streambench_tpu_torch.io.redis_schema import RedisLike
from streambench_tpu_torch.utils.device import resolve_device
from streambench_tpu_torch.utils.ids import now_ms


@dataclass
class HandoffSample:
    window_start_ms: int
    window_ms: int   # receive - window_start (queueing)
    r2c_ms: float    # rows -> int32 columns -> device memory (synchronised)
    c2r_ms: float    # device columns -> host rows


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_handoff(encoder, lines_per_window: list[list[bytes]],
                window_starts_ms: list[int] | None = None,
                rows_back: int = 64,
                device: torch.device | str | None = None
                ) -> list[HandoffSample]:
    """Measure the handoff for each pre-built window of raw event lines,
    on ``device`` (``cuda`` unless the caller asks for ``cpu``)."""
    dev = resolve_device(device)
    samples: list[HandoffSample] = []
    for i, lines in enumerate(lines_per_window):
        start = (window_starts_ms[i] if window_starts_ms is not None
                 else now_ms())
        receive = now_ms()

        t0 = time.perf_counter_ns()
        batch = encoder.encode(lines, len(lines))
        cols = [torch.from_numpy(c).to(dev) for c in
                (batch.ad_idx, batch.event_type, batch.event_time,
                 batch.user_idx, batch.page_idx, batch.ad_type)]
        _sync(dev)
        t1 = time.perf_counter_ns()

        host = [c.cpu().numpy() for c in cols]
        n = min(rows_back, batch.n)
        rows = [tuple(col[j] for col in host) for j in range(n)]
        assert len(rows) == n
        t2 = time.perf_counter_ns()

        samples.append(HandoffSample(
            window_start_ms=start,
            window_ms=receive - start,
            r2c_ms=(t1 - t0) / 1e6,
            c2r_ms=(t2 - t1) / 1e6,
        ))
    return samples


def dump_handoff(r: RedisLike, table: str,
                 samples: list[HandoffSample]) -> None:
    """Persist per-window latencies in the reference's three-hash schema
    (``LatencyRecordBolter``: HSET ``<table>_window/_r2c/_c2r``)."""
    cmds = []
    for s in samples:
        key = str(s.window_start_ms)
        cmds.append(("HSET", f"{table}_window", key, str(s.window_ms)))
        cmds.append(("HSET", f"{table}_r2c", key, f"{s.r2c_ms:.3f}"))
        cmds.append(("HSET", f"{table}_c2r", key, f"{s.c2r_ms:.3f}"))
    r.pipeline_execute(cmds)


def read_handoff(r: RedisLike, table: str) -> dict[int, tuple[int, float, float]]:
    """window_start -> (window_ms, r2c_ms, c2r_ms)."""
    window = r.hgetall(f"{table}_window")
    r2c = r.hgetall(f"{table}_r2c")
    c2r = r.hgetall(f"{table}_c2r")
    return {int(k): (int(v), float(r2c.get(k, "nan")), float(c2r.get(k, "nan")))
            for k, v in window.items()}


def _main(argv: list[str] | None = None) -> int:
    """CLI: synthesize windows, run the handoff bench, dump to Redis,
    print a JSON summary line (the reference's keys)."""
    import argparse
    import json
    import random
    import sys

    p = argparse.ArgumentParser(prog="streambench-torch-handoff")
    p.add_argument("--confPath", default="./benchmarkConf.yaml")
    p.add_argument("--windows", type=int, default=20)
    p.add_argument("--batchSize", type=int, default=5000)
    p.add_argument("--table", default=None,
                   help="Redis hash prefix (default <redis.hashtable>_handoff)")
    p.add_argument("--inprocessRedis", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device the columns go to: cuda (default) "
                        "or cpu")
    args = p.parse_args(argv)

    from streambench_tpu_torch.config import (ConfigError,
                                              load_config_or_default)
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.encode.native_encoder import make_encoder
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.redis_schema import as_redis
    from streambench_tpu_torch.io.resp import RespClient

    try:
        cfg = load_config_or_default(
            args.confPath,
            is_default_path=args.confPath == p.get_default("confPath"))
    except ConfigError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    table = args.table or f"{cfg.redis_hashtable}_handoff"
    rng = random.Random(1234)
    campaigns = gen.make_ids(cfg.jax_num_campaigns, rng)
    ads = gen.make_ids(cfg.jax_num_campaigns * cfg.jax_ads_per_campaign, rng)
    mapping = {a: campaigns[i % len(campaigns)] for i, a in enumerate(ads)}
    src = gen.EventSource(ads=ads, user_ids=gen.make_ids(100, rng),
                          page_ids=gen.make_ids(100, rng), rng=rng)
    base = now_ms()
    windows, starts = [], []
    for w in range(args.windows):
        ts = [base + w * cfg.jax_time_divisor_ms + i
              for i in range(args.batchSize)]
        windows.append([e.encode() for e in src.events_at(ts)])
        starts.append(base + w * cfg.jax_time_divisor_ms)
    encoder = make_encoder(mapping, campaigns,
                           divisor_ms=cfg.jax_time_divisor_ms,
                           lateness_ms=cfg.jax_allowed_lateness_ms)

    samples = run_handoff(encoder, windows, starts, device=device)
    if len(samples) > 1:
        samples = samples[1:]  # drop the first (warm-up) window
    if not samples:
        print(json.dumps({"windows": 0, "batch_size": args.batchSize,
                          "table": table}), flush=True)
        return 0

    if args.inprocessRedis:
        r = as_redis(make_store())
    else:
        r = RespClient(cfg.redis_host, cfg.redis_port)
    dump_handoff(r, table, samples)

    r2c = sorted(s.r2c_ms for s in samples)
    c2r = sorted(s.c2r_ms for s in samples)
    mid = len(samples) // 2
    print(json.dumps({
        "windows": len(samples), "batch_size": args.batchSize,
        "r2c_ms_p50": round(r2c[mid], 3), "r2c_ms_max": round(r2c[-1], 3),
        "c2r_ms_p50": round(c2r[mid], 3), "c2r_ms_max": round(c2r[-1], 3),
        "events_per_s_r2c": round(args.batchSize / (r2c[mid] / 1e3), 1),
        "table": table,
    }), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main())
