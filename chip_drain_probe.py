#!/usr/bin/env python3
"""Where the host time of the port's config #5 drains goes, on one card.

A diagnostic beside ``chip_smoke.py``, whose journal and configuration
helpers it uses; the smoke's config #5 phase stays uninstrumented and
holds the oracle, this script only times.  It needs a CUDA card and the
port's libraries (built at first use).

1. Pinned buffers: host ms of 8 fresh 1 MB ``pin_memory=True``
   allocations kept alive (each a ``cudaHostAlloc`` of PyTorch's host
   caching allocator), then 8 more after freeing them (its cache).
2. Drains by part: config #5's journal (``LARGE_EVENTS``, seed 7, as in
   the smoke) through ``StreamRunner.run_catchup``, with every drain
   timed whole and by part: the row upload (``_rows_on_device``), the
   compaction's dispatch (``flush_deltas_rows_compact``), inside it
   ``_nonzero_capped``, and ``_park``.
3. Host ops: the first 300,000 events again through a fresh engine, each
   drain under the host-side ``torch.profiler``: its wall time and the
   aten ops with the most self host time.

Each part prints one JSON line; ``--out FILE`` keeps them together.

    python3 chip_drain_probe.py [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import time

from chip_smoke import CONFIG5, LARGE_EVENTS, _config, _generate, _workdir

PROFILED_EVENTS = 300_000


class _timed(list):
    """Host ms of every call of ``owner.name`` from now on: the attribute
    is replaced by a timing wrapper of ``fn``, the function it held."""

    def __init__(self, owner, name: str):
        super().__init__()
        self.fn = fn = getattr(owner, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.append((time.perf_counter() - t0) * 1e3)

        setattr(owner, name, timed)


def pinned_alloc_ms(n: int = 8, nbytes: int = 1 << 20) -> dict:
    """Part 1 (see the module doc)."""
    import torch

    def alloc() -> tuple[list, list]:
        kept, ms = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            kept.append(torch.empty(nbytes // 4, dtype=torch.int32,
                                    pin_memory=True))
            ms.append((time.perf_counter() - t0) * 1e3)
        return kept, ms

    kept, fresh = alloc()
    del kept
    _, cached = alloc()
    return {"bytes": nbytes, "fresh_ms_median": statistics.median(fresh),
            "cached_ms_median": statistics.median(cached),
            "fresh_ms": fresh, "cached_ms": cached}


def drains_by_part(cfg, mapping, campaigns, broker, r) -> dict:
    """Part 2 (see the module doc)."""
    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.ops import windowcount

    warm = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                             device="cuda")
    warm.warmup()
    warm.close()
    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns, redis=r,
                               device="cuda")
    drain = _timed(engine, "_drain_device")
    park = _timed(engine, "_park")
    upload = _timed(engine, "_rows_on_device")
    compact = _timed(windowcount, "flush_deltas_rows_compact")
    nonzero = _timed(windowcount, "_nonzero_capped")
    try:
        with broker.reader(cfg.kafka_topic) as reader:
            StreamRunner(engine, reader).run_catchup()
    finally:
        windowcount.flush_deltas_rows_compact = compact.fn
        windowcount._nonzero_capped = nonzero.fn
    engine.close()
    return {"drains": dict(engine.drain_stats), "drain_host_ms": drain,
            "rows_upload_host_ms": upload,
            "rows_compact_dispatch_host_ms": compact,
            "nonzero_capped_host_ms": nonzero, "park_host_ms": park}


def drain_host_ops(cfg, mapping, campaigns, broker) -> dict:
    """Part 3 (see the module doc).  The profiler is started once
    beforehand, so its first-use cost stays out."""
    from torch.profiler import ProfilerActivity, profile

    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner

    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                               device="cuda")
    drain = engine._drain_device
    ops: dict = {}
    wall_ms: list[float] = []

    def drain_profiled():
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            drain()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        for e in prof.key_averages():
            ops[e.key] = ops.get(e.key, 0.0) + e.self_cpu_time_total / 1e3

    with profile(activities=[ProfilerActivity.CPU]):
        pass
    engine._drain_device = drain_profiled
    with broker.reader(cfg.kafka_topic) as reader:
        StreamRunner(engine, reader).run_catchup(max_events=PROFILED_EVENTS)
    engine.close()
    return {"drains": dict(engine.drain_stats), "profiled_wall_ms": wall_ms,
            "top_self_host_ms": dict(sorted(ops.items(),
                                            key=lambda kv: -kv[1])[:12])}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every part to this JSON file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_drain_probe: needs a CUDA card", file=sys.stderr)
        return 1
    out = {"pinned_alloc": pinned_alloc_ms()}
    print(f"[pinned] {json.dumps(out['pinned_alloc'])}", flush=True)
    workdir = _workdir("drain_probe")
    try:
        cfg = _config(workdir, CONFIG5)
        broker, mapping, campaigns, r, _ = _generate(
            workdir, cfg, LARGE_EVENTS, 7, num_campaigns=1_000_000,
            ads_per_campaign=1)
        out["by_part"] = drains_by_part(cfg, mapping, campaigns, broker, r)
        print(f"[by_part] {json.dumps(out['by_part'])}", flush=True)
        out["host_ops"] = drain_host_ops(cfg, mapping, campaigns, broker)
        print(f"[host_ops] {json.dumps(out['host_ops'])}", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
