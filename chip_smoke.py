#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``streambench_tpu_torch``).

Drives the port's main path on one CUDA card and fails (non-zero exit, no
result line) when any phase fails:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: the CUDA kernel library (``nvcc``) and the native host library
   (``g++``), both from the sources in this checkout, in parallel.
3. Kernels: the count kernel (``csrc/count_cells.cu``) against its plain
   PyTorch version on the card, exact equality, at the main path's shapes
   and a few others, with Zipf-skewed campaigns and ~30 % masked rows;
   device times from CUDA events over CUDA-graph replays, beside the byte
   bound at 3.35 TB/s and one ``index_add_`` call as a library yardstick.
4. End to end: BASELINE config #1 (``conf/benchmarkConf.yaml`` with the
   in-process Redis store): generate the catchup journal (10,000,000
   events by default), run ``AdAnalyticsEngine(device="cuda")`` under
   ``StreamRunner.run_catchup``, and require the generator's oracle
   (``gen.check_correct``) to find every window exact and the count
   kernel to have launched during the run; then replay the first
   1,000,000 events under ``torch.profiler`` for the device busy share.

The line before the nvidia-smi line is ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--events N]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PROFILE_EVENTS = 1_000_000         # events replayed under torch.profiler
REPO = os.path.dirname(os.path.abspath(__file__))
CASES = (
    # (label, B, C, W)
    ("main path: one step of the stock catchup (8192-row batch halved by "
     "the span guard)", 4096, 100, 16),
    ("one full micro-batch", 8192, 100, 16),
    ("one full scan group", 65536, 100, 16),
    ("ragged, non-power-of-two", 300, 7, 5),
    ("BASELINE #5 key space (global-memory path)", 8192, 1_000_000, 16),
)


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


def phase_build() -> None:
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
               (("cuda kernels (nvcc)", _build.count_cells_lib),
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

    for log in sorted(os.listdir(BUILD_DIR)):
        if log.startswith("libcount_cells") and log.endswith(".log"):
            with open(os.path.join(BUILD_DIR, log)) as f:
                for line in f.read().splitlines():
                    if "ptxas info" in line and "Used" in line:
                        print(f"[build] {line.strip()}", flush=True)


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


def phase_kernels() -> list[dict]:
    import numpy as np
    import torch

    from streambench_tpu_torch.ops.count import count_cells, count_cells_plain

    rng = np.random.default_rng(1234)
    out = []
    for label, B, C, W in CASES:
        # Zipf-skewed campaigns (rank 1 hottest), uniform slots, ~30 %
        # of rows masked out
        camp_np = ((rng.zipf(1.2, B) - 1) % C).astype(np.int32)
        slot_np = rng.integers(0, W, B, dtype=np.int32)
        mask_np = rng.random(B) >= 0.3
        base_np = rng.integers(0, 50, (C, W), dtype=np.int32)
        camp = torch.from_numpy(camp_np).cuda()
        slot = torch.from_numpy(slot_np).cuda()
        mask = torch.from_numpy(mask_np).cuda()
        base = torch.from_numpy(base_np).cuda()

        got = base.clone()
        count_cells(got, camp, slot, mask)
        want = base.clone()
        count_cells_plain(want, camp, slot, mask)
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max().item())
        expect = base_np.copy().reshape(-1)
        np.add.at(expect, (camp_np.astype(np.int64) * W + slot_np)[mask_np],
                  1)
        host_diff = int(np.abs(got.cpu().numpy().reshape(-1).astype(np.int64)
                               - expect).max())

        scratch = base.clone()
        kernel_ms = _device_ms(lambda: count_cells(scratch, camp, slot, mask))
        kernel_call_ms = _call_ms(
            lambda: count_cells(scratch, camp, slot, mask))
        plain_ms = _device_ms(
            lambda: count_cells_plain(scratch, camp, slot, mask))
        flat = torch.where(mask, camp.long() * W + slot.long(), C * W)
        padded = torch.zeros(C * W + 1, dtype=torch.int32, device="cuda")
        ones = torch.ones(B, dtype=torch.int32, device="cuda")
        library_ms = _device_ms(lambda: padded.index_add_(0, flat, ones))

        # bytes the function must move for THIS data: each input row read
        # once (4 + 4 + 1 B), each counts cell it touches read and written
        touched = int(np.unique((camp_np.astype(np.int64) * W
                                 + slot_np)[mask_np]).size)
        nbytes = B * 9 + touched * 8
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out.append({
            "case": label, "shape": {"B": B, "C": C, "W": W},
            "masked_rows": int((~mask_np).sum()), "touched_cells": touched,
            "max_abs_diff": max(diff, host_diff),
            "kernel_ms": kernel_ms, "kernel_call_ms": kernel_call_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_bytes": nbytes,
        })
        print(f"[kernels] {json.dumps(out[-1])}", flush=True)
        if diff or host_diff:
            raise AssertionError(f"count_cells disagrees with its plain "
                                 f"version at B={B} C={C} W={W}: "
                                 f"max |diff| {max(diff, host_diff)}")
    return out


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


def phase_end_to_end(events: int) -> dict:
    import torch
    import yaml

    from streambench_tpu_torch.config import find_and_read_config_file
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.io.fakeredis import make_store
    from streambench_tpu_torch.io.journal import FileBroker
    from streambench_tpu_torch.io.redis_schema import as_redis
    from streambench_tpu_torch.ops.count import count_cells

    workdir = os.path.join(REPO, "build", "smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        with open(os.path.join(REPO, "conf", "benchmarkConf.yaml")) as f:
            conf = yaml.safe_load(f)
        conf["redis.host"] = ":inprocess:"
        conf_path = os.path.join(workdir, "benchmarkConf.yaml")
        with open(conf_path, "w") as f:
            yaml.safe_dump(conf, f)
        cfg = find_and_read_config_file(conf_path)

        r = as_redis(make_store())
        broker = FileBroker(os.path.join(workdir, "broker"))
        t0 = time.perf_counter()
        gen.do_setup(r, cfg, broker=broker, events_num=events,
                     num_campaigns=cfg.jax_num_campaigns,
                     ads_per_campaign=cfg.jax_ads_per_campaign,
                     rng=random.Random(42), workdir=workdir)
        gen_s = time.perf_counter() - t0
        print(f"[e2e] generated {events} events in {gen_s:.2f} s",
              flush=True)
        mapping = gen.load_ad_mapping_file(
            os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE))
        campaigns = gen.load_ids(workdir)[0]

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

        logs: list[str] = []
        t0 = time.perf_counter()
        correct, differ, missing = gen.check_correct(
            r, workdir, cfg.jax_time_divisor_ms, log=logs.append)
        check_s = time.perf_counter() - t0
        result = {
            "events": stats.events, "batches": stats.batches,
            "flushes": stats.flushes,
            "windows_written": stats.windows_written,
            "dropped": engine.dropped,
            "run_catchup_s": run_s, "catchup_with_close_s": total_s,
            "events_per_s": stats.events / run_s,
            "events_per_s_with_close": stats.events / total_s,
            "windows_checked": correct + differ + missing,
            "correct": correct, "differ": differ, "missing": missing,
            "count_cells_launches": launches,
            "generate_s": gen_s, "check_correct_s": check_s,
            "stages": engine.tracer.as_dict(),
        }
        print(f"[e2e] {json.dumps(result)}", flush=True)
        if stats.events != events:
            raise AssertionError(f"folded {stats.events} of {events}")
        if differ or missing:
            raise AssertionError(f"oracle: differ={differ} "
                                 f"missing={missing}: {logs[:5]}")
        if engine.dropped:
            raise AssertionError(f"{engine.dropped} events dropped")
        if launches <= 0:
            raise AssertionError("the count kernel never launched on the "
                                 "main path")
        result["profile"] = _profile_catchup(
            cfg, mapping, campaigns, broker, min(events, PROFILE_EVENTS),
            run_s / max(stats.events, 1))
        print(f"[profile] {json.dumps(result['profile'])}", flush=True)
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--events", type=int, default=10_000_000,
                    help="catchup events for the end-to-end phase")
    args = ap.parse_args(argv)

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

    smi = phase_device()
    phase_build()
    cases = phase_kernels()
    e2e = phase_end_to_end(args.events)

    main_case = cases[0]
    kernels = [{
        "name": "count_cells",
        "route": "cuda",
        "source": "streambench_tpu_torch/csrc/count_cells.cu",
        "replaces": "streambench_tpu/ops/pallas_count.py:51",
        "launches": e2e["count_cells_launches"],
        "shape": main_case["shape"],
        "max_abs_err": max(c["max_abs_diff"] for c in cases),
        "max_abs_diff": max(c["max_abs_diff"] for c in cases),
        "ms": main_case["kernel_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_case["library_ms"],
        "cases": cases,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
