#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``streambench_tpu_torch``).

Drives the port's main path on one CUDA card and fails (non-zero exit, no
result line) when any phase fails:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: the CUDA kernel library (``nvcc``) and the native host library
   (``g++``), both from the sources in this checkout, in parallel.
3. Kernels: the count kernel K1 (``csrc/count_cells.cu``) against its
   plain PyTorch version and a numpy count on the card, exact equality, at
   the main path's shapes and others (``CASES``: Zipf-skewed campaigns and
   ~30 % masked rows, a hot cell, views misaligned by 1 and 3 rows,
   config #5's step on its 256 MB plane, and a 16.7M-row bandwidth
   case), each with the launch plan it took; device
   times from CUDA events over CUDA-graph replays and eager call times,
   beside the byte bound at 3.35 TB/s, one ``index_add_`` call as a
   library yardstick, the launch floor (an empty kernel), and the share
   of a warp's rounds of atomics in which two rows hit one cell.
4. End to end: BASELINE config #1 (``conf/benchmarkConf.yaml`` with the
   in-process Redis store): generate the catchup journal (10,000,000
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

K1's launches are counted over each of phases 4, 6 and 7, from 0 just
before the phase's run to just after it.  The line before the nvidia-smi
line is ``{"kernels": [...]}``; the last line is ``{"ok": true, "device":
{...}}``.

    python3 chip_smoke.py [--events N] [--out FILE]
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
SYNC_CHECKED_DRAINS = 8            # config #5 drains under sync-debug
LARGE_EVENTS = 1_000_000           # config #5's dataset, bench.py:1227-1230
# bench.py's config #5 row (1238-1247): 1e6 campaigns x 1 ad, W = 64, no
# scan groups, the stock 8192-event batch
CONFIG5 = {"jax.window.slots": 64, "jax.scan.batches": 1,
           "jax.batch.size": 8192, "jax.num.campaigns": 1_000_000,
           "jax.ads.per.campaign": 1}
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
    ("hot cell: every unmasked row on one cell", 4096, 100, 16, "hot"),
    ("misaligned views, 1 row in", 4096, 100, 16, "offset1"),
    ("misaligned views, 3 rows in", 4096, 100, 16, "offset3"),
    ("bandwidth (not a main-path shape): 16.7M rows, 151 MB of input",
     16_777_216, 100, 16, "zipf"),
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

    ptxas = []
    for log in sorted(os.listdir(BUILD_DIR)):
        if log.startswith("libcount_cells") and log.endswith(".log"):
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
    elif kind == "config5":
        camp = rng.integers(0, C, n, dtype=np.int32)
        t0 = int(rng.integers(0, 10_000_000))
        slot = ((t0 + 10 * np.arange(n)) // 10_000 % W).astype(np.int32)
        return camp, slot, rng.random(n) < 1 / 3, offset
    else:
        camp = ((rng.zipf(1.2, n) - 1) % C).astype(np.int32)
        slot = rng.integers(0, W, n, dtype=np.int32)
    mask = rng.random(n) >= 0.3
    return camp, slot, mask, offset


def empty_launch() -> None:
    """One empty kernel on the current stream (the launch floor)."""
    import torch

    from streambench_tpu_torch.ops import _build

    rc = _build.count_cells_lib().sb_empty_launch(
        torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()))
    if rc:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")


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
        # bytes the function must move for THIS data: each input row read
        # once (4 + 4 + 1 B), each counts cell it touches read and written
        rows += c.size
        nbytes += c.size * 9 + n_touched * 8
        touched += n_touched
        masked += int((~m).sum())
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


def _generate(workdir: str, cfg, events: int, seed: int, **setup):
    """The generator's dataset (ids, map, broker topic, oracle journal) in
    ``workdir``, and an in-process store seeded with the campaigns."""
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
        return result, plane, steps
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_large_key_space(events: int) -> dict:
    """BASELINE config #5's key space on one card (see the module doc)."""
    import torch

    from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
    from streambench_tpu_torch.ops.count import count_cells

    workdir = _workdir("smoke_config5")
    try:
        cfg = _config(workdir, CONFIG5)
        broker, mapping, campaigns, r, gen_s = _generate(
            workdir, cfg, events, 7, num_campaigns=1_000_000,
            ads_per_campaign=1)
        print(f"[config5] generated {events} events over 1e6 campaigns "
              f"in {gen_s:.2f} s", flush=True)
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
            "generate_s": gen_s, "stages": engine.tracer.as_dict(),
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
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--events", type=int, default=10_000_000,
                    help="catchup events for the end-to-end phase")
    ap.add_argument("--out", help="also write every phase's result to "
                    "this JSON file")
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

    import numpy as np

    smi = phase_device()
    ptxas = phase_build()
    cases, floor = phase_kernels()
    e2e, (C, W), steps = phase_end_to_end(args.events)
    large = phase_large_key_space(LARGE_EVENTS)
    xo = phase_exactly_once_resume(LARGE_EVENTS)
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
            "exactly_once_resume": xo["count_cells_launches"]},
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
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"kernels": kernels,
                       "end_to_end": e2e, "large_key_space": large,
                       "exactly_once_resume": xo, "nvidia_smi": smi,
                       "ptxas": ptxas}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
