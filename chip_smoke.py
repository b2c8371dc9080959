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

8. Pipelined catchup: phase 4's journal again, with
   ``jax.ingest.pipeline: on`` and ``jax.encode.workers: 4``, through
   ``StreamRunner.run_catchup`` (read, encode and fold on three threads,
   the encode on a pool of four native encoders); every window must equal
   phase 4's oracle-checked rows, compared in full.  Its ev/s beside phase
   4's, the stage spans, the pipeline's telemetry and the host's cores.
9. Paced YSB through the port's harness, as users run it: ``python -m
   streambench_tpu_torch.harness TORCH_TEST`` in a fresh workdir (a RESP
   server process, the engine process on ``cuda`` with the pipeline on
   and four encode workers, the generator at 100,000 ev/s for 60 s over
   the file journal, ``-g`` stats, ``VERIFY=1``).  The engine must exit
   0 having folded exactly the events the generator emitted, none
   dropped, with every window in Redis equal to the oracle over the
   journal; the window latency (``updated.txt``) as p50/p90/p99/max.
10. Fake Kafka: the same composite with ``KAFKA_FAKE=1`` (the broker its
   own process, one partition), 10,000 ev/s for 30 s.
11. Observability: phase 9's composite at 100,000 ev/s for 30 s with every
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

K1's launches are counted over each of phases 4 and 6-11, from 0 just
before the phase's run to just after it (phases 9-11 run the engine in
its own process, which reports them in its stats line).  The line
before the nvidia-smi line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--events N] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import socket
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
# phases 9 and 10: (rate ev/s, seconds) of the paced load
PACED_LOAD = (100_000, 60)
KAFKA_LOAD = (10_000, 30)
# phase 11: the paced load and the harness's obs knobs
OBS_LOAD = (100_000, 30)
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
        pipelined = phase_pipelined_catchup(workdir, broker, mapping,
                                            campaigns, r, result)
        return result, plane, steps, pipelined
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _store_windows(r) -> dict:
    """``(campaign, window_ts) -> seen_count`` of every window in a store:
    one HGETALL per campaign, one HGET per window."""
    out = {}
    for campaign in r.execute("SMEMBERS", "campaigns"):
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
               STOP_STATS_GRACE="5", VERIFY="1")
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
    e2e, (C, W), steps, pipelined = phase_end_to_end(args.events)
    large = phase_large_key_space(LARGE_EVENTS)
    xo = phase_exactly_once_resume(LARGE_EVENTS)
    paced = phase_paced("paced", PACED_LOAD)
    kafka = phase_paced("kafka", KAFKA_LOAD, KAFKA_FAKE="1",
                        KAFKA_BROKERS=f"127.0.0.1:{_free_port()}")
    obs = phase_paced("obs", OBS_LOAD, check=check_obs, **OBS_ENV)
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
            "exactly_once_resume": xo["count_cells_launches"],
            "pipelined_catchup": pipelined["count_cells_launches"],
            "paced_ysb": paced["count_cells_launches"],
            "fake_kafka": kafka["count_cells_launches"],
            "paced_ysb_obs": obs["count_cells_launches"]},
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
                       "exactly_once_resume": xo,
                       "pipelined_catchup": pipelined, "paced_ysb": paced,
                       "fake_kafka": kafka, "paced_ysb_obs": obs,
                       "nvidia_smi": smi,
                       "ptxas": ptxas}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
