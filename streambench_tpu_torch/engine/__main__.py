"""Engine process CLI for the PyTorch port.

Loads the config, builds the engine ``--engine`` names on the requested
device (``--device``, default ``cuda``): ``exact`` (default), the exact
count of BASELINE config #1; ``hll``, HLL distinct users per window
(config #2); ``sliding``, sliding-window counts with t-digest latency
quantiles (config #3); ``session``, session windows of per-user clicks
feeding a count-min sketch whose top-k heavy hitters go to
``<hashtable>_hh`` at close (config #4; ``jax.cms.mode``,
``jax.cms.cell.bits`` and ``jax.cms.stages`` pick the sketch); ``reach``,
cumulative MinHash ∪ HLL reach sketches per campaign, served live: a
pub/sub endpoint answers the ``reach`` query verb through the bounded,
load-shedding ``reach.serve.ReachQueryServer`` (``jax.reach.queue.depth``,
the result cache ``jax.reach.cache.capacity``, the objective
``jax.reach.slo.p99.ms``), ``jax.reach.ship.dir`` ships the planes to
read replicas (``python -m streambench_tpu_torch.reach.replica``) every
``jax.reach.ship.interval.ms``, as dirty-row deltas with
``jax.reach.ship.delta``, and ``<hashtable>_reach`` gets the estimates
at close; ``hllx``, the hyper-extended HLL ladder per campaign: distinct
users, soft-capped counts and the log-count moment from one register
plane, written to ``<hashtable>_hllx`` at close.  It tails the broker
topic, flushes the canonical Redis window schema, and at the end
(catchup drained, duration, idle timeout, or SIGTERM, after folding what
the topic holds) closes the engine and prints the same JSON stats
line as ``python -m streambench_tpu.engine``.  ``--sharded`` runs the
engine on the ``(data, campaign)`` mesh of ``jax.mesh.shape`` (one rank
a device, below: NCCL on the card, gloo on the CPU):
``parallel.ShardedWindowEngine`` for
``exact``, as ``bench.py`` runs BASELINE #5, and the sharded sketch
engines of ``parallel.sketches`` for ``hll``, ``sliding`` and
``session``, and ``parallel.reach.ShardedReachEngine`` for ``reach``,
whose queries are evaluated next to the shards (``--sharded --engine
hllx`` is an error, as in the reference).  Any key space the config
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
profiles the whole run.  With ``--engine reach``, ``jax.obs.query``
decomposes every query into queue/batch/dispatch/reply segments
(``obs serve``), and ``jax.obs.fleet`` turns the role-stamped
(``writer``) journal on for the fleet view (``obs fleet``); the shipped
records always carry the writer's origin and freshness stamps.

    python -m streambench_tpu_torch.engine --confPath conf/benchmarkConf.yaml \
        --workdir RUN_DIR --catchup \
        [--engine exact|hll|sliding|session|reach|hllx] \
        [--device cuda|cpu] [--checkpointDir D] [--sharded | --microbatch]

``jax.obs.shard`` with ``--sharded`` adds the per-shard skew
(``shard_skew`` in the stats line and the sampler's records) of the
exact and HLL engines.

``--microbatch`` runs the fork's count-based window mode instead
(``engine.microbatch``: ``map.partitions`` mapper threads, each folding
``window.size / map.partitions`` events a window through the count
kernel, aligned at a window barrier; ``--engine hll`` folds HLL
registers; ``--checkpointDir`` takes incremental window snapshots), dumps
the fork's latency hash and prints the reference's stats line
(``engine``, ``windows``, ``events``, ``partitions``, ``total_views``,
``p50_latency_ms``).

``--tenants "name:kind,..."`` (or the key ``jax.tenants``) runs the
multi-tenant host instead of one engine (``engine.tenants``): every
tenant tails the shared topic with its own engine on ``--device``, its
own ``tenant=`` metric namespace, its own sink and, with ``jax.slo.*``
or ``jax.reach.slo.p99.ms``, its own objective; the device-time ledger
attributes sampled busy windows per tenant and the blame matrix
intersects each tenant's waits with the others' busy windows.
``jax.admission.enabled`` (with ``jax.admission.breach.ticks``,
``.healthy.ticks``, ``.escalate.ticks``, ``.cooldown.s``) arms the
admission controller that defers, then sheds, an aggressor's ingest.
It prints ``tenants up: ...`` and, at the end, one stats line with
``"engine": "multitenant"``.

``--sharded`` runs one rank a device, as many as the product of
``jax.mesh.shape`` asks for (JAX's CLI takes as many devices): the
process the user started is rank 0 and starts ranks 1..N-1 as child
processes of this module with the same arguments
(``STREAMBENCH_NUM_PROCESSES``, ``STREAMBENCH_PROCESS_ID`` and
``STREAMBENCH_COORDINATOR`` set for them, on a free localhost port); a
process that finds those variables set takes its rank from them and
starts nothing (an outside launcher's form).  Rank k folds on
``cuda:k``, or with ``--device cpu`` on the CPU over gloo.  Rank 0 runs
the path above; the other ranks build the same sharded engine, open no
store and no broker, run what rank 0 sends them (``follow``) and exit 0
when rank 0 closes its engine; their output goes to
``<workdir>/engine.rank<k>.log``.  ``engine up:`` comes once every rank
has warmed up, and the stats line adds each other rank's exit code
(``followers``).  A rank that dies ends the run non-zero: rank 0 exits
1 when another rank exits before its close, and the others die with
rank 0.  Refused with exit 2: more ranks on ``cuda`` than the host has
cards, a mesh whose rank count is not an outside
``STREAMBENCH_NUM_PROCESSES``, and ``--sharded --engine hllx``.
``STREAMBENCH_MESH_TIMEOUT_S`` sets the groups' timeout (default 300 s).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist

from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import ConfigError, find_and_read_config_file
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.dimensions.pubsub import PubSubServer
from streambench_tpu_torch.dimensions.store import DurableDimensionStore
from streambench_tpu_torch.engine.microbatch import run_microbatch
from streambench_tpu_torch.engine.pipeline import AdAnalyticsEngine
from streambench_tpu_torch.engine.runner import StreamRunner
from streambench_tpu_torch.engine.sketches import (
    HLLDistinctEngine,
    HLLXEngine,
    ReachSketchEngine,
    SessionCMSEngine,
    SlidingTDigestEngine,
)
from streambench_tpu_torch.engine.tenants import run_tenants_cli
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
    QueryLifecycle,
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
from streambench_tpu_torch.parallel import (
    ShardedHLLEngine,
    ShardedReachEngine,
    ShardedSessionCMSEngine,
    ShardedSlidingTDigestEngine,
    ShardedWindowEngine,
    mesh_from_config,
)
from streambench_tpu_torch.parallel.mesh import (
    CAMPAIGN_AXIS,
    DATA_AXIS,
    DEFAULT_TIMEOUT_S,
    check_cards,
)
from streambench_tpu_torch.reach.cache import ReachQueryCache
from streambench_tpu_torch.reach.deltaship import (
    DELTA_AUTO_MIN_CAMPAIGNS,
    DeltaShipper,
)
from streambench_tpu_torch.reach.replica import SnapshotShipper
from streambench_tpu_torch.reach.serve import ReachQueryServer
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
                   choices=("exact", "hll", "sliding", "session",
                            "reach", "hllx"),
                   help="aggregation engine: exact window counts "
                        "(default), hll (HLL distinct users), sliding "
                        "(sliding-window counts + t-digest latency "
                        "quantiles), session (session windows + "
                        "count-min heavy hitters): BASELINE configs "
                        "#1-#4; reach (MinHash + HLL reach sketches "
                        "served over pub/sub); or hllx (the "
                        "hyper-extended HLL ladder: distinct counts and "
                        "frequency moments from one register plane)")
    p.add_argument("--sharded", action="store_true",
                   help="run the engine sharded over the mesh of "
                        "jax.mesh.shape (exact, hll, sliding, session or "
                        "reach), one rank a device: NCCL on cuda (rank k "
                        "on cuda:k), gloo on cpu")
    p.add_argument("--microbatch", action="store_true",
                   help="run the fork's count-based barrier-aligned window "
                        "mode (window.size / map.partitions) over the "
                        "broker topic, then exit (exact or hll)")
    p.add_argument("--tenants", default=None,
                   help="run the multi-tenant host instead of one engine: "
                        "\"name:kind,...\" (kinds: exact/hll/sliding/"
                        "session/reach/hllx).  Every tenant tails the "
                        "shared topic with its own engine + tenant= "
                        "metric namespace; overrides jax.tenants")
    return p


#: engines the port runs, by ``--engine`` name
ENGINES = {"exact": AdAnalyticsEngine, "hll": HLLDistinctEngine,
           "sliding": SlidingTDigestEngine, "session": SessionCMSEngine,
           "reach": ReachSketchEngine, "hllx": HLLXEngine}
#: their mesh-sharded forms (``--sharded``)
SHARDED_ENGINES = {"exact": ShardedWindowEngine, "hll": ShardedHLLEngine,
                   "sliding": ShardedSlidingTDigestEngine,
                   "session": ShardedSessionCMSEngine,
                   "reach": ShardedReachEngine}


def mesh_ranks(cfg) -> int:
    """The ranks ``jax.mesh.shape`` asks for: the product of its axes, as
    JAX's mesh takes that many devices."""
    return math.prod(cfg.jax_mesh_shape)


def rank_refusal(args, cfg) -> str | None:
    """Why ``--sharded`` cannot start its ranks, or None: a mesh whose
    rank count is not an outside launcher's ``STREAMBENCH_NUM_PROCESSES``,
    or more ranks on ``cuda`` than the host has cards (two ranks on one
    card fail inside NCCL)."""
    if not args.sharded:
        return None
    n = mesh_ranks(cfg)
    outside = os.environ.get("STREAMBENCH_NUM_PROCESSES")
    if outside is not None and int(outside) != n:
        return (f"jax.mesh.shape {list(cfg.jax_mesh_shape)} needs {n} "
                f"ranks; STREAMBENCH_NUM_PROCESSES={outside}")
    dev = torch.device(args.device)
    if n == 1 or dev.type != "cuda":
        return None
    if dev.index is not None:
        return (f"--sharded over {n} ranks puts rank k on cuda:k; it "
                f"takes --device cuda, not {dev}")
    try:
        check_cards(n)
    except ValueError as e:
        return f"--sharded over {n} ranks: {e}"
    return None


def _mesh_timeout_s() -> float:
    return float(os.environ.get("STREAMBENCH_MESH_TIMEOUT_S",
                                DEFAULT_TIMEOUT_S))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _last_json(path: str) -> dict:
    """The last line of ``path`` that is a JSON object, or {}."""
    try:
        with open(path) as f:
            lines = f.read().strip().splitlines()
    except OSError:
        return {}
    for ln in reversed(lines):
        try:
            out = json.loads(ln)
        except ValueError:
            continue
        if isinstance(out, dict):
            return out
    return {}


class _Followers:
    """Ranks 1..N-1 of ``--sharded``, started by rank 0 as child
    processes of this module with its arguments; their output goes to
    ``<workdir>/engine.rank<k>.log``.  Until ``closed()`` a rank that
    exits ends rank 0 with exit 1 (a watcher thread)."""

    def __init__(self, argv: list[str], n: int, workdir: str):
        os.environ.update(STREAMBENCH_NUM_PROCESSES=str(n),
                          STREAMBENCH_PROCESS_ID="0",
                          STREAMBENCH_COORDINATOR=f"127.0.0.1:{_free_port()}")
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, STREAMBENCH_LEADER_PID=str(os.getpid()),
                   PYTHONPATH=os.pathsep.join(
                       p for p in (root, os.environ.get("PYTHONPATH")) if p))
        self.logs = [os.path.join(workdir, f"engine.rank{k}.log")
                     for k in range(1, n)]
        self.procs = []
        for k, path in enumerate(self.logs, 1):
            with open(path, "wb") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "streambench_tpu_torch.engine",
                     *argv], env=dict(env, STREAMBENCH_PROCESS_ID=str(k)),
                    stdout=log, stderr=subprocess.STDOUT))
        self._closed = False
        threading.Thread(target=self._watch, daemon=True,
                         name="followers").start()

    def _watch(self) -> None:
        while not self._closed:
            if self.report_lost() and not self._closed:
                os._exit(1)
            time.sleep(0.2)

    def report_lost(self, wait_s: float = 0.0) -> bool:
        """Whether a rank has exited, waiting up to ``wait_s`` for one to:
        if so, name it on stderr and kill the others."""
        deadline = time.monotonic() + wait_s
        while True:
            for k, proc in enumerate(self.procs, 1):
                rc = proc.poll()
                if rc is not None:
                    print(f"error: rank {k} exited with code {rc} before "
                          f"rank 0 closed its engine; see "
                          f"{self.logs[k - 1]}", file=sys.stderr,
                          flush=True)
                    for p in self.procs:
                        p.kill()
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def closed(self) -> None:
        """Rank 0 has closed its engine: the other ranks may now exit."""
        self._closed = True

    def wait(self, timeout_s: float = 60.0) -> list[dict]:
        """Each rank's exit code and its own stats line's kernel
        launches, once it has exited (killed after ``timeout_s``)."""
        out = []
        deadline = time.monotonic() + timeout_s
        for k, proc in enumerate(self.procs, 1):
            try:
                rc = proc.wait(max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            out.append({"rank": k, "exit_code": rc,
                        "kernel_launches": _last_json(
                            self.logs[k - 1]).get("kernel_launches")})
        return out


def _exit_with(leader_pid: int) -> None:
    """Die with the rank 0 that started this process: the kernel sends
    SIGKILL when the parent dies (``PR_SET_PDEATHSIG``), and a parent
    gone already ends this process now."""
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != leader_pid:
        os._exit(1)


def _launches() -> dict:
    return {"count_cells": count_cells.launches,
            "decode_rows": decode_rows.launches,
            "cms_rows": cmsrows.kernel_launches()}


def _reset_launches() -> None:
    count_cells.launches = 0
    decode_rows.launches = 0
    cmsrows.reset_launches()


def _follow(args, cfg) -> int:
    """A rank other than 0: build the sharded engine and its warm-up twin
    as rank 0 does, run what rank 0 sends each, and print this rank's
    launches once rank 0 has closed its engine.  It opens no store and
    no broker; SIGTERM and SIGINT are rank 0's to act on."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    leader = os.environ.get("STREAMBENCH_LEADER_PID")
    if leader:
        _exit_with(int(leader))
    mapping, campaigns = load_mapping(cfg, args.workdir)
    mesh = mesh_from_config(cfg, device=args.device,
                            timeout_s=_mesh_timeout_s())

    def make_engine():
        return SHARDED_ENGINES[args.engine](
            cfg, mapping, mesh, campaigns=campaigns, device=args.device)

    engine = make_engine()
    warm = make_engine()
    warm.follow()
    del warm
    _reset_launches()
    engine.follow()
    dist.barrier(group=mesh.host_group)
    dist.destroy_process_group()
    print(json.dumps({"rank": mesh.rank,
                      "kernel_launches": _launches()}), flush=True)
    return 0


class _ReachServing:
    """The reach engine's serving side in the CLI: one pub/sub endpoint
    (WebSocket and JSON lines on one port) whose ``reach`` verb goes
    through the bounded, load-shedding query server, the result cache,
    and, with ``jax.reach.ship.dir``, the replica shipper into
    ``<dir>/dimensions.log``."""

    def __init__(self, pubsub, server, store, shipper):
        self.pubsub = pubsub
        self.server = server
        self.store = store
        self.shipper = shipper

    def close(self, engine) -> dict:
        """Drain and stop the server, ship the close-time planes (the
        replicas converge on them), and return the stats line's
        ``reach`` block."""
        self.server.close()
        out = self.server.summary()
        self.pubsub.close()
        if self.shipper is not None:
            planes = engine.planes()
            self.shipper.note_state(
                planes["mins"], planes["registers"], engine.reach_epoch,
                int(engine.state.watermark), force=True,
                folded_ms=engine._fold_wall_ms)
            out["ship"] = self.shipper.summary()
            self.store.close()
        return out


def _start_reach(cfg, engine, registry, spans, flightrec, sampler,
                 query_obs=None) -> _ReachServing:
    """Build and attach ``--engine reach``'s serving side (its first
    push runs the query once, before ``engine up:``) and print the
    ``reach:`` line."""
    cache = (ReachQueryCache(cfg.jax_reach_cache_capacity,
                             registry=registry)
             if cfg.jax_reach_cache_capacity > 0 else None)
    pubsub = PubSubServer(port=0).start()
    server = ReachQueryServer(
        list(engine.encoder.campaigns), depth=cfg.jax_reach_queue_depth,
        registry=registry, queryattr=query_obs, spans=spans,
        flightrec=flightrec, cache=cache)
    pubsub.register_query("reach", server.handle)
    engine.attach_reach(server)
    store = shipper = None
    if cfg.jax_reach_ship_dir:
        store = DurableDimensionStore(cfg.jax_reach_ship_dir)
        host, port = pubsub.address
        # dirty-row deltas between periodic bases: "auto" where the
        # full gather hurts (large campaign counts)
        mode = cfg.jax_reach_ship_delta
        use_delta = (mode == "on"
                     or (mode == "auto" and engine.encoder.num_campaigns
                         >= DELTA_AUTO_MIN_CAMPAIGNS))
        shipper = (DeltaShipper if use_delta else SnapshotShipper)(
            store, list(engine.encoder.campaigns),
            interval_ms=cfg.jax_reach_ship_interval_ms, registry=registry,
            origin={"addr": f"{host}:{port}", "pid": os.getpid(),
                    "role": "writer"})
        engine.attach_shipper(shipper)
    if sampler is not None:
        # every metrics.jsonl record carries the serving picture under
        # "reach_query" (segments and contention with jax.obs.query on)
        # and the writer's per-tick ship cost under "ship" — the blocks
        # `obs serve` and `obs fleet` render
        def collect(rec, dt_s, srv=server, sh=shipper):
            rec["reach_query"] = srv.summary()
            if sh is not None:
                rec["ship"] = sh.summary()

        sampler.add_collector(collect)
    host, port = pubsub.address
    extra = " query_obs=on" if query_obs is not None else ""
    extra += (f" cache={cfg.jax_reach_cache_capacity}"
              if cache is not None else "")
    if shipper is not None:
        extra += (f" ship={cfg.jax_reach_ship_dir}"
                  f"@{cfg.jax_reach_ship_interval_ms}ms/{shipper.mode}")
    print(f"reach: pubsub={host}:{port} "
          f"queue_depth={cfg.jax_reach_queue_depth} k={engine.k} "
          f"registers={engine.registers}{extra}", flush=True)
    return _ReachServing(pubsub, server, store, shipper)


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


def _redis(cfg):
    """The store the config names: the in-process one for
    ``:inprocess:``, else a RESP client."""
    if cfg.redis_host == ":inprocess:":
        return as_redis(make_store())
    return RespClient(cfg.redis_host, cfg.redis_port)


def _run_microbatch(args, cfg) -> int:
    """``--microbatch``: the fork's count windows over the broker topic
    (``engine.microbatch.run_microbatch``, ``map.partitions`` mapper
    threads folding on ``--device``), the fork's latency hash in the
    store, and the reference's stats line."""
    if args.engine in ("sliding", "session", "reach", "hllx"):
        raise SystemExit(
            f"--microbatch has no count-window form of --engine "
            f"{args.engine} (sliding needs a time axis, session a gap "
            f"axis, reach/hllx are cumulative); supported: exact, hll")
    mapping, campaigns = load_mapping(cfg, args.workdir)
    broker = make_broker(cfg.kafka_bootstrap_servers,
                         args.brokerDir
                         or os.path.join(args.workdir, "broker"),
                         fake=cfg.kafka_fake)
    merged, results = run_microbatch(
        cfg, broker, mapping, campaigns=campaigns, redis=_redis(cfg),
        engine=args.engine, checkpoint_dir=args.checkpointDir,
        device=args.device)
    lats = sorted(lat for r in results for lat in r.latency.values())
    print(json.dumps({
        "engine": args.engine,
        "windows": len(merged),
        "events": sum(r.events for r in results),
        "partitions": len(results),
        "total_views": int(sum(int(c.sum()) for c in merged.values())),
        "p50_latency_ms": lats[len(lats) // 2] if lats else None,
    }), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    try:
        cfg = find_and_read_config_file(args.confPath)
    except ConfigError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # multi-tenant host: N topologies, one process, one device — it
    # owns the whole run (engines, sinks, obs wiring), as in the
    # reference, ahead of every single-engine check
    if args.tenants or cfg.jax_tenants:
        mapping, campaigns = load_mapping(cfg, args.workdir)
        return run_tenants_cli(cfg, args, mapping, campaigns)
    refusal = rank_refusal(args, cfg)
    if refusal:
        print(f"error: {refusal}", file=sys.stderr)
        return 2
    if args.microbatch:
        return _run_microbatch(args, cfg)
    if args.sharded and args.engine not in SHARDED_ENGINES:
        # the reference's own refusal: hllx has no sharded form
        print(f"error: --sharded supports exact/hll/sliding/session/reach, "
              f"not --engine {args.engine}", file=sys.stderr)
        return 2
    followers = None
    if args.sharded and mesh_ranks(cfg) > 1:
        if "STREAMBENCH_NUM_PROCESSES" not in os.environ:
            followers = _Followers(argv, mesh_ranks(cfg), args.workdir)
        elif int(os.environ.get("STREAMBENCH_PROCESS_ID", "0")) != 0:
            return _follow(args, cfg)
    try:
        return _run_engine(args, cfg, followers)
    except Exception as e:
        # a collective that met a dead rank: name the rank
        if followers is not None and followers.report_lost(wait_s=2.0):
            print(f"error: {type(e).__name__}: {e}", file=sys.stderr,
                  flush=True)
            return 1
        raise


def _run_engine(args, cfg, followers: _Followers | None) -> int:
    """The engine's run: rank 0's with ``--sharded`` over ranks, else the
    whole run."""
    mapping, campaigns = load_mapping(cfg, args.workdir)
    redis = _redis(cfg)
    engine_cls = ENGINES[args.engine]
    mesh = None
    if args.sharded:
        # one rank a device: NCCL on the card, gloo on the CPU
        try:
            mesh = mesh_from_config(cfg, device=args.device,
                                    timeout_s=_mesh_timeout_s())
        except ValueError as e:
            print(f"error: --sharded: {e}", file=sys.stderr)
            return 2
    ranks = mesh.size if mesh is not None else 1

    def make_engine(r):
        if mesh is not None:
            return SHARDED_ENGINES[args.engine](
                cfg, mapping, mesh, campaigns=campaigns, redis=r,
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
    # The handlers only set flags: the flight dump and the capture
    # trigger take locks the host loop may hold when a signal lands, so
    # they run on the host loop (the dump once the run has stopped, the
    # capture at the next flush tick).
    signals = {"sigterm": False, "sigusr2": False}

    def _on_sigterm(*_):
        signals["sigterm"] = True
        # fold what the topic already holds before the final stats line:
        # the harness stops the load first, and its evidence is events
        # emitted == events folded
        runner.stop(drain=True)

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
    if ranks > 1:
        # from here on the other ranks follow this engine: keep them
        # waiting while this rank sets up and whenever it idles
        engine.keepalive()
    # after the warm-up, which the other ranks follow on its own engine
    if runner.resume():
        print(f"resumed from checkpoint: offset={runner._reader_position()} "
              f"events={engine.events_processed}", flush=True)

    # Live telemetry (obs/, default-off): jax.metrics.interval.ms > 0
    # starts the sampler journaling snapshots to <workdir>/metrics.jsonl;
    # jax.metrics.port >= 0 serves the localhost Prometheus endpoint
    # (0 = ephemeral, the chosen port is printed below).
    sampler = metrics_server = occupancy = slo = registry = None
    xfer = devmem = capture = shard = query_obs = None
    slo_wanted = (cfg.jax_slo_p99_ms > 0 or cfg.jax_slo_rate_evps > 0
                  or (args.engine == "reach"
                      and cfg.jax_reach_slo_p99_ms > 0))
    shard_wanted = cfg.jax_obs_shard and mesh is not None
    query_obs_wanted = args.engine == "reach" and cfg.jax_obs_query
    flush_hooks = []
    if (cfg.jax_metrics_interval_ms > 0 or cfg.jax_metrics_port >= 0
            or cfg.jax_obs_lifecycle or cfg.jax_obs_spans
            or cfg.jax_obs_occupancy or slo_wanted
            or cfg.jax_obs_xfer or cfg.jax_obs_devmem
            or cfg.jax_obs_capture or shard_wanted
            or query_obs_wanted or cfg.jax_obs_fleet):
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
        # jax.obs.query: per-query lifecycle attribution for the reach
        # serving tier (the query-side WindowLifecycle).  Built here so
        # the SLO tracker below can attach segment attribution to breach
        # events; the ReachQueryServer gets it in _start_reach.  With
        # spans also on, the queue-wait/ingest-dispatch overlap feeds
        # streambench_reach_contention_ratio.
        if query_obs_wanted:
            query_obs = QueryLifecycle(
                registry, slo_ms=cfg.jax_reach_slo_p99_ms,
                slowlog_max=cfg.jax_obs_query_slowlog,
                sample_every=cfg.jax_obs_query_sample, spans=spans)
            if occupancy is not None:
                # the contention numerator's production evidence: the
                # occupancy sampler's measured busy windows (async
                # ingest dispatch spans cover only the submit call)
                occupancy.busy_sink = query_obs.note_ingest_busy
        metrics_path = os.path.join(args.workdir, "metrics.jsonl")
        # fleet attribution: the engine CLI is the fleet's single
        # writer; role-stamping its journal lets the FleetCollector
        # merge it with replica journals unambiguously
        sampler = MetricsSampler(
            metrics_path,
            interval_ms=cfg.jax_metrics_interval_ms or 1000,
            registry=registry,
            max_bytes=cfg.jax_metrics_max_bytes,
            role="writer")
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
                reach_p99_ms=(cfg.jax_reach_slo_p99_ms
                              if args.engine == "reach" else 0),
                budget=cfg.jax_slo_budget, fast_s=cfg.jax_slo_fast_s,
                slow_s=cfg.jax_slo_slow_s,
                use_lifecycle=cfg.jax_obs_lifecycle,
                annotate=sampler.annotate, flightrec=flightrec,
                capture=capture, queryattr=query_obs)
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
    reach = (_start_reach(cfg, engine, registry, spans, flightrec, sampler,
                          query_obs)
             if args.engine == "reach" else None)
    # everything is built now (the reach query ran once at the first
    # push); a build from here on is a mid-run stall
    if occupancy is not None:
        occupancy.mark_steady()
    # the kernels' launches over the run itself (warmup's excluded); CPU
    # folds take the plain versions and launch nothing
    _reset_launches()
    if ranks > 1:
        # the ready marker means the whole mesh is ready
        engine.sync()

    print(f"engine up: engine={args.engine} topic={cfg.kafka_topic} "
          f"redis={cfg.redis_host}:"
          f"{cfg.redis_port} batch={engine.batch_size} "
          f"device={engine.device} method={engine.method} "
          f"pipeline={'on' if runner._pipeline_on() else 'off'} "
          f"decode={'device' if engine._devdecode is not None else 'host'} "
          f"encode_workers={cfg.jax_encode_workers}"
          + (f" mesh={mesh.shape[DATA_AXIS]}x{mesh.shape[CAMPAIGN_AXIS]} "
             f"backend={mesh.backend} ranks={ranks}"
             if mesh is not None else ""),
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
    left = None
    if ranks > 1:
        if followers is not None:
            followers.closed()
        try:
            # every rank has stopped following: now they may leave
            dist.barrier(group=mesh.host_group)
        except RuntimeError as e:
            print(f"error: the other ranks did not close: {e}",
                  file=sys.stderr, flush=True)
        if followers is not None:
            left = followers.wait()
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
        "kernel_launches": _launches(),
    }
    if left is not None:
        # a run that lost a rank must not look clean
        stats_line["followers"] = left
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
    if reach is not None:
        # close (and drain) the query server BEFORE the SLO verdict: the
        # answers of the drain at close land in the histogram it judges
        stats_line["reach"] = reach.close(engine)
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
    lost = any(f["exit_code"] != 0 for f in left or ())
    return 1 if close_err is not None or lost else 0


if __name__ == "__main__":
    sys.exit(main())
