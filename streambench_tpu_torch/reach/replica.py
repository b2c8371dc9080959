"""Snapshot-shipped reach read replicas.

The port of ``streambench_tpu/reach/replica.py``.  The shipper and the
tailer are the reference's, pure numpy over the same wire format, so a
log either package's shipper wrote tails into either package's replica.
A replica loads each record's planes into tensors on its device
(``--device``, ``cuda`` by default) and answers through the port's
``ReachQueryServer``.  The fleet mode (``--fleet``) estimates the clock
offset to the writer (``obs/clock.py``) and stamps each load once its
planes are on the device, so every reply carries the freshness hops.

The reach-forecasting paper (PAPERS.md, arXiv 2502.14785) serves
audience-overlap queries at ad-platform scale by exploiting what the
sketch planes give: they are TINY (a [C, k] uint32 +
[C, R] int32 pair is a few hundred KB at production settings) and
``merge`` is commutative/associative/idempotent — so a reader answering
against a shipped point-in-time copy is sound by construction, and N
stateless readers scale query throughput without the single writer
ever taking a read lock.

Wire format: the base64 plane record
(``DurableDimensionStore.put_reach_sketches``), one JSON line per ship
carrying ``(epoch, mins, registers, watermark, campaigns, t)``.  The
WRITER side (:class:`SnapshotShipper`) appends one at a bounded cadence
(``jax.reach.ship.interval.ms``) — an epoch bump ships immediately, so
replicas learn about a restore within one poll.  The REPLICA side
(:class:`ReachReplica`) tails the log, loads the newest record into
device planes, and serves the existing pub/sub ``reach`` query verb
through a :class:`~streambench_tpu_torch.reach.serve.ReachQueryServer` with:

- every reply stamped ``plane_epoch`` + ``staleness_ms`` (now minus the
  record's shipped stamp — bounded by cadence + poll when healthy, and
  *detectable by the client* when not);
- a hard staleness bound (``jax.reach.staleness.max.ms``): planes older
  than the bound — including "no epoch loaded yet" — SHED rather than
  answer, so a wedged shipper degrades loudly instead of serving
  arbitrarily old evidence;
- the (epoch, campaign-set) result cache wired in, invalidated
  wholesale on every epoch the tailer loads.

Run one per process::

    python -m streambench_tpu_torch.reach.replica --ship <dir>/dimensions.log \
        --port 0 [--device cuda|cpu] [--max-staleness-ms 10000] \
        [--cache 4096]

The process prints ``replica: pubsub=<host>:<port>`` once serving
(harness/CI parse it) and one JSON stats line at exit.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time

import numpy as np

from streambench_tpu_torch.utils.ids import now_ms

#: the shipped record kind (DurableDimensionStore.put_reach_sketches)
SHIP_KIND = "reach_sketch"

#: default hard staleness bound for replicas (ms): generous next to the
#: default 1 s shipping cadence, tight next to a wedged shipper
DEFAULT_MAX_STALENESS_MS = 10_000


def decode_ship_record(rec: dict) -> dict | None:
    """One parsed ship line -> planes dict, or None when torn/corrupt
    (the store's replay rule: keep the previous good record)."""
    if rec.get("kind") != SHIP_KIND:
        return None
    try:
        c = list(rec["c"])
        k, r = int(rec["k"]), int(rec["r"])
        mins = np.frombuffer(base64.b64decode(rec["mins"]),
                             np.uint32).reshape(len(c), k)
        regs = np.frombuffer(base64.b64decode(rec["regs"]),
                             np.int32).reshape(len(c), r)
    except (KeyError, ValueError, TypeError):
        return None
    return {"mins": mins, "registers": regs, "campaigns": c,
            "epoch": int(rec.get("epoch", 0)),
            "watermark": int(rec.get("wm", 0)),
            "shipped_ms": int(rec.get("t", 0)),
            # fleet freshness stamps + writer origin;
            # None on pre-fleet records
            "folded_ms": rec.get("fm"),
            "submit_ms": rec.get("sm"),
            "origin": rec.get("origin")}


class SnapshotShipper:
    """Writer-side cadence gate: serialize the current planes through
    ``DurableDimensionStore.put_reach_sketches`` at most once per
    ``interval_ms`` — except an epoch bump, which ships immediately
    (replicas must learn about a restore within one poll, not one
    cadence).  Attached via ``ReachSketchEngine.attach_shipper``; the
    engine calls :meth:`note_state` from its flush-cadence push path,
    so the writer is never blocked by readers — shipping is one host
    gather + one appended line, and only at the cadence.

    This is the FULL-plane path — O(C) gather + bytes per tick.  The
    O(ΔC) dirty-row path is :class:`~streambench_tpu_torch.reach.
    deltaship.DeltaShipper`, a drop-in subclass selected by
    ``jax.reach.ship.delta``."""

    #: engines enable host-side dirty-row tracking for shippers that
    #: declare this (deltaship.DeltaShipper overrides to True)
    wants_dirty = False
    mode = "full"

    def __init__(self, store, campaigns: list[str],
                 interval_ms: int = 1000, registry=None,
                 origin: dict | None = None):
        self.store = store
        self.campaigns = list(campaigns)
        self.interval_ms = max(int(interval_ms), 1)
        self.ships = 0
        self._last_ship = 0.0      # monotonic
        self._last_epoch: int | None = None
        # per-tick ship cost evidence: what the gather +
        # encode actually cost, per record and cumulative — the obs
        # surface the delta path is judged against
        self.bytes_last = 0
        self.rows_last = 0
        self.ship_ms_last = 0.0
        self.bytes_total = 0
        self.rows_total = 0
        self.ship_ms_total = 0.0
        # fleet origin metadata: the writer's pub/sub
        # endpoint + pid, stamped into every shipped record so a
        # replica can (a) ping it for the clock-offset estimate and
        # (b) attribute the record in the merged fleet view
        self.origin = dict(origin) if origin else None
        self._g_ships = None
        self._g_bytes = self._g_rows = self._g_ms = None
        if registry is not None:
            self._g_ships = registry.counter(
                "streambench_reach_ship_total",
                "reach snapshot records shipped to the replica log")
            self._g_bytes = registry.gauge(
                "streambench_ship_bytes_per_tick",
                "encoded bytes of the last shipped record")
            self._g_rows = registry.gauge(
                "streambench_ship_rows_per_tick",
                "plane rows carried by the last shipped record")
            self._g_ms = registry.gauge(
                "streambench_ship_ms_per_tick",
                "wall ms of the last ship (gather + encode + append)")

    def due(self, epoch: int) -> bool:
        """Would a ship happen now?  (The engine checks this BEFORE
        pulling the watermark scalar off device — no sync on the
        not-yet-due flushes between cadence ticks.)"""
        return (self._last_epoch != int(epoch)
                or (time.monotonic() - self._last_ship) * 1000.0
                >= self.interval_ms)

    def note_state(self, mins, registers, epoch: int,
                   watermark: int = 0, force: bool = False,
                   folded_ms: int | None = None,
                   dirty_rows=None) -> bool:
        """Maybe ship; returns True when a record was written.
        ``force`` bypasses the cadence — the writer's close-time ship
        AND the restart-path ship (engine restore / shipper re-attach
        after a supervised crash): replicas must converge on the live
        planes immediately, not at the next cadence tick.

        ``folded_ms``: wall stamp of the last fold into these planes
        (the engine's ``_fold_wall_ms``) — the fold-anchored end of the
        freshness ledger; the ship-submit stamp is taken here.

        ``dirty_rows``: the rows touched since the last
        ship.  Ignored here — the full-plane path always ships all of
        C; the DeltaShipper subclass is the consumer."""
        now = time.monotonic()
        epoch = int(epoch)
        if (not force and self._last_epoch == epoch
                and (now - self._last_ship) * 1000.0 < self.interval_ms):
            return False
        t0 = time.perf_counter()
        submit_ms = now_ms()
        mins = np.asarray(mins)
        nbytes = self.store.put_reach_sketches(
            mins, np.asarray(registers), self.campaigns,
            epoch, watermark=int(watermark),
            folded_ms=(int(folded_ms) if folded_ms is not None
                       else submit_ms),
            submit_ms=submit_ms, origin=self.origin)
        self._mark_shipped(now, epoch, int(nbytes or 0),
                           int(mins.shape[0]),
                           (time.perf_counter() - t0) * 1e3)
        return True

    def _mark_shipped(self, now: float, epoch: int, nbytes: int,
                      rows_n: int, ship_ms: float) -> None:
        """One record hit the log: advance the cadence gate and the
        per-tick cost evidence (counters + gauges)."""
        self._last_ship = now
        self._last_epoch = epoch
        self.ships += 1
        self.bytes_last, self.rows_last = nbytes, rows_n
        self.ship_ms_last = ship_ms
        self.bytes_total += nbytes
        self.rows_total += rows_n
        self.ship_ms_total += ship_ms
        if self._g_ships is not None:
            self._g_ships.inc()
        if self._g_bytes is not None:
            self._g_bytes.set(nbytes)
            self._g_rows.set(rows_n)
            self._g_ms.set(ship_ms)

    def summary(self) -> dict:
        return {"ships": self.ships, "interval_ms": self.interval_ms,
                "epoch": self._last_epoch, "mode": self.mode,
                "bytes_per_tick": self.bytes_last,
                "rows_per_tick": self.rows_last,
                "ship_ms_per_tick": round(self.ship_ms_last, 3),
                "bytes_total": self.bytes_total,
                "rows_total": self.rows_total,
                "ship_ms_total": round(self.ship_ms_total, 3)}


class ShipLogTailer:
    """Incremental reader of the ship log: each ``poll`` consumes newly
    appended complete lines and returns the NEWEST decodable reach
    record among them (a replica only ever wants the latest planes; a
    torn tail line stays buffered until its newline lands)."""

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._carry = b""
        self.records_seen = 0

    def poll(self) -> dict | None:
        try:
            with open(self.path, "rb") as f:
                f.seek(self._pos)
                data = f.read()
        except FileNotFoundError:
            return None
        if not data:
            return None
        self._pos += len(data)
        data = self._carry + data
        nl = data.rfind(b"\n") + 1
        self._carry = data[nl:]
        newest = None
        for line in data[:nl].splitlines():
            line = line.strip()
            if not line or b'"reach_sketch"' not in line:
                continue
            try:
                rec = decode_ship_record(json.loads(line))
            except json.JSONDecodeError:
                continue
            if rec is not None:
                newest = rec
                self.records_seen += 1
        return newest


class ReachReplica:
    """One stateless read replica: ship-log tailer -> local epoch-
    stamped planes on ``device`` -> pub/sub ``reach`` verb.

    The pub/sub endpoint starts serving IMMEDIATELY; until the first
    record loads, every query is shed with ``reason: "stale"`` (the
    not-yet-loaded-an-epoch case of the staleness bound) — a replica
    never blocks clients on its own bootstrap.
    """

    def __init__(self, ship_path: str, *, host: str = "127.0.0.1",
                 port: int = 0, poll_ms: int = 200,
                 max_staleness_ms: int = DEFAULT_MAX_STALENESS_MS,
                 cache_capacity: int = 4096, depth: int = 512,
                 batch: int = 64, registry=None, queryattr=None,
                 fleet: bool = False, spans=None, flightrec=None,
                 device=None):
        from streambench_tpu_torch.dimensions.pubsub import PubSubServer
        from streambench_tpu_torch.obs import MetricsRegistry
        from streambench_tpu_torch.utils.device import resolve_device

        # lazy: deltaship imports this module (SnapshotShipper)
        from streambench_tpu_torch.reach.deltaship import ChainTailer

        self.device = resolve_device(device)
        self.ship_path = ship_path
        self.poll_ms = max(int(poll_ms), 1)
        self.max_staleness_ms = int(max_staleness_ms)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        # delta-aware chain tailer: folds dirty-row delta records between
        # bases, resyncs from the newest base on any gap/damage; over a
        # base-only (full-ship) log it behaves exactly like the legacy
        # ShipLogTailer
        self._tailer = ChainTailer(ship_path)
        self._queryattr = queryattr
        # fleet freshness: pass the shipped records' stamp chain through
        # to the server (replies then carry the hop decomposition) and
        # estimate the clock offset to the writer's pub/sub origin so
        # cross-host stamp deltas are honest
        self.fleet = bool(fleet)
        self._spans = spans
        self._flightrec = flightrec
        self.clock: dict | None = None        # last offset estimate
        self._clock_origin: str | None = None  # addr it was made against
        self._depth = depth
        self._batch = batch
        self._cache_capacity = int(cache_capacity)
        self.server = None            # built at first record (campaigns)
        self.cache = None
        self.epoch_loads = 0
        self.plane_loads = 0
        self.shed_before_load = 0
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.pubsub = PubSubServer(host=host, port=port)
        self.pubsub.register_query("reach", self._handle)
        self._poller = threading.Thread(target=self._poll_loop,
                                        daemon=True,
                                        name="reach-replica-poll")

    # -- serving -------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        return self.pubsub.address

    def _handle(self, msg: dict, reply) -> None:
        srv = self.server
        if srv is None:
            # no epoch loaded yet: shed, never block on bootstrap
            self.shed_before_load += 1
            reply({"shed": True, "reason": "stale", "plane_epoch": None,
                   "id": msg.get("id")})
            return
        srv.handle(msg, reply)

    # -- clock-domain correction (fleet mode) --------------------------
    def _sync_clock(self, origin: dict | None) -> None:
        """One midpoint-method offset estimate against the writer's
        pub/sub origin, refreshed when the origin address changes.  A
        failed sync (writer gone, port closed) records ``applied:
        False`` — raw stamps are then used as-is, never corrected by a
        guess."""
        addr = (origin or {}).get("addr")
        if not addr or addr == self._clock_origin:
            return
        from streambench_tpu_torch.obs import clock as obs_clock

        self._clock_origin = addr
        try:
            host, port = addr.rsplit(":", 1)
            self.clock = obs_clock.sync_pubsub(host, int(port), n=8,
                                               timeout_s=2.0)
        except (OSError, ValueError) as e:
            self.clock = {"offset_ms": 0.0, "applied": False,
                          "error": repr(e), "endpoint": addr}

    def _freshness(self, rec: dict, loaded_ms: int) -> dict | None:
        """The stamp dict a fleet-mode state push carries: writer-clock
        stamps mapped into this replica's clock (when the offset
        estimate passed the jitter gate) + the local load stamp."""
        if not self.fleet:
            return None
        from streambench_tpu_torch.obs import clock as obs_clock

        def local(stamp):
            return (None if stamp is None
                    else obs_clock.to_local_ms(stamp, self.clock))

        out = {"folded_ms": local(rec.get("folded_ms")),
               "submit_ms": local(rec.get("submit_ms")),
               "shipped_ms": local(rec.get("shipped_ms")),
               "loaded_ms": int(loaded_ms)}
        if self.clock is not None:
            out["clock"] = dict(self.clock)
        return out

    # -- plane loading -------------------------------------------------
    def _load(self, rec: dict) -> None:
        import torch

        from streambench_tpu_torch.ops.minhash import mins_tensor
        from streambench_tpu_torch.reach.cache import ReachQueryCache
        from streambench_tpu_torch.reach.serve import ReachQueryServer

        if self.fleet:
            # outside the lock: a slow/failed ping must not stall the
            # admission path's server lookup
            self._sync_clock(rec.get("origin"))
        with self._lock:
            if self.server is None:
                self.cache = (ReachQueryCache(self._cache_capacity,
                                              registry=self.registry)
                              if self._cache_capacity > 0 else None)
                self.server = ReachQueryServer(
                    rec["campaigns"], depth=self._depth,
                    batch=self._batch, registry=self.registry,
                    cache=self.cache,
                    max_staleness_ms=self.max_staleness_ms,
                    queryattr=self._queryattr, spans=self._spans,
                    flightrec=self._flightrec)
            prev = self.server.epoch
            # new tensors (copies): the chain tailer owns and mutates
            # its folded plane arrays across polls — the served planes
            # must never alias them
            mins = mins_tensor(rec["mins"], self.device)
            regs = torch.from_numpy(
                np.array(rec["registers"], np.int32)).to(self.device)
            if self.device.type == "cuda":
                # the load stamp means "these planes can answer": taken
                # once the copies have landed on the card
                torch.cuda.current_stream(self.device).synchronize()
            self.server.update_state(
                mins, regs, rec["epoch"], shipped_ms=rec["shipped_ms"],
                freshness=self._freshness(rec, now_ms()))
            self.plane_loads += 1
            if prev != rec["epoch"]:
                self.epoch_loads += 1

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            rec = self._tailer.poll()
            if rec is not None:
                self._load(rec)
            self._stop.wait(self.poll_ms / 1000.0)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ReachReplica":
        self.pubsub.start()
        self._poller.start()
        return self

    def poll_once(self) -> bool:
        """Synchronous single poll (tests drive the tailer directly)."""
        rec = self._tailer.poll()
        if rec is None:
            return False
        self._load(rec)
        return True

    def summary(self) -> dict:
        out = {
            "ship_path": self.ship_path,
            "device": str(self.device),
            "poll_ms": self.poll_ms,
            "max_staleness_ms": self.max_staleness_ms,
            "plane_loads": self.plane_loads,
            "epoch_loads": self.epoch_loads,
            "shed_before_load": self.shed_before_load,
            # chain-tailer evidence: bases/deltas applied, gaps +
            # damaged records survived, resyncs taken
            "tailer": self._tailer.stats(),
        }
        if self.fleet:
            out["fleet"] = True
            if self.clock is not None:
                out["clock"] = dict(self.clock)
        if self.device.type == "cuda":
            import torch

            out["device_memory"] = {
                "allocated_bytes": torch.cuda.memory_allocated(self.device),
                "peak_allocated_bytes": torch.cuda.max_memory_allocated(
                    self.device)}
        if self.server is not None:
            out["serve"] = self.server.summary()
        return out

    def close(self) -> None:
        self._stop.set()
        if self._poller.is_alive():
            self._poller.join(timeout=10.0)
        self.pubsub.close()
        if self.server is not None:
            self.server.close()
            # the planes go with the replica: a successor loading into
            # the same device must not find these still allocated
            self.server.drop_state()


def main(argv: list[str] | None = None) -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        prog="streambench-torch-reach-replica", description=__doc__)
    ap.add_argument("--ship", required=True,
                    help="ship log path (the writer store's "
                         "dimensions.log) or its directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the planes are served from: cuda "
                         "(default) or cpu")
    ap.add_argument("--poll-ms", type=int, default=200)
    ap.add_argument("--max-staleness-ms", type=int,
                    default=DEFAULT_MAX_STALENESS_MS)
    ap.add_argument("--cache", type=int, default=4096,
                    help="query-result cache capacity (0 disables)")
    ap.add_argument("--depth", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--duration", type=float, default=None,
                    help="seconds to serve (default: until SIGTERM)")
    ap.add_argument("--dump-queue-waits", action="store_true",
                    help="include raw queue-wait intervals in the exit "
                         "stats")
    ap.add_argument("--metrics-dir", default=None,
                    help="workdir for this replica's metrics.jsonl + "
                         "trace_<pid>.json + flight dumps (fleet mode)")
    ap.add_argument("--metrics-interval-ms", type=int, default=1000)
    ap.add_argument("--pid-file", default=None,
                    help="pidfile path (pids/replica_<n>); written as "
                         "'<pid> <starttime>' so liveness checks survive "
                         "pid recycling; REFUSES to start when the file "
                         "names a live process")
    ap.add_argument("--fleet", action="store_true",
                    help="fleet observability: replies carry the "
                         "freshness hop decomposition, the clock offset "
                         "to the writer origin is estimated, and "
                         "--metrics-dir gets this role's metrics.jsonl/"
                         "trace/flight files for the FleetCollector")
    args = ap.parse_args(argv)
    if args.pid_file:
        from streambench_tpu_torch.utils.pidfile import (
            acquire_pidfile,
            pidfile_alive,
            release_pidfile,
        )

        if acquire_pidfile(args.pid_file) is None:
            print(f"replica: refusing to start — {args.pid_file} names "
                  f"live pid {pidfile_alive(args.pid_file)}", flush=True)
            return 1

    ship = args.ship
    if os.path.isdir(ship):
        from streambench_tpu_torch.dimensions.store import LOG_NAME

        ship = os.path.join(ship, LOG_NAME)

    sampler = spans = flightrec = registry = None
    if args.metrics_dir:
        from streambench_tpu_torch.obs import (
            FlightRecorder,
            MetricsRegistry,
            MetricsSampler,
            SpanTracer,
        )

        os.makedirs(args.metrics_dir, exist_ok=True)
        registry = MetricsRegistry()
        sampler = MetricsSampler(
            os.path.join(args.metrics_dir, "metrics.jsonl"),
            interval_ms=args.metrics_interval_ms, registry=registry,
            role="replica")
        if args.fleet:
            spans = SpanTracer(registry=registry)
            flightrec = FlightRecorder(args.metrics_dir)
            flightrec.span_source = spans.tail

    rep = ReachReplica(ship, host=args.host, port=args.port,
                       poll_ms=args.poll_ms,
                       max_staleness_ms=args.max_staleness_ms,
                       cache_capacity=args.cache, depth=args.depth,
                       batch=args.batch, registry=registry,
                       fleet=args.fleet, spans=spans, flightrec=flightrec,
                       device=args.device).start()
    if sampler is not None:
        # the same "reach_query" block shape the writer journals, plus
        # the tailer's own counters under "replica"
        def _collect(rec, dt_s):
            rec["reach_query"] = (rep.server.summary()
                                  if rep.server is not None else None)
            rec["replica"] = {
                "plane_loads": rep.plane_loads,
                "epoch_loads": rep.epoch_loads,
                "shed_before_load": rep.shed_before_load,
            }
            if rep.clock is not None:
                rec["clock"] = dict(rep.clock)

        sampler.add_collector(_collect)
        sampler.start()
    host, port = rep.address
    fleet_note = " fleet=on" if args.fleet else ""
    print(f"replica: pubsub={host}:{port} ship={ship} "
          f"device={rep.device} max_staleness_ms={args.max_staleness_ms} "
          f"cache={args.cache}{fleet_note}", flush=True)

    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    t0 = now_ms()
    if args.duration is not None:
        done.wait(args.duration)
    else:
        done.wait()
    stats = rep.summary()
    stats["wall_s"] = round((now_ms() - t0) / 1000.0, 2)
    if args.dump_queue_waits and rep.server is not None:
        stats["queue_waits_ns"] = rep.server.wait_intervals()
    rep.close()
    if spans is not None:
        spans.dump(os.path.join(args.metrics_dir,
                                f"trace_{os.getpid()}.json"),
                   run="reach-replica")
    if flightrec is not None and len(flightrec):
        # the replica's black box: staleness high-water / shed trail
        # (dumped at exit so a storm postmortem has the evidence even
        # when the process itself ended cleanly)
        flightrec.dump("replica_exit")
    if sampler is not None:
        sampler.close(final=stats)
    if args.pid_file:
        release_pidfile(args.pid_file)
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
