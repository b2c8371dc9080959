"""Freshness-aware failover router for the reach replica fleet.

The port's copy of ``streambench_tpu/reach/router.py``: host code with
no torch; the replicas it fronts serve from the card.  One fronting process owns the client-facing ``reach`` verb and fans
query batches out across N replicas:

- **sticky routing**: the primary replica for a query is chosen by a
  STABLE hash of its campaign set (crc32 over the sorted names — not
  Python's salted ``hash``), so repeats of the same set land on the
  same replica and its (epoch, campaign-set) result cache keeps
  hitting;
- **freshness-ordered failover**: every reply already carries
  ``staleness_ms`` + the per-hop freshness ledger and every
  shed carries its reason — the router folds both into a per-replica
  health ledger (last staleness, epoch, timeouts, shed counts,
  consecutive failures) and, when the primary times out / errors /
  sheds, retries the NEXT-FRESHEST replica rather than a random one;
- **honest shed**: when every replica is outside the staleness bound
  (or down), the router answers ``{"shed": true, "reason":
  "all_stale" | "overloaded" | "no_replica"}`` — it never silently
  serves stale-beyond-bound evidence and never drops a query on the
  floor.  ``sent == answered + shed`` is the accounting invariant
  ``chaos.verify.check_fleet_accounting`` asserts over request ids.

Forwarded requests use router-internal ids (the pub/sub request-id
dedup and the timeout/retry path key on them); the client's own id is
restored on the reply, so a routed answer is byte-identical to a
direct replica answer — the router adds NO fields to a served reply.

Run one per fleet::

    python -m streambench_tpu_torch.reach.router \
        --replicas 127.0.0.1:7001,127.0.0.1:7002 --port 0

The process prints ``router: pubsub=<host>:<port> replicas=<n>`` once
serving (harness/CI parse it) and one JSON stats line at exit.
"""

from __future__ import annotations

import json
import threading
import time
import zlib

from streambench_tpu_torch.utils.ids import now_ms

#: per-attempt reply deadline + bounded same-replica retries (each
#: retry uses a fresh derived id; the replica answers each id once)
DEFAULT_TIMEOUT_S = 2.0
DEFAULT_RETRIES = 1

#: a replica with this many consecutive failures is demoted to the
#: END of the failover order until the cooldown passes — the sticky
#: primary must not tax every query with a dead replica's timeout
SUSPECT_AFTER = 2
SUSPECT_COOLDOWN_S = 5.0

#: summary() reports answered-query e2e percentiles over this many
#: trailing seconds (the autoscaler's latency evidence must decay
#: after a burst, or a past breach would read as a live one forever)
E2E_WINDOW_S = 5.0


def campaign_shard(campaigns, n: int) -> int:
    """Stable shard index for a campaign set: crc32 over the sorted,
    comma-joined names.  Deterministic across processes and runs
    (Python's ``hash`` is salted per process), insensitive to query
    order — ``{a,b}`` and ``{b,a}`` are the same cache line."""
    key = ",".join(sorted(str(c) for c in campaigns))
    return zlib.crc32(key.encode()) % max(int(n), 1)


class ReplicaHandle:
    """Router-side view of one replica endpoint: a persistent
    JSON-lines client plus the health ledger failover ordering reads.
    Thread-safe: one lock serializes the connection, the ledger fields
    are GIL-atomic scalar writes."""

    def __init__(self, addr: str, *, timeout_s: float = DEFAULT_TIMEOUT_S,
                 retries: int = DEFAULT_RETRIES):
        self.addr = str(addr)
        host, _, port = self.addr.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.retries = max(int(retries), 0)
        self._client = None
        self._lock = threading.Lock()
        # health ledger
        self.served = 0
        self.sheds = 0
        self.stale_sheds = 0
        self.timeouts = 0
        self.errors = 0
        self.consecutive_failures = 0
        self.last_staleness_ms: float | None = None
        self.last_epoch: int | None = None
        self._last_failure_mono: float | None = None

    # -- transport -----------------------------------------------------
    def ask(self, msg: dict) -> dict:
        """One id-matched synchronous request.  Raises TimeoutError /
        ConnectionError / OSError; the connection is torn down on any
        failure and rebuilt lazily on the next ask."""
        with self._lock:
            if self._client is None:
                from streambench_tpu_torch.dimensions.pubsub import PubSubClient

                self._client = PubSubClient(self.host, self.port,
                                            timeout_s=self.timeout_s)
            try:
                return self._client.request(msg,
                                            timeout_s=self.timeout_s,
                                            retries=self.retries)
            except (TimeoutError, ConnectionError, OSError):
                try:
                    self._client.close()
                except Exception:
                    pass
                self._client = None
                raise

    # -- ledger --------------------------------------------------------
    def note_served(self, data: dict) -> None:
        self.served += 1
        self.consecutive_failures = 0
        stale = data.get("staleness_ms")
        if isinstance(stale, (int, float)):
            self.last_staleness_ms = float(stale)
        epoch = data.get("plane_epoch")
        if isinstance(epoch, int):
            self.last_epoch = epoch

    def note_shed(self, data: dict) -> None:
        self.sheds += 1
        if data.get("reason") == "stale":
            self.stale_sheds += 1
            stale = data.get("staleness_ms")
            if isinstance(stale, (int, float)):
                self.last_staleness_ms = float(stale)
        epoch = data.get("plane_epoch")
        if isinstance(epoch, int):
            self.last_epoch = epoch

    def note_failure(self, timeout: bool) -> None:
        if timeout:
            self.timeouts += 1
        else:
            self.errors += 1
        self.consecutive_failures += 1
        self._last_failure_mono = time.monotonic()

    def suspect(self) -> bool:
        """True while this replica should be tried LAST: enough
        consecutive failures, within the cooldown."""
        if self.consecutive_failures < SUSPECT_AFTER:
            return False
        last = self._last_failure_mono
        return (last is not None
                and time.monotonic() - last < SUSPECT_COOLDOWN_S)

    def freshness_key(self) -> float:
        """Failover sort key: last known staleness, unknowns last
        among the non-suspect (an endpoint that never answered carries
        no freshness evidence)."""
        s = self.last_staleness_ms
        return float(s) if s is not None else float("inf")

    def health(self) -> dict:
        out = {"addr": self.addr, "served": self.served,
               "sheds": self.sheds, "timeouts": self.timeouts,
               "errors": self.errors,
               "suspect": self.suspect()}
        if self.stale_sheds:
            out["stale_sheds"] = self.stale_sheds
        if self.last_staleness_ms is not None:
            out["staleness_ms"] = round(self.last_staleness_ms, 1)
        if self.last_epoch is not None:
            out["plane_epoch"] = self.last_epoch
        return out

    def close(self) -> None:
        with self._lock:
            if self._client is not None:
                try:
                    self._client.close()
                except Exception:
                    pass
                self._client = None


class ReachRouter:
    """The fronting ``reach`` verb over a replica fleet."""

    #: client errors forwarded verbatim instead of failed over — the
    #: next replica would refuse the same malformed query identically
    CLIENT_ERRORS = ("bad_request", "unknown_campaign")

    def __init__(self, replicas, *, host: str = "127.0.0.1",
                 port: int = 0, timeout_s: float = DEFAULT_TIMEOUT_S,
                 retries: int = DEFAULT_RETRIES, registry=None,
                 flightrec=None):
        from streambench_tpu_torch.dimensions.pubsub import PubSubServer

        if not replicas:
            raise ValueError("router needs at least one replica")
        self.timeout_s = float(timeout_s)
        self.retries = retries
        self.handles = [ReplicaHandle(a, timeout_s=timeout_s,
                                      retries=retries)
                        for a in replicas]
        self._flightrec = flightrec
        self.routed = 0
        self.answered = 0
        self.shed = 0
        self.failovers = 0
        self._fail_ring: list = []          # failover episode ms
        self._fail_ring_max = 8192
        # answered-query e2e latency, (monotonic, ms): the fleet's
        # front-door latency — a single serialized replica handle shows
        # up HERE, not in any replica's own submit->reply percentiles.
        # Stamped so summary() reports a recent window, not all-time:
        # the autoscaler must see a burst's pressure decay, not carry
        # it forever
        self._e2e_ring: list = []
        self._e2e_ring_max = 8192
        self._id_lock = threading.Lock()
        self._next = 0
        self._routed_t0: float | None = None
        self._routed_t1: float | None = None
        self._c_failover = self._c_shed = self._g_healthy = None
        if registry is not None:
            self._c_failover = registry.counter(
                "streambench_router_failover_total",
                "queries answered by a non-primary replica after the "
                "primary timed out, errored, or shed")
            self._c_shed = registry.counter(
                "streambench_router_shed_total",
                "queries the router shed because no replica was "
                "inside the staleness bound (or reachable)")
            self._g_healthy = registry.gauge(
                "streambench_router_healthy_replicas",
                "replicas not currently suspect (failover cooldown)")
        self.pubsub = PubSubServer(host=host, port=port)
        self.pubsub.register_query("reach", self._handle)

    # -- routing -------------------------------------------------------
    @property
    def address(self) -> tuple:
        return self.pubsub.address

    def start(self) -> "ReachRouter":
        self.pubsub.start()
        return self

    def _order(self, campaigns) -> list:
        """Sticky primary first, then the rest by freshness; suspects
        (primary included) demoted to the end, still freshness-
        ordered — a down fleet is retried in best-evidence order.
        Snapshots ``self.handles`` once: add/remove_replica swap the
        list atomically, so an in-flight query keeps a consistent
        view."""
        handles = self.handles
        primary = handles[campaign_shard(campaigns, len(handles))]
        rest = sorted((h for h in handles if h is not primary),
                      key=ReplicaHandle.freshness_key)
        order = [primary] + rest
        live = [h for h in order if not h.suspect()]
        dead = [h for h in order if h.suspect()]
        return live + dead

    # -- elastic surface: the autoscaler's registry --------------------
    def add_replica(self, addr: str) -> ReplicaHandle:
        """Register one more replica endpoint (scale-up).  The sticky
        shard map re-spreads over the new count on the next query; the
        copy-and-swap keeps in-flight `_order` snapshots consistent."""
        h = ReplicaHandle(addr, timeout_s=self.timeout_s,
                          retries=self.retries)
        self.handles = self.handles + [h]
        return h

    def remove_replica(self, addr: str) -> bool:
        """Deregister an endpoint (graceful retire): new queries stop
        routing to it immediately; its connection is closed.  Refuses
        to empty the fleet (the router's constructor invariant);
        returns False for an unknown address."""
        handles = self.handles
        keep = [h for h in handles if h.addr != str(addr)]
        if len(keep) == len(handles):
            return False
        if not keep:
            raise ValueError("router needs at least one replica")
        self.handles = keep
        for h in handles:
            if h.addr == str(addr):
                h.close()
        return True

    def _route_id(self) -> str:
        with self._id_lock:
            self._next += 1
            return f"rt{self._next}"

    def _handle(self, msg: dict, reply) -> None:
        """The pub/sub verb hook: route one query, never raise."""
        t0 = time.monotonic()
        self.routed += 1
        if self._routed_t0 is None:
            self._routed_t0 = t0
        client_id = msg.get("id")
        campaigns = msg.get("campaigns")
        order = self._order(campaigns if isinstance(
            campaigns, (list, tuple)) else ())
        attempts = 0
        saw_stale = saw_shed = False
        for h in order:
            attempts += 1
            fwd = dict(msg)
            fwd["id"] = self._route_id()
            try:
                data = h.ask(fwd)
            except (TimeoutError, ConnectionError, OSError) as e:
                h.note_failure(isinstance(e, TimeoutError))
                self._note_failover_step(h, "error", repr(e))
                continue
            if not isinstance(data, dict):
                h.note_failure(False)
                continue
            if data.get("error") in self.CLIENT_ERRORS:
                # the query itself is malformed: every replica would
                # refuse it identically — forward the refusal, done
                self._finish(reply, data, client_id, t0, attempts)
                return
            if data.get("error"):
                h.note_failure(False)
                self._note_failover_step(h, "error", str(data["error"]))
                continue
            if data.get("shed"):
                h.note_shed(data)
                saw_shed = True
                saw_stale = saw_stale or data.get("reason") == "stale"
                self._note_failover_step(
                    h, "shed", str(data.get("reason") or "depth"))
                continue
            h.note_served(data)
            self._finish(reply, data, client_id, t0, attempts)
            return
        # every replica exhausted: the honest shed
        reason = ("all_stale" if saw_stale
                  else "overloaded" if saw_shed else "no_replica")
        self.shed += 1
        if self._c_shed is not None:
            self._c_shed.inc()
        if self._flightrec is not None:
            self._flightrec.record(
                "router_shed", reason=reason, attempts=attempts,
                shed_total=self.shed, routed=self.routed)
        self._safe_reply(reply, {"shed": True, "reason": reason,
                                 "id": client_id})
        self._routed_t1 = time.monotonic()

    def _finish(self, reply, data: dict, client_id, t0: float,
                attempts: int) -> None:
        out = dict(data)
        out["id"] = client_id
        self._safe_reply(reply, out)
        self.answered += 1
        self._routed_t1 = time.monotonic()
        self._e2e_ring.append(
            (self._routed_t1, (self._routed_t1 - t0) * 1000.0))
        if len(self._e2e_ring) > self._e2e_ring_max:
            del self._e2e_ring[0]
        if attempts > 1:
            self.failovers += 1
            if self._c_failover is not None:
                self._c_failover.inc()
            ms = (self._routed_t1 - t0) * 1000.0
            self._fail_ring.append(ms)
            if len(self._fail_ring) > self._fail_ring_max:
                del self._fail_ring[0]
        if self._g_healthy is not None:
            self._g_healthy.set(
                sum(1 for h in self.handles if not h.suspect()))

    def _note_failover_step(self, h: ReplicaHandle, kind: str,
                            detail: str) -> None:
        if self._flightrec is not None:
            self._flightrec.record(
                "router_failover", replica=h.addr, kind=kind,
                detail=detail[:120], failovers=self.failovers)

    @staticmethod
    def _safe_reply(reply, data: dict) -> None:
        try:
            reply(data)
        except Exception:
            pass   # a dead client must not kill routing

    # -- reporting -----------------------------------------------------
    def summary(self) -> dict:
        out = {
            "routed": self.routed,
            "answered": self.answered,
            "shed": self.shed,
            "failovers": self.failovers,
            "shed_ratio": (round(self.shed / self.routed, 4)
                           if self.routed else 0.0),
            "replicas": [h.health() for h in self.handles],
        }
        if self._fail_ring:
            lats = sorted(self._fail_ring)
            out["failover_p50_ms"] = round(lats[len(lats) // 2], 2)
            out["failover_p99_ms"] = round(
                lats[min(len(lats) - 1, int(len(lats) * 0.99))], 2)
        cutoff = time.monotonic() - E2E_WINDOW_S
        recent = sorted(ms for t, ms in list(self._e2e_ring)
                        if t >= cutoff)
        if recent:
            out["e2e_recent_n"] = len(recent)
            out["e2e_p50_ms"] = round(recent[len(recent) // 2], 2)
            out["e2e_p99_ms"] = round(
                recent[min(len(recent) - 1,
                           int(len(recent) * 0.99))], 2)
        if (self._routed_t0 is not None and self._routed_t1 is not None
                and self._routed_t1 > self._routed_t0 and self.routed):
            out["qps"] = round(
                self.routed / (self._routed_t1 - self._routed_t0), 1)
        return out

    def close(self) -> None:
        self.pubsub.close()
        for h in self.handles:
            h.close()


def main(argv: list[str] | None = None) -> int:
    import argparse
    import os
    import signal

    ap = argparse.ArgumentParser(
        prog="streambench-torch-reach-router", description=__doc__)
    ap.add_argument("--replicas", required=True,
                    help="comma-separated replica pub/sub endpoints "
                         "(host:port,host:port,...)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--timeout-s", type=float, default=DEFAULT_TIMEOUT_S)
    ap.add_argument("--retries", type=int, default=DEFAULT_RETRIES)
    ap.add_argument("--duration", type=float, default=None,
                    help="seconds to serve (default: until SIGTERM)")
    ap.add_argument("--pid-file", default=None,
                    help="write '<pid> <starttime>' here (refuses to "
                         "start when the file names a live process)")
    ap.add_argument("--metrics-dir", default=None,
                    help="workdir for this router's metrics.jsonl + "
                         "flight dumps (FleetCollector reads them like "
                         "any other role)")
    ap.add_argument("--metrics-interval-ms", type=int, default=1000)
    args = ap.parse_args(argv)

    pidfile = None
    if args.pid_file:
        from streambench_tpu_torch.utils.pidfile import acquire_pidfile

        pidfile = acquire_pidfile(args.pid_file)
        if pidfile is None:
            print(f"router: refusing to start, {args.pid_file} names "
                  f"a live process", flush=True)
            return 1

    sampler = flightrec = None
    registry = None
    if args.metrics_dir:
        from streambench_tpu_torch.obs import (
            FlightRecorder,
            MetricsRegistry,
            MetricsSampler,
        )

        os.makedirs(args.metrics_dir, exist_ok=True)
        registry = MetricsRegistry()
        sampler = MetricsSampler(
            os.path.join(args.metrics_dir, "metrics.jsonl"),
            interval_ms=args.metrics_interval_ms, registry=registry,
            role="router")
        flightrec = FlightRecorder(args.metrics_dir)

    replicas = [a.strip() for a in args.replicas.split(",") if a.strip()]
    router = ReachRouter(replicas, host=args.host, port=args.port,
                         timeout_s=args.timeout_s, retries=args.retries,
                         registry=registry, flightrec=flightrec).start()
    if sampler is not None:
        def _collect(rec, dt_s):
            rec["router"] = router.summary()

        sampler.add_collector(_collect)
        sampler.start()
    host, port = router.address
    print(f"router: pubsub={host}:{port} replicas={len(replicas)} "
          f"timeout_s={args.timeout_s}", flush=True)

    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    t0 = now_ms()
    done.wait(args.duration)
    stats = router.summary()
    stats["wall_s"] = round((now_ms() - t0) / 1000.0, 2)
    router.close()
    if flightrec is not None and len(flightrec):
        flightrec.dump("router_exit")
    if sampler is not None:
        sampler.close(final=stats)
    if pidfile is not None:
        from streambench_tpu_torch.utils.pidfile import release_pidfile

        release_pidfile(args.pid_file)
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
