"""Fleet supervisor: crash-fault, restart, and give up on replica
processes.

The port's copy of ``streambench_tpu/chaos/fleet_supervisor.py``.  The
supervision is host code; the replicas it spawns serve from the card
(``cli_spawn`` passes ``--device``, ``cuda`` unless asked otherwise).

:class:`~streambench_tpu_torch.chaos.supervisor.Supervisor` holds the
recovery semantics for the single writer: fresh attempt per crash,
capped exponential backoff with seeded jitter, give-up when restarts
stop making progress.  The :class:`FleetSupervisor` lifts the same
semantics to the PROCESS level for reach read replicas:

- it spawns N replica slots through an injectable ``spawn(idx, attempt)
  -> handle`` (a subprocess.Popen, or an in-process stand-in in tests —
  anything with ``pid`` / ``poll()`` / ``terminate()`` / ``kill()``);
- :meth:`kill` is a chaos run's crash fault — SIGKILL by default,
  so the replica gets no chance to shed gracefully or release its
  pidfile (the pidfile's recycled-pid check is what makes that safe);
- :meth:`step` notices deaths, schedules a respawn after the SAME
  capped-backoff-with-jitter formula as the writer's (seeded: a sweep replays
  bit-identically), and respawns when the backoff elapses;
- a slot whose process keeps dying *young* — uptime under
  ``healthy_after_s`` on ``max_restarts`` consecutive deaths — is given
  up on, exactly the writer's no-progress rule with uptime as the progress
  proxy (a replica that served for a while and then was crash-faulted
  earns its restart counter back);
- ``on_restart(idx, attempt)`` is the restart-path hook: the
  smoke wires it to the writer shipper's forced ship
  (``note_state(..., force=True)``), so a freshly restarted replica
  finds a RECENT record to load instead of sitting shed-stale until the
  next cadence tick.

Crash/restart/give-up events are annotated onto the shared telemetry
stream and flight recorder under the ``fleet_supervisor`` key, and the
``restarts`` counter feeds the ``obs fleet`` table.
"""

from __future__ import annotations

import random
import signal as _signal
import time

from streambench_tpu_torch.metrics import FaultCounters


class ReplicaSlot:
    """One supervised replica seat: the live handle plus its ledger."""

    __slots__ = ("idx", "handle", "attempt", "restarts",
                 "consecutive_young_deaths", "gave_up", "retired",
                 "spawned_at", "restart_at", "exit_codes", "kills")

    def __init__(self, idx: int):
        self.idx = idx
        self.handle = None
        self.attempt = 0
        self.restarts = 0
        self.consecutive_young_deaths = 0
        self.gave_up = False
        self.retired = False           # graceful scale-down, no respawn
        self.spawned_at = 0.0          # monotonic
        self.restart_at: float | None = None  # backoff deadline
        self.exit_codes: list = []
        self.kills = 0

    def summary(self) -> dict:
        return {"idx": self.idx,
                "pid": getattr(self.handle, "pid", None),
                "attempt": self.attempt, "restarts": self.restarts,
                "kills": self.kills, "gave_up": self.gave_up,
                "retired": self.retired,
                "exit_codes": list(self.exit_codes)}


class FleetSupervisor:
    """Spawn/kill/restart N replica slots under capped backoff.

    ``spawn(idx, attempt)`` must return a fresh process handle each
    call; the supervisor never reuses a dead handle (a crashed replica
    is abandoned exactly as the writer's supervisor abandons a crashed
    engine).  Drive it
    with :meth:`watch` (poll loop) or :meth:`step` directly from a
    test's own clock.
    """

    def __init__(self, spawn, n: int, *,
                 backoff_base_ms: float = 50.0,
                 backoff_cap_ms: float = 2000.0,
                 max_restarts: int = 5,
                 healthy_after_s: float = 5.0,
                 seed: int = 0,
                 on_restart=None,
                 counters: FaultCounters | None = None,
                 sampler=None, flightrec=None,
                 sleep=time.sleep, clock=time.monotonic):
        self.spawn_fn = spawn
        self.slots = [ReplicaSlot(i) for i in range(int(n))]
        self.backoff_base_ms = max(float(backoff_base_ms), 0.0)
        self.backoff_cap_ms = max(float(backoff_cap_ms),
                                  self.backoff_base_ms)
        self.max_restarts = max(int(max_restarts), 1)
        self.healthy_after_s = float(healthy_after_s)
        self.on_restart = on_restart
        self.counters = counters if counters is not None else FaultCounters()
        self.sampler = sampler
        self.flightrec = flightrec
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock
        self._stopping = False

    # -- the writer supervisor's backoff, verbatim semantics -----------
    def _backoff(self, consecutive: int) -> float:
        """Capped exponential backoff with jitter (ms)."""
        n = min(consecutive, 16)
        base = min(self.backoff_base_ms * (1 << max(n - 1, 0)),
                   self.backoff_cap_ms)
        return base * (0.5 + 0.5 * self._rng.random())

    def _annotate(self, event: str, **fields) -> None:
        if self.sampler is not None:
            self.sampler.annotate(event, **fields)
        if self.flightrec is not None:
            self.flightrec.record("fleet_supervisor", event=event,
                                  **fields)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "FleetSupervisor":
        for slot in self.slots:
            self._spawn(slot)
        return self

    def _spawn(self, slot: ReplicaSlot) -> None:
        slot.attempt += 1
        slot.handle = self.spawn_fn(slot.idx, slot.attempt)
        slot.spawned_at = self._clock()
        slot.restart_at = None

    # -- elastic surface: the autoscaler's grow/shrink ------------------
    def spawn(self) -> int:
        """Grow the fleet by one supervised slot and spawn it now.
        Returns the new slot index (also its spawn-callable idx)."""
        if self._stopping:
            raise RuntimeError("supervisor is stopping")
        slot = ReplicaSlot(len(self.slots))
        self.slots.append(slot)
        self._spawn(slot)
        self.counters.inc("spawns")
        self._annotate("replica_spawn", idx=slot.idx,
                       pid=getattr(slot.handle, "pid", None))
        return slot.idx

    def retire(self, idx: int, *, deregister=None,
               drain_s: float = 0.25, grace_s: float = 5.0) -> bool:
        """Graceful scale-down: deregister -> drain -> stop.

        ``deregister(idx)`` (e.g. ``router.remove_replica``) runs FIRST
        so no new queries route here; then the replica drains in-flight
        work for ``drain_s`` before SIGTERM (SIGKILL after ``grace_s``).
        A retired slot is never respawned, and ``retires`` is counted
        separately from crash ``kills`` — scale-down is an intended
        state change, not a fault.  Returns False when the slot is
        already retired/given-up."""
        slot = self.slots[idx]
        if slot.retired or slot.gave_up:
            return False
        if deregister is not None:
            deregister(idx)
        slot.retired = True   # before the stop: step() must not respawn
        h = slot.handle
        pid = getattr(h, "pid", None)
        if h is not None and h.poll() is None:
            if drain_s > 0:
                self._sleep(drain_s)
            try:
                h.terminate()
            except OSError:
                pass
            deadline = self._clock() + float(grace_s)
            while h.poll() is None and self._clock() < deadline:
                self._sleep(0.02)
            if h.poll() is None:
                try:
                    h.kill()
                except OSError:
                    pass
                h.poll()
        self.counters.inc("retires")
        self._annotate("replica_retire", idx=idx, pid=pid,
                       drain_s=drain_s)
        return True

    def alive(self, idx: int) -> bool:
        h = self.slots[idx].handle
        return h is not None and h.poll() is None

    def kill(self, idx: int, *, hard: bool = True) -> bool:
        """Crash-fault one replica.  ``hard`` (default) is SIGKILL —
        no graceful shed, no pidfile release; False is SIGTERM.
        Returns False when the slot has no live process to kill."""
        slot = self.slots[idx]
        h = slot.handle
        if h is None or h.poll() is not None:
            return False
        (h.kill if hard else h.terminate)()
        slot.kills += 1
        self.counters.inc("crash_kills")
        self._annotate("replica_kill", idx=idx,
                       pid=getattr(h, "pid", None), hard=hard)
        return True

    def step(self, now: float | None = None) -> int:
        """One supervision pass: notice deaths, schedule backoffs,
        respawn slots whose backoff elapsed.  Returns restarts
        performed this pass."""
        if self._stopping:
            return 0
        now = self._clock() if now is None else now
        restarted = 0
        for slot in self.slots:
            if slot.gave_up or slot.retired:
                continue
            if slot.restart_at is None:
                h = slot.handle
                code = h.poll() if h is not None else 0
                if code is None:
                    continue
                # death observed: ledger it, decide give-up vs backoff
                slot.exit_codes.append(code)
                uptime = now - slot.spawned_at
                if uptime >= self.healthy_after_s:
                    slot.consecutive_young_deaths = 0
                else:
                    slot.consecutive_young_deaths += 1
                self._annotate("replica_crash", idx=slot.idx,
                               exit_code=code,
                               uptime_s=round(uptime, 3))
                if slot.consecutive_young_deaths >= self.max_restarts:
                    slot.gave_up = True
                    self.counters.inc("give_ups")
                    self._annotate("replica_give_up", idx=slot.idx,
                                   attempts=slot.attempt,
                                   young_deaths=
                                   slot.consecutive_young_deaths)
                    continue
                back_ms = self._backoff(
                    max(slot.consecutive_young_deaths, 1))
                slot.restart_at = now + back_ms / 1000.0
            if slot.restart_at is not None and now >= slot.restart_at:
                self._spawn(slot)
                slot.restarts += 1
                restarted += 1
                self.counters.inc("restarts")
                self._annotate("replica_restart", idx=slot.idx,
                               attempt=slot.attempt,
                               pid=getattr(slot.handle, "pid", None))
                if self.on_restart is not None:
                    self.on_restart(slot.idx, slot.attempt)
        return restarted

    def watch(self, duration_s: float, poll_s: float = 0.05) -> int:
        """Poll loop for ``duration_s``; returns total restarts."""
        deadline = self._clock() + float(duration_s)
        total = 0
        while self._clock() < deadline and not self._stopping:
            total += self.step()
            self._sleep(poll_s)
        return total

    def stop(self, *, grace_s: float = 5.0) -> None:
        """Terminate every live replica (SIGTERM, escalate to SIGKILL
        after ``grace_s``) and stop restarting."""
        self._stopping = True
        live = [s for s in self.slots
                if s.handle is not None and s.handle.poll() is None]
        for slot in live:
            try:
                slot.handle.terminate()
            except OSError:
                pass
        deadline = self._clock() + float(grace_s)
        for slot in live:
            while (slot.handle.poll() is None
                   and self._clock() < deadline):
                self._sleep(0.02)
            if slot.handle.poll() is None:
                try:
                    slot.handle.kill()
                except OSError:
                    pass
                slot.handle.poll()

    def summary(self) -> dict:
        return {"replicas": [s.summary() for s in self.slots],
                "restarts": sum(s.restarts for s in self.slots),
                "kills": sum(s.kills for s in self.slots),
                "gave_up": sum(1 for s in self.slots if s.gave_up),
                "retired": sum(1 for s in self.slots if s.retired),
                "active": sum(1 for s in self.slots
                              if not s.retired and not s.gave_up
                              and s.handle is not None
                              and s.handle.poll() is None)}


def cli_spawn(ship_path: str, workdir: str, *,
              host: str = "127.0.0.1", ports=None,
              max_staleness_ms: int | None = None,
              poll_ms: int | None = None, fleet: bool = False,
              metrics: bool = False, device: str = "cuda",
              extra_args=()):
    """A ``spawn`` callable running the port's replica CLI per slot:
    ``python -m streambench_tpu_torch.reach.replica --device <device>
    --ship ... --pid-file pids/replica_<idx>`` with stdout teed to
    ``<workdir>/replica_<idx>.out`` (the harness parses the ready
    line from it).  ``ports[idx]`` pins each slot's pub/sub port so a
    restarted replica comes back at the SAME address — the router's
    replica list stays valid across restarts.

    ``device`` is passed to every replica as ``--device`` and defaults
    to ``cuda``: a replica asked for the card that finds none exits
    non-zero, it never starts on the CPU instead."""
    import os
    import subprocess
    import sys

    os.makedirs(workdir, exist_ok=True)

    def spawn(idx: int, attempt: int):
        # the replica would raise the same at its start: raise it here,
        # before a process that can only fail is launched
        from streambench_tpu_torch.utils.device import resolve_device

        resolve_device(device)
        cmd = [sys.executable, "-m", "streambench_tpu_torch.reach.replica",
               "--device", str(device),
               "--ship", ship_path, "--host", host,
               "--port", str(ports[idx] if ports else 0),
               "--pid-file",
               os.path.join(workdir, "pids", f"replica_{idx}")]
        if max_staleness_ms is not None:
            cmd += ["--max-staleness-ms", str(max_staleness_ms)]
        if poll_ms is not None:
            cmd += ["--poll-ms", str(poll_ms)]
        if fleet:
            cmd.append("--fleet")
        if metrics:
            d = os.path.join(workdir, f"replica_{idx}")
            os.makedirs(d, exist_ok=True)
            cmd += ["--metrics-dir", d]
        cmd += list(extra_args)
        out = open(os.path.join(workdir, f"replica_{idx}.out"), "ab")
        proc = subprocess.Popen(cmd, stdout=out, stderr=out)
        out.close()
        return proc

    return spawn


def wait_ready(out_path: str, *, timeout_s: float = 30.0,
               marker: str = "replica: pubsub=") -> tuple[str, int]:
    """Parse a spawned replica's ready line from its teed stdout;
    returns (host, port).  Raises TimeoutError when the line never
    lands (the spawn died before serving)."""
    import os

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if os.path.exists(out_path):
            with open(out_path, encoding="utf-8",
                      errors="replace") as f:
                for line in f:
                    if marker in line:
                        addr = line.split(marker, 1)[1].split()[0]
                        host, port = addr.rsplit(":", 1)
                        return host, int(port)
        time.sleep(0.05)
    raise TimeoutError(f"no ready line in {out_path}")


# re-exported so chaos runs need one import for the kill signal set
SIGKILL = _signal.SIGKILL
SIGTERM = _signal.SIGTERM
