"""Supervised crash recovery: restart the runner until the stream is done.

The port's copy of ``streambench_tpu/chaos/supervisor.py``, over the
port's ``RunStats``.  A :class:`Supervisor` runs a ``StreamRunner``
attempt, and on a crash builds a FRESH runner (the crashed engine is
abandoned exactly as a dead process would leave it, its device state
included), resumes it from the newest checkpoint, and retries under
capped exponential backoff with jitter.  It gives up cleanly after N
consecutive restarts that made no durable progress (the checkpoint
offset did not advance), so a poisoned stream or a dependency that stays
down cannot restart-loop forever.

Only the simulated ``EngineCrash`` and connection-shaped errors
(``ConnectionError``, ``TimeoutError``) count as crashes.  Anything else
-- a CUDA error, an assertion, a schema mismatch -- is a bug and
propagates: the device never hides behind a restart.

Recovery bookkeeping for the oracle (``chaos.verify``): each crash
contributes one *replay segment* ``[resume_offset, crash_offset)`` -- the
journal byte range whose events may be double-applied -- and each resume
records the restored snapshot's *carried pending* deltas, which may
likewise be double-applied when the crashed attempt had already written
them.  Together these are the at-least-once over-count bound documented
in ``checkpoint.py``.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

from streambench_tpu_torch.chaos.plan import EngineCrash
from streambench_tpu_torch.engine.runner import RunStats
from streambench_tpu_torch.metrics import FaultCounters


@dataclass
class SupervisorStats:
    """One supervised run, summarized."""

    attempts: int = 0
    crashes: int = 0
    restarts: int = 0
    gave_up: bool = False
    backoff_ms_total: float = 0.0
    # journal byte ranges whose events may be double-counted, one per
    # crash: (resume_offset_of_the_following_attempt, crash_offset)
    replay_segments: list = field(default_factory=list)
    # snapshot-carried pending deltas observed at each resume:
    # (campaign_name, abs_window_ts) -> summed count.  Reclaimed failed
    # writes a snapshot carries may already have landed before the
    # crash; re-flushing them after restore is the second (and only
    # other) legal over-count source.
    carried: dict = field(default_factory=dict)
    stats: RunStats | None = None     # the successful attempt's stats
    errors: list = field(default_factory=list)  # repr per crash

    @property
    def completed(self) -> bool:
        return self.stats is not None


class Supervisor:
    """Runs ``make_runner()`` attempts until one completes or progress dies.

    ``make_runner`` must return a FRESH ``StreamRunner`` each call (new
    engine, new reader, same checkpointer directory) — reusing a crashed
    engine would let host state survive a "crash", which is exactly what
    the chaos layer exists to rule out.  If the runner carries a
    ``crash_points`` scheduler, its per-attempt boundary counts are
    reset on every restart.

    ``catch`` is the crash surface: the simulated :class:`EngineCrash`
    plus the connection-shaped errors a real dependency failure raises
    out of the run loop.  Anything else (assertion, schema mismatch) is
    a bug and propagates.
    """

    def __init__(self, make_runner, *,
                 max_no_progress_restarts: int = 3,
                 backoff_base_ms: float = 50.0,
                 backoff_cap_ms: float = 2000.0,
                 seed: int = 0,
                 catch: tuple = (EngineCrash, ConnectionError, TimeoutError),
                 sleep=time.sleep,
                 counters: FaultCounters | None = None,
                 sampler=None,
                 flightrec=None):
        self.make_runner = make_runner
        # Telemetry annotation hook (obs.MetricsSampler or anything with
        # ``annotate(event, **fields)``): crash/restart/give-up events
        # land in the metrics.jsonl stream between snapshots, so a
        # supervised run's time series shows WHEN each restart happened
        # against the throughput/backlog curves, not just how many.
        self.sampler = sampler
        # Crash flight recorder (obs.flightrec or None): crash/restart
        # annotations land in the postmortem ring next to the runners'
        # tick records (share ONE recorder with make_runner's runners so
        # the sequence numbers interleave in true order), and a give-up
        # dumps ``flight_give_up.jsonl`` with the terminal fault last —
        # the black box of a chaos sweep that died for good.
        self.flightrec = flightrec
        self.max_no_progress_restarts = max(int(max_no_progress_restarts), 1)
        self.backoff_base_ms = max(float(backoff_base_ms), 0.0)
        self.backoff_cap_ms = max(float(backoff_cap_ms), self.backoff_base_ms)
        self.catch = catch
        self._sleep = sleep
        self._rng = random.Random(seed)
        self.counters = counters if counters is not None else FaultCounters()
        self.stats = SupervisorStats()
        self.runner = None          # the last (on success: final) runner

    # ------------------------------------------------------------------
    def _backoff(self, consecutive_crashes: int) -> float:
        """Capped exponential backoff with jitter (ms).  Full jitter on
        the upper half: deterministic under ``seed``, but two supervisors
        sharing a dependency don't thundering-herd its recovery."""
        n = min(consecutive_crashes, 16)
        base = min(self.backoff_base_ms * (1 << max(n - 1, 0)),
                   self.backoff_cap_ms)
        return base * (0.5 + 0.5 * self._rng.random())

    @staticmethod
    def _progress_key(position) -> int:
        """Scalar progress from a reader position (sum of the vector for
        multi-partition readers: any partition advancing is progress)."""
        return sum(position) if isinstance(position, list) else int(position)

    def _durable_progress(self, runner) -> int:
        """Where the NEXT attempt will resume: the newest checkpoint's
        offset (0 when none exists).  Evaluated at crash time so an
        attempt that saved a snapshot and THEN crashed — e.g. a crash
        injected right at the checkpoint boundary — counts as progress
        immediately, not one restart later."""
        ck = getattr(runner, "checkpointer", None)
        snap = ck.load() if ck is not None else None
        return self._progress_key(snap.offset) if snap is not None else 0

    def _record_resume(self, runner, prev_crash_offset) -> None:
        """Log the replay segment + carried pending for this resume."""
        resume_pos = runner._reader_position()
        if prev_crash_offset is not None:
            self.stats.replay_segments.append(
                (resume_pos, prev_crash_offset))
        campaigns = runner.engine.encoder.campaigns
        for (ci, ts), n in runner.engine.pending_counts().items():
            key = (campaigns[ci], int(ts))
            self.stats.carried[key] = self.stats.carried.get(key, 0) + n
        # exactly-once runs: the restored fence baseline the next flush's
        # sink read will be judged against — on the telemetry/postmortem
        # streams so a reconcile decision can be traced back to its input
        fence = getattr(runner.engine, "_xo_baseline", None)
        xo = getattr(runner.engine, "_xo", False)
        if xo and fence is not None:
            if self.sampler is not None:
                self.sampler.annotate(
                    "resume", resume_offset=resume_pos,
                    fence_epoch=fence[0], fence_seq=fence[1])
            if self.flightrec is not None:
                self.flightrec.record(
                    "supervisor", event="resume",
                    resume_offset=resume_pos,
                    fence_epoch=fence[0], fence_seq=fence[1])

    # ------------------------------------------------------------------
    def run(self, *, catchup: bool = False, **run_kwargs) -> SupervisorStats:
        """Drive attempts to completion.  ``run_kwargs`` go to every
        attempt's ``runner.run``/``run_catchup`` unchanged."""
        st = self.stats
        consecutive_crashes = 0
        no_progress = 0
        last_durable_progress: int | None = None
        prev_crash_offset = None
        while True:
            runner = self.runner = self.make_runner()
            st.attempts += 1
            resumed = runner.resume()
            if resumed:
                self._record_resume(runner, prev_crash_offset)
            elif prev_crash_offset is not None:
                # crashed before the first checkpoint: the whole prefix
                # up to the crash replays from offset zero
                zero = ([0] * len(prev_crash_offset)
                        if isinstance(prev_crash_offset, list) else 0)
                st.replay_segments.append((zero, prev_crash_offset))
            sched = getattr(runner, "crash_points", None)
            if sched is not None:
                sched.reset()
            try:
                st.stats = (runner.run_catchup(**run_kwargs) if catchup
                            else runner.run(**run_kwargs))
                return st
            except self.catch as e:
                st.crashes += 1
                st.errors.append(repr(e))
                prev_crash_offset = runner._reader_position()
                if self.sampler is not None:
                    self.sampler.annotate(
                        "crash", attempt=st.attempts, error=repr(e),
                        crash_offset=prev_crash_offset)
                if self.flightrec is not None:
                    self.flightrec.record(
                        "supervisor", event="crash",
                        attempt=st.attempts, error=repr(e),
                        crash_offset=prev_crash_offset)
                # DURABLE progress only: the checkpoint the next attempt
                # will resume from.  Work a crashed attempt did but never
                # snapshotted is not progress — counting it would let a
                # crash-before-first-checkpoint loop restart forever
                # while recovering nothing.
                progress = self._durable_progress(runner)
                if (last_durable_progress is not None
                        and progress <= last_durable_progress):
                    no_progress += 1
                else:
                    no_progress = 0
                last_durable_progress = progress
                if no_progress >= self.max_no_progress_restarts:
                    st.gave_up = True
                    if self.sampler is not None:
                        self.sampler.annotate(
                            "give_up", attempts=st.attempts,
                            crashes=st.crashes, no_progress=no_progress)
                    if self.flightrec is not None:
                        self.flightrec.dump("give_up", terminal={
                            "kind": "fault", "event": "give_up",
                            "error": st.errors[-1] if st.errors else None,
                            "attempts": st.attempts,
                            "crashes": st.crashes,
                            "no_progress": no_progress,
                            "durable_progress": progress})
                    return st
                consecutive_crashes += 1
                back = self._backoff(consecutive_crashes)
                st.backoff_ms_total += back
                st.restarts += 1
                self.counters.inc("restarts")
                if self.sampler is not None:
                    self.sampler.annotate(
                        "restart", restarts=st.restarts,
                        backoff_ms=round(back, 1),
                        durable_progress=progress)
                if self.flightrec is not None:
                    self.flightrec.record(
                        "supervisor", event="restart",
                        restarts=st.restarts, backoff_ms=round(back, 1),
                        durable_progress=progress)
                if back > 0:
                    self._sleep(back / 1000.0)
