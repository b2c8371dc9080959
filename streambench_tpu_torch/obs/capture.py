"""Bounded triggered profiler capture: deep evidence when a run goes bad.

The port of ``streambench_tpu/obs/capture.py``, on ``torch.profiler``:

- :class:`CaptureManager` records a short ``torch.profiler`` window
  (``window_s``) into ``<workdir>/xprof_<ms>_<reason>/trace.json`` (a
  Chrome trace: the host loop's torch ops and, on a CUDA engine, the
  card's kernels and copies, K1 included) when an SLO breach transitions
  on (``obs/slo.py``), on SIGUSR2, or as a config one-shot.  A cooldown
  and a max-capture cap bound the disk and profiler overhead however
  often the trigger fires; suppressed triggers are counted, never
  silent.  Every capture is recorded in the flight recorder and the
  metrics journal, and the capture dirs ride the RunStats close line.

  ``torch.profiler`` records the torch ops of the thread that starts it,
  and only the host loop's thread touches torch, so ``trigger`` (safe
  from any thread: the sampler's SLO collector, a signal handler) only
  claims the capture; the host loop starts and stops the profiler in
  :meth:`CaptureManager.poll`, which the runner calls at each flush
  (1 Hz), so a window lasts ``window_s`` rounded up to the next flush.
  The profiler's first start in a process initialises its device
  tracing, which can hold the host loop for seconds; :meth:`warm` pays
  that once before the stream starts.  Each capture records how long
  its start (``start_s``) and its stop with the trace's export
  (``stop_s``) held the host loop.

- :func:`profiler_window` is the ONE low-level start/stop path.  The
  profiler is process-wide (a second concurrent start fails), so
  every profiler user — this manager AND ``trace.device_trace`` — goes
  through the same lock; a capture requested while another is active
  is counted as suppressed instead of crashing the run.  A profiler
  that fails to start or stop raises: no capture silently drops the
  device.

Default-off (``jax.obs.capture.enabled``): nothing is constructed, no
signal handler installed, the hot path unchanged.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

from streambench_tpu_torch.utils.ids import now_ms

TRACE_FILE = "trace.json"

# process-wide profiler ownership: one active profile; all start/stop
# goes through this lock + slot.
_profiler_lock = threading.Lock()
_active: "tuple[str, object] | None" = None


def _activities(device) -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def _begin(logdir: str, device) -> bool:
    """Start a profile recording into ``logdir`` unless one is
    active (False).  Raises when the profiler fails to start."""
    global _active
    from torch.profiler import profile

    with _profiler_lock:
        if _active is not None:
            return False
        prof = profile(activities=_activities(device))
        prof.start()
        _active = (logdir, prof)
        return True


def _end(logdir: str) -> None:
    """Stop the profile ``_begin(logdir)`` started and write its Chrome
    trace to ``<logdir>/trace.json``."""
    global _active
    with _profiler_lock:
        if _active is None or _active[0] != logdir:
            return
        prof = _active[1]
        _active = None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def profiler_window(logdir: "str | None", device=None):
    """Scoped profiler trace under ``logdir`` (no-op if None or if the
    profiler is already owned by a triggered capture).  The single
    start/stop path — ``trace.device_trace`` delegates here."""
    if not logdir:
        yield
        return
    started = _begin(logdir, device)
    try:
        yield
    finally:
        if started:
            _end(logdir)


class CaptureManager:
    """Trigger-driven bounded profiler captures.

    ``trigger(reason)`` is safe from any thread: under the policy lock it
    checks the cap, the cooldown and whether a capture is pending or
    active, and claims one.  ``poll()`` — host loop's thread only —
    starts a claimed capture and stops one whose ``window_s`` is over.
    """

    def __init__(self, workdir: str, *, cooldown_s: float = 60.0,
                 max_captures: int = 3, window_s: float = 3.0,
                 registry=None, flightrec=None, annotate=None,
                 device=None, clock=time.monotonic):
        self.workdir = workdir
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self.max_captures = max(int(max_captures), 1)
        self.window_s = max(float(window_s), 0.1)
        self.flightrec = flightrec
        self.annotate = annotate          # sampler.annotate or None
        self.device = device
        self._clock = clock
        self._lock = threading.Lock()
        self._last_end: "float | None" = None
        self._pending: "str | None" = None    # claimed, not started
        self._current: "str | None" = None    # started
        self._started_at = 0.0
        self.warm_s: "float | None" = None
        self.captures: list[dict] = []
        self.suppressed = 0
        self._c_caps = self._c_supp = None
        if registry is not None:
            self._c_caps = registry.counter(
                "streambench_captures_total",
                "triggered profiler captures started")
            self._c_supp = registry.counter(
                "streambench_captures_suppressed_total",
                "capture triggers suppressed by cooldown/cap/busy")

    # ------------------------------------------------------------------
    def _suppress(self) -> None:
        self.suppressed += 1
        if self._c_supp is not None:
            self._c_supp.inc()

    def trigger(self, reason: str) -> "str | None":
        """Claim a capture; returns its directory, or None when
        suppressed (cap reached, cooling down, or one pending/active).
        The host loop's next ``poll`` starts it."""
        with self._lock:
            now = self._clock()
            if (self._pending is not None or self._current is not None
                    or len(self.captures) >= self.max_captures
                    or (self._last_end is not None
                        and now - self._last_end < self.cooldown_s)):
                self._suppress()
                return None
            logdir = os.path.join(
                self.workdir, f"xprof_{now_ms()}_{reason}")
            self._pending = logdir
            rec = {"dir": logdir, "reason": reason, "ts_ms": now_ms(),
                   "window_s": self.window_s}
            self.captures.append(rec)
        if self.flightrec is not None:
            self.flightrec.record("profiler_capture", dir=logdir,
                                  reason=reason)
        if self.annotate is not None:
            try:
                self.annotate("profiler_capture", dir=logdir,
                              reason=reason)
            except Exception:
                pass   # a closing sampler must not kill the trigger
        return logdir

    def warm(self) -> None:
        """Start and stop one profile now, recording nothing
        (host loop's thread, before the stream): the first start in a
        process initialises the profiler's device tracing."""
        from torch.profiler import profile

        t0 = time.perf_counter()
        with _profiler_lock:
            if _active is not None:
                return
            prof = profile(activities=_activities(self.device))
            prof.start()
            prof.stop()
        self.warm_s = time.perf_counter() - t0

    def _note(self, logdir: str, **fields) -> None:
        with self._lock:
            for c in self.captures:
                if c["dir"] == logdir:
                    c.update(fields)

    def poll(self) -> None:
        """Host loop's tick: start a claimed capture, stop one whose
        window is over.  A profiler another user holds (``--traceDir``)
        turns a claimed capture into a suppressed one."""
        if self._pending is None and self._current is None:
            return
        with self._lock:
            pending, current = self._pending, self._current
            self._pending = None
        if pending is not None:
            t0 = time.perf_counter()
            if _begin(pending, self.device):
                self._note(pending, start_s=time.perf_counter() - t0)
                with self._lock:
                    self._current = pending
                    self._started_at = self._clock()
                if self._c_caps is not None:
                    self._c_caps.inc()
            else:
                with self._lock:
                    self.captures = [c for c in self.captures
                                     if c["dir"] != pending]
                    self._suppress()
            return
        if current is not None and \
                self._clock() - self._started_at >= self.window_s:
            self._finish(current)

    def _finish(self, logdir: str) -> None:
        t0 = time.perf_counter()
        _end(logdir)
        self._note(logdir, stop_s=time.perf_counter() - t0)
        with self._lock:
            if self._current == logdir:
                self._current = None
                self._last_end = self._clock()

    # ------------------------------------------------------------------
    @property
    def active(self) -> "str | None":
        with self._lock:
            return self._current

    def close(self) -> None:
        """Stop any in-flight capture NOW (host loop's thread; the run is
        ending and a dangling profiler would drop its trace) and forget
        one claimed but never started."""
        with self._lock:
            current, pending = self._current, self._pending
            self._pending = None
            if pending is not None:
                self.captures = [c for c in self.captures
                                 if c["dir"] != pending]
        if current is not None:
            self._finish(current)

    def summary(self) -> dict:
        """The ``"capture"`` block for the RunStats close line."""
        with self._lock:
            return {
                "captures": [dict(c) for c in self.captures],
                "suppressed": self.suppressed,
                "warm_s": self.warm_s,
                "cooldown_s": self.cooldown_s,
                "max_captures": self.max_captures,
                "window_s": self.window_s,
            }
