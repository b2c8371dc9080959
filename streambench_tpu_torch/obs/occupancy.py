"""Measured device occupancy + kernel-build detection.

The port of ``streambench_tpu/obs/occupancy.py``.  CUDA launches return
before the card finishes, so nothing on the default path observes device
completion; this module measures how busy the card is by *sampling*:
after one dispatch in ``sample_every`` it records a CUDA event on the
stream that ran the dispatch and times ``event.synchronize()``.  Every
other dispatch stays asynchronous (at the default 1/32 the wait is
amortized to noise).  It never calls ``torch.cuda.synchronize()``: that
would also wait for work on other streams, and the ratio is about the
engine's stream.  The parked device-to-host pulls of the drains ride the
same stream, so a sample waits for any still queued before it, as the
reference's ``block_until_ready`` waits for every program enqueued
before the dispatch.

The accumulated sampled wait, extrapolated by the sampling factor and
divided by wall time, is ``device_busy_ratio``, with its bias stated.
The wait covers only what the card still has to do once the host has
returned from the dispatch.  On CUDA an eager dispatch's launches (~25
a step) run on the card while the host is still issuing them, and the
step's two pageable host-to-device copies make the host wait for the
work queued before them, so the wait sees the tail of the dispatch:
each sample is close to a LOWER bound on the card's busy time, and the
ratio reads as "fraction of wall time the host waited on the card
after a dispatch".  The busy share itself comes from a profiler
window's device events (``obs.capture``).  On a CPU engine every op
completes inside the dispatch: a sample waits for nothing and the ratio
is that of a host with no queue.  The sample is a deliberate synchronisation, so a run
under ``torch.cuda.set_sync_debug_mode("error")`` keeps occupancy off.

Per-dispatch sampled times land in a ``streambench_device_dispatch_ms``
histogram (a slow dispatch behind a backed-up queue is a different
disease than a uniformly slow kernel).

The build detector: the port compiles nothing per shape; its only
"compile at first use" is the kernel and host libraries that
``utils/build.py`` builds with ``nvcc``/``g++``.  :class:`CompileWatcher`
counts those builds into ``streambench_compiles_total``, and after
``mark_steady()`` (called once warmup has built and run every path) into
``streambench_compiles_steady_total``, whose value in a warmed run must
be zero.

Default-off like the rest of obs/: the engine carries a ``None``
attribute and one None check per dispatch until ``attach_obs(...,
occupancy=OccupancySampler(...))``.
"""

from __future__ import annotations

import threading
import time

from streambench_tpu_torch.utils import build


class CompileWatcher:
    """Counts kernel-library builds; ``mark_steady`` starts the
    steady-state counter whose invariant value is zero."""

    def __init__(self, registry=None):
        # the builds are this process's own code: always observable
        self.supported = True
        self.compiles = 0
        self.compile_s = 0.0
        self.steady_compiles = 0
        self._steady = False
        self._lock = threading.Lock()
        self._c_total = self._c_steady = None
        if registry is not None:
            self._c_total = registry.counter(
                "streambench_compiles_total",
                "kernel-library builds (nvcc/g++) observed in this process")
            self._c_steady = registry.counter(
                "streambench_compiles_steady_total",
                "library builds AFTER mark_steady (warmup) — the "
                "steady-state invariant value is zero")
        build.add_build_listener(self._on_compile)

    def _on_compile(self, name: str, duration_secs: float) -> None:
        with self._lock:
            self.compiles += 1
            self.compile_s += duration_secs
            steady = self._steady
            if steady:
                self.steady_compiles += 1
        if self._c_total is not None:
            self._c_total.inc()
            if steady:
                self._c_steady.inc()

    def mark_steady(self) -> None:
        """Everything is built now (post-warmup); any build from here on
        is a mid-run stall worth flagging."""
        with self._lock:
            self._steady = True

    def summary(self) -> dict:
        with self._lock:
            return {"supported": self.supported,
                    "compiles_total": self.compiles,
                    "compile_s": round(self.compile_s, 3),
                    "compiles_steady": self.steady_compiles}

    def close(self) -> None:
        build.remove_build_listener(self._on_compile)


class OccupancySampler:
    """Sampled event-timed dispatches -> busy ratio.

    The engine calls ``note_dispatch(state)`` after every device dispatch
    (one None check + one counter increment off-sample); one dispatch in
    ``sample_every`` waits on a CUDA event recorded after it and times
    the wait.  ``sample_every=1`` times every dispatch; the default 32
    keeps the hot path asynchronous.
    """

    def __init__(self, registry=None, sample_every: int = 32,
                 watch_compiles: bool = True):
        self.sample_every = max(int(sample_every), 1)
        self.dispatches = 0
        self.sampled = 0
        self.busy_ns = 0
        # Optional ``fn(start_ns, end_ns)`` fed every sampled busy
        # window (obs.queryattr.QueryLifecycle.note_ingest_busy): the
        # reach contention ratio's production evidence — an async
        # dispatch span cannot cover device time, a sampled CUDA-event
        # wait does.
        self.busy_sink = None
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._hist = self._g_ratio = None
        self._c_disp = self._c_sampled = None
        if registry is not None:
            self._hist = registry.histogram(
                "streambench_device_dispatch_ms",
                "sampled dispatch-to-completion device time (ms)",
                lo=0.001, hi=1e5)
            self._g_ratio = registry.gauge(
                "streambench_device_busy_ratio",
                "measured device-busy / wall-time ratio (sampled CUDA "
                "event waits extrapolated by the sampling factor)")
            self._c_disp = registry.counter(
                "streambench_device_dispatches_total",
                "device dispatches seen by the occupancy sampler")
            self._c_sampled = registry.counter(
                "streambench_device_sampled_dispatches_total",
                "dispatches timed to completion (1/N sampling)")
        self.compile_watcher = (CompileWatcher(registry)
                                if watch_compiles else None)

    # ------------------------------------------------------------------
    def note_dispatch(self, state) -> None:
        """One device dispatch just happened; sample 1-in-N to
        completion.  Host-loop thread only (the counter is unlocked by
        design — the single-writer rule the ingest counters also use)."""
        self.dispatches += 1
        if self._c_disp is not None:
            self._c_disp.set_total(self.dispatches)
        if self.dispatches % self.sample_every:
            return
        # any tensor of the engine's state names its device (the exact
        # engine's counts, the reach engine's mins, ...)
        plane = next((v for v in state if getattr(v, "is_cuda", False)),
                     None)
        t0 = time.perf_counter_ns()
        if plane is not None:
            import torch

            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(plane.device))
            done.synchronize()
        dt = time.perf_counter_ns() - t0
        if self.busy_sink is not None:
            try:
                self.busy_sink(t0, t0 + dt)
            except Exception:
                pass   # a broken sink must not kill the hot path
        with self._lock:
            self.sampled += 1
            self.busy_ns += dt
        if self._hist is not None:
            self._hist.observe(dt / 1e6)
            self._c_sampled.set_total(self.sampled)
            self._g_ratio.set(self.busy_ratio())

    def mark_steady(self) -> None:
        if self.compile_watcher is not None:
            self.compile_watcher.mark_steady()

    # ------------------------------------------------------------------
    def wall_ms(self) -> float:
        return (time.monotonic() - self._t0) * 1e3

    def busy_ratio(self) -> float:
        """Extrapolated device-busy / wall ratio (0.0 before the first
        sample)."""
        wall = self.wall_ms()
        if wall <= 0:
            return 0.0
        with self._lock:
            busy_ms = self.busy_ns / 1e6 * self.sample_every
        return busy_ms / wall

    def summary(self) -> dict:
        """The ``"occupancy"`` block a metrics.jsonl snapshot carries."""
        with self._lock:
            sampled = self.sampled
            busy_ms = round(self.busy_ns / 1e6, 3)
        out = {
            "dispatches": self.dispatches,
            "sampled": sampled,
            "sample_every": self.sample_every,
            "device_busy_ms_sampled": busy_ms,
            "wall_ms": round(self.wall_ms(), 1),
            "device_busy_ratio": round(self.busy_ratio(), 4),
        }
        if self._hist is not None and self._hist.count:
            out["dispatch_ms"] = self._hist.summary()
        if self.compile_watcher is not None:
            out["compiles"] = self.compile_watcher.summary()
        return out

    def close(self) -> None:
        if self.compile_watcher is not None:
            self.compile_watcher.close()
