"""Device-memory ledger: kernel launch footprints + live-block census.

The port of ``streambench_tpu/obs/devmem.py``.  Two signals, both off
the hot path, under the reference's metric names:

- **per-kernel footprints** — the reference asks XLA for each compiled
  program's ``memory_analysis``.  The port's device programs are eager
  torch ops around one hand-written kernel, K1 (``ops/count.py``), whose
  launch plan is pure Python: :meth:`DeviceMemoryLedger.analyze_engine`
  records, for every kernel the engine launches (its ``_devmem_kernels``
  hook), the plan's tier, grid (``blocks`` x ``threads``), dynamic
  shared memory per block (``smem_bytes``) and argument bytes.  Field by
  field against XLA's analysis: ``argument_bytes`` are the three
  ``[B]`` row columns the launch reads plus the plan struct;
  ``output_bytes`` the ``[C, W]`` counts plane it adds into (the
  sliding engine's sliced fold: its ``[C*S, W]`` bucket plane), IN PLACE,
  so ``alias_bytes`` equals it; ``temp_bytes`` is 0, as shared memory
  is on-chip and the kernel allocates nothing in device memory; and
  ``code_bytes`` has no counterpart (the kernel's code lives in its
  library, not in a per-shape executable), so it is absent.  The
  per-engine **peak-footprint estimate** is the reference's: persistent
  state bytes + the largest single kernel's (argument + output + temp).
  A CPU engine launches no kernel (its count is the plain version), so
  its kernel table is empty; so is the HLL engine's, on any device.

- **live-block census** — the reference walks ``jax.live_arrays()``;
  the port reads the CUDA caching allocator: the active blocks of
  ``torch.cuda.memory_snapshot()`` (count + bytes, bucketed by
  power-of-two size like ``live_array_census``) and, from
  ``torch.cuda.memory_stats()``, the allocated, peak-allocated and
  reserved bytes.  Only the host loop's thread touches torch, so the
  census is refreshed by :meth:`DeviceMemoryLedger.poll` on that thread
  (every ``census_every`` calls; the runner calls it at each flush) and
  the sampler's :meth:`collect` journals the newest one.  On a CPU
  engine there is no device allocator: the census says so.

Default-off: nothing here is constructed unless ``jax.obs.devmem`` asks
for it.
"""

from __future__ import annotations

import time


def state_nbytes(state) -> int:
    """Bytes of the tensors in an engine's persistent state (a tuple of
    tensors, nested tuples and lists included)."""
    import torch

    total = 0
    stack = [state]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    return total


def live_block_census(device, buckets: int = 24) -> dict:
    """One walk of the caching allocator of CUDA ``device``: active
    blocks' count + bytes, bucketed by power-of-two block size (bucket
    label = upper bound in bytes), and the allocator's byte totals."""
    import torch

    if device is None or device.type != "cuda":
        return {"supported": False,
                "error": f"no CUDA allocator on device {device}"}
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    count = 0
    total = 0
    by_bucket: dict[str, list] = {}
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device", index) != index:
            continue
        for blk in seg.get("blocks", ()):
            if blk.get("state") != "active_allocated":
                continue
            nb = int(blk.get("requested_size") or blk.get("size") or 0)
            count += 1
            total += nb
            b = 1
            while b < nb:
                b <<= 1
            slot = by_bucket.setdefault(str(b), [0, 0])
            slot[0] += 1
            slot[1] += nb
    stats = torch.cuda.memory_stats(index)
    top = sorted(by_bucket.items(), key=lambda kv: -kv[1][1])[:buckets]
    return {
        "supported": True,
        "count": count,
        "bytes": total,
        "buckets": {k: {"count": c, "bytes": nb} for k, (c, nb) in top},
        "allocated_bytes": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_allocated_bytes": int(
            stats.get("allocated_bytes.all.peak", 0)),
        "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0)),
    }


class DeviceMemoryLedger:
    """Aggregates kernel footprints + the live-block census.

    ``analyze_engine(engine)`` runs once (post-warmup);
    ``poll()`` refreshes the census on the host loop's thread every
    ``census_every`` calls; ``collect(rec, dt_s)`` has the
    MetricsSampler collector signature and puts the ``"devmem"`` block
    on snapshot records.
    """

    def __init__(self, registry=None, census_every: int = 8):
        self.census_every = max(int(census_every), 1)
        self.kernels: dict[str, dict] = {}
        self.state_bytes = 0
        self.device = None
        self._polls = 0
        self._census: "dict | None" = None
        self._g_live = self._g_live_bytes = self._g_peak = None
        if registry is not None:
            self._g_live = registry.gauge(
                "streambench_devmem_live_arrays",
                "active caching-allocator blocks at the last census")
            self._g_live_bytes = registry.gauge(
                "streambench_devmem_live_bytes",
                "bytes of active caching-allocator blocks at the last "
                "census")
            self._g_peak = registry.gauge(
                "streambench_devmem_peak_footprint_bytes",
                "persistent state + largest kernel launch's "
                "argument+output+temp bytes")

    # ------------------------------------------------------------------
    def note_kernel(self, name: str, rep: dict) -> dict:
        """Record one kernel's footprint under ``name``."""
        self.kernels[name] = rep
        if self._g_peak is not None:
            self._g_peak.set(self.peak_footprint_bytes())
        return rep

    def analyze_engine(self, engine) -> dict:
        """Record every kernel ``engine`` launches (its
        ``_devmem_kernels()`` hook) and the persistent state footprint."""
        self.device = engine.device
        # the sliding engine's t-digest lives beside its window state
        self.state_bytes = state_nbytes(
            (engine.state, getattr(engine, "digest", ())))
        for name, rep in engine._devmem_kernels():
            self.note_kernel(name, rep)
        if self._g_peak is not None:
            self._g_peak.set(self.peak_footprint_bytes())
        return self.summary(census=False)

    def peak_footprint_bytes(self) -> int:
        """Persistent state + the largest single kernel working set —
        the per-engine peak-footprint ESTIMATE (the torch ops around the
        kernel allocate their own temporaries beside it; the census's
        ``peak_allocated_bytes`` is the measured peak)."""
        worst = max((k.get("total_bytes", 0)
                     for k in self.kernels.values()
                     if k.get("supported")), default=0)
        return self.state_bytes + worst

    # ------------------------------------------------------------------
    def refresh_census(self) -> "dict | None":
        """Walk the allocator now (host loop's thread); the walk's own
        time rides the census as ``census_ms``."""
        t0 = time.perf_counter()
        census = live_block_census(self.device)
        census["census_ms"] = (time.perf_counter() - t0) * 1e3
        self._census = census
        if self._g_live is not None and self._census.get("supported"):
            self._g_live.set(self._census["count"])
            self._g_live_bytes.set(self._census["bytes"])
        return self._census

    def poll(self) -> None:
        """The host loop's tick: refresh the census every
        ``census_every`` calls."""
        if self._polls % self.census_every == 0:
            self.refresh_census()
        self._polls += 1

    def collect(self, rec: dict, dt_s: float) -> None:
        """MetricsSampler collector: ``rec["devmem"]`` every tick, with
        the newest census."""
        rec["devmem"] = self.summary()

    def summary(self, census: bool = True) -> dict:
        out: dict = {
            "state_bytes": self.state_bytes,
            "peak_footprint_bytes": self.peak_footprint_bytes(),
            "kernels": self.kernels,
        }
        if census and self._census is not None:
            out["live"] = self._census
        return out
