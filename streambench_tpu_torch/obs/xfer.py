"""Host->device transfer ledger.

The port of ``streambench_tpu/obs/xfer.py``.

- :class:`TransferLedger` — hooked at the engine's ``_fold`` /
  ``_fold_group`` dispatch points, beside the ``OccupancySampler``:
  every dispatch's host->device payload is accounted EXACTLY (bytes
  computed from the dispatched numpy buffers' dtypes and shapes), keyed
  by wire format — ``packed`` (the int32 wire word + the int32 time,
  8 B per shipped row; 12 B on the HLL engine's scans, whose int32 user
  ids ride between them; the sketch engines' single-batch steps ship
  ``unpacked``), ``unpacked`` (the separate columns; ``valid``
  ships as 1-byte bools, so 13 B per row), ``devdecode`` (the raw-bytes
  format of device decode: each journal block's padded byte buffer, once,
  plus the int32 start and length of every row).  The bytes are those of the
  buffers the port ships; the JAX engine pads a partial scan group to a
  power of two with empty batches and the port does not, so the two
  ledgers agree wherever no group is padded (every step, every full
  group).  Each format block also counts the ``rows`` shipped, so
  ``bytes_per_row`` gives the wire width whatever the batches' fill.

  One dispatch in ``sample_every`` also TIMES a copy of the same host
  buffers to the card, made as the engine makes its own (``torch``
  tensors from the numpy buffers, copied to the device from pageable
  memory), between two CUDA events on the current stream.  The recorded
  ``streambench_xfer_ms`` is the device-side span of those copies.  A
  CPU engine ships nothing to a device: its dispatches are accounted,
  none is timed.

Two byte accountings per format:

- ``wire_bytes`` / ``bytes_per_event`` — the exact bytes of the
  dispatched host buffers (what the PCIe link moves).
- ``col_bytes`` / ``col_bytes_per_event`` — the same columns normalized
  to the kernel's int32 width (4 B per column element), the basis on
  which ``packed_unpacked_ratio`` is exactly 0.5 for the exact engine.

- :class:`ShardSkew` — per-shard routed rows and drops of the sharded
  engine (``jax.obs.shard`` with ``--sharded``): the ``[S]`` vectors
  its fold's stats arm returns, summed on the device.

Default-off like the rest of obs/: the engine carries a ``None``
attribute and one None check per dispatch until
``attach_obs(..., xfer=TransferLedger(...))``.
"""

from __future__ import annotations

import threading

import numpy as np


class TransferLedger:
    """Exact per-dispatch host->device payload accounting by wire format.

    ``note_dispatch`` is called from the host loop only (single-writer
    ints, the same rule as the occupancy/ingest counters); ``summary``
    may be read from the sampler thread at any cadence (the per-format
    totals are plain ints, consistent under the GIL).

    ``sample_every``: one dispatch in N on a CUDA device pays a timed
    copy of the SAME host buffers — a redundant transfer of identical
    size, so ``streambench_xfer_ms`` isolates the transfer half of a
    dispatch without instrumenting the hot path.  0 disables timing
    (byte accounting only).
    """

    #: wire formats the engine can dispatch — pre-declared at
    #: construction so a scrape before the first dispatch already
    #: returns every per-format family with zero samples
    KNOWN_FORMATS = ("packed", "unpacked", "devdecode")

    def __init__(self, registry=None, sample_every: int = 32):
        self.sample_every = max(int(sample_every), 0)
        self.dispatches = 0
        self.sampled = 0
        self.sampled_ns = 0
        self.sampled_bytes = 0
        # fmt -> [dispatches, events, wire_bytes, col_bytes, rows]
        self._formats: dict[str, list] = {}
        self._reg = registry
        self._hist = None
        self._c_sampled = None
        self._per_fmt: dict[str, tuple] = {}
        if registry is not None:
            self._hist = registry.histogram(
                "streambench_xfer_ms",
                "sampled host->device transfer time per dispatch "
                "payload (pageable copies between CUDA events), ms",
                lo=0.001, hi=1e5)
            self._c_sampled = registry.counter(
                "streambench_xfer_sampled_total",
                "dispatch payloads whose transfer was timed (1/N)")
            for fmt in self.KNOWN_FORMATS:
                self._instruments(fmt)

    # ------------------------------------------------------------------
    def _instruments(self, fmt: str) -> tuple:
        inst = self._per_fmt.get(fmt)
        if inst is None and self._reg is not None:
            inst = (
                self._reg.counter(
                    "streambench_xfer_bytes_total",
                    "exact host->device payload bytes dispatched",
                    labels={"format": fmt}),
                self._reg.counter(
                    "streambench_xfer_col_bytes_total",
                    "payload bytes at kernel (int32) column width",
                    labels={"format": fmt}),
                self._reg.counter(
                    "streambench_xfer_events_total",
                    "parsed events carried by the dispatched payloads",
                    labels={"format": fmt}),
                self._reg.counter(
                    "streambench_xfer_dispatches_total",
                    "device dispatches seen by the transfer ledger",
                    labels={"format": fmt}),
                self._reg.gauge(
                    "streambench_xfer_bytes_per_event",
                    "derived wire bytes per parsed event",
                    labels={"format": fmt}),
            )
            self._per_fmt[fmt] = inst
        return inst

    def note_dispatch(self, fmt: str, events: int, wire_bytes: int,
                      col_bytes: "int | None" = None, rows: int = 0,
                      sample_arrays=None, device=None) -> None:
        """One device dispatch shipped ``wire_bytes`` of host buffers
        (``rows`` rows of the wire format) carrying ``events`` parsed
        events in wire format ``fmt``.  ``col_bytes`` defaults to
        ``wire_bytes``.  ``sample_arrays`` (the host numpy buffers of the
        payload) and a CUDA ``device`` enable the 1-in-N timed copy."""
        if col_bytes is None:
            col_bytes = wire_bytes
        self.dispatches += 1
        tot = self._formats.get(fmt)
        if tot is None:
            tot = self._formats[fmt] = [0, 0, 0, 0, 0]
        tot[0] += 1
        tot[1] += int(events)
        tot[2] += int(wire_bytes)
        tot[3] += int(col_bytes)
        tot[4] += int(rows)
        inst = self._instruments(fmt)
        if inst is not None:
            c_wire, c_col, c_ev, c_disp, g_bpe = inst
            c_wire.inc(int(wire_bytes))
            c_col.inc(int(col_bytes))
            c_ev.inc(int(events))
            c_disp.inc()
            if tot[1]:
                g_bpe.set(round(tot[2] / tot[1], 3))
        if (not self.sample_every or sample_arrays is None
                or device is None or device.type != "cuda"
                or self.dispatches % self.sample_every):
            return
        import torch

        arrays = list(sample_arrays)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        put = [torch.from_numpy(a).to(device) for a in arrays]
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        del put
        self.sampled += 1
        self.sampled_ns += int(ms * 1e6)
        self.sampled_bytes += sum(int(a.nbytes) for a in arrays)
        if self._hist is not None:
            self._hist.observe(ms)
            self._c_sampled.set_total(self.sampled)

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        """The ``"xfer"`` block a metrics.jsonl snapshot carries."""
        formats = {}
        for fmt, (disp, ev, wire, col, rows) in sorted(
                self._formats.items()):
            formats[fmt] = {
                "dispatches": disp,
                "events": ev,
                "wire_bytes": wire,
                "col_bytes": col,
                "bytes_per_event": round(wire / ev, 3) if ev else None,
                "col_bytes_per_event": (round(col / ev, 3)
                                        if ev else None),
                "rows": rows,
                "bytes_per_row": round(wire / rows, 3) if rows else None,
            }
        out: dict = {"dispatches": self.dispatches,
                     "sample_every": self.sample_every,
                     "formats": formats}
        pk, up = formats.get("packed"), formats.get("unpacked")
        if pk and up and up["col_bytes_per_event"]:
            out["packed_unpacked_ratio"] = round(
                pk["col_bytes_per_event"] / up["col_bytes_per_event"], 4)
            out["ratio_basis"] = "col_bytes"
        if self.sampled:
            ms = self.sampled_ns / 1e6
            out["sampled"] = self.sampled
            out["sampled_ms_total"] = round(ms, 3)
            out["sampled_bytes"] = self.sampled_bytes
            if ms > 0:
                # MB/s over the timed copies — the measured link rate
                out["xfer_mb_s"] = round(
                    self.sampled_bytes / 1e6 / (ms / 1e3), 2)
        if self._hist is not None and self._hist.count:
            out["xfer_ms"] = self._hist.summary()
        return out


def _host(x) -> np.ndarray:
    """A device vector (or a numpy one) as an int64 numpy array."""
    if hasattr(x, "cpu"):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


class ShardSkew:
    """Per-shard routed-row / drop accumulation for the sharded engine.

    ``note(wanted_vec, routed_vec)`` receives two replicated ``[S]``
    int32 DEVICE vectors from a stats-arm dispatch: rows whose campaign
    maps to each shard (before the lateness mask, the same basis as the
    global ``dropped``) and rows each shard actually counted.
    Accumulation is a device-side add (no sync on the hot path);
    ``summary()`` materializes the totals, so call it from the sampler
    thread or at close, never the host loop.

    ``note`` runs on the host loop only; ``summary`` snapshots the
    accumulator references under a lock, so a concurrent ``note`` never
    interleaves mid-read.
    """

    def __init__(self, registry=None, n_shards: int = 1):
        self.n_shards = max(int(n_shards), 1)
        self.dispatches = 0
        self._wanted = None      # device [S] running totals
        self._routed = None
        self._lock = threading.Lock()
        self._g_imb = None
        self._g_rows: list = []
        self._g_drop: list = []
        if registry is not None:
            self._g_imb = registry.gauge(
                "streambench_shard_imbalance_ratio",
                "max/mean routed rows across campaign shards "
                "(1.0 = perfectly balanced)")
            for s in range(self.n_shards):
                self._g_rows.append(registry.gauge(
                    "streambench_shard_rows",
                    "rows routed to (counted by) this campaign shard",
                    labels={"shard": str(s)}))
                self._g_drop.append(registry.gauge(
                    "streambench_shard_dropped",
                    "rows wanted by this shard's campaigns but not "
                    "counted (late / lost slot)",
                    labels={"shard": str(s)}))

    def note(self, wanted_vec, routed_vec) -> None:
        """Accumulate one dispatch's per-shard vectors (device add)."""
        with self._lock:
            self.dispatches += 1
            if self._wanted is None:
                self._wanted = wanted_vec
                self._routed = routed_vec
            else:
                self._wanted = self._wanted + wanted_vec
                self._routed = self._routed + routed_vec

    def summary(self) -> "dict | None":
        """Materialize the totals (a device sync: sampler or close
        cadence only) and set the gauges.  None until the first
        dispatch."""
        with self._lock:
            if self._routed is None:
                return None
            wanted_d, routed_d = self._wanted, self._routed
            dispatches = self.dispatches
        wanted = _host(wanted_d)
        routed = _host(routed_d)
        dropped = np.maximum(wanted - routed, 0)
        mean = routed.mean() if routed.size else 0.0
        imbalance = float(routed.max() / mean) if mean > 0 else 1.0
        for s, g in enumerate(self._g_rows):
            if s < routed.size:
                g.set(int(routed[s]))
        for s, g in enumerate(self._g_drop):
            if s < dropped.size:
                g.set(int(dropped[s]))
        if self._g_imb is not None:
            self._g_imb.set(round(imbalance, 4))
        return {
            "shards": int(routed.size),
            "dispatches": dispatches,
            "rows": routed.tolist(),
            "wanted": wanted.tolist(),
            "dropped": dropped.tolist(),
            "imbalance_ratio": round(imbalance, 4),
        }
