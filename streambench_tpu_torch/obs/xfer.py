"""Host->device transfer ledger.

The port of ``streambench_tpu/obs/xfer.py``.

- :class:`TransferLedger` — hooked at the engine's ``_fold`` /
  ``_fold_group`` dispatch points, beside the ``OccupancySampler``:
  every dispatch's host->device payload is accounted EXACTLY (bytes
  computed from the dispatched numpy buffers' dtypes and shapes), keyed
  by wire format — ``packed`` (the int32 wire word + the int32 time,
  8 B per shipped row), ``unpacked`` (the separate columns; ``valid``
  ships as 1-byte bools, so 13 B per row).  The bytes are those of the
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

The reference's ``ShardSkew`` (per-shard routed rows) comes with the
sharded engines; ``--sharded`` is refused.

Default-off like the rest of obs/: the engine carries a ``None``
attribute and one None check per dispatch until
``attach_obs(..., xfer=TransferLedger(...))``.
"""

from __future__ import annotations


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
    KNOWN_FORMATS = ("packed", "unpacked")

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
