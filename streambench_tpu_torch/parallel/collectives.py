"""Collective-cost accounting of the sharded fold, counted as it is issued.

The port of ``streambench_tpu/parallel/collectives.py``.  The JAX package
parses the optimized HLO of a compiled step and reports every collective
in it; PyTorch runs eagerly and has no program to parse, so here every
collective the fold issues goes through one of the wrappers below,
which issue it and, when the caller hands them a :class:`Recorder`,
record it.  ``report_for`` runs one real dispatch under a recorder and
returns the reference's schema.

Accounting model, the reference's (``collectives.py:12-25`` there):

- **payload bytes** = byte size of the op's output (the reach query's
  merges are int64, the dtype of the port's signature plane, where the
  reference's are uint32).  This is the data a
  collective makes every participant agree on, not a link-level model;
  ``group_size`` is recorded per op so a reader can apply the wire model
  of their fabric.
- **per_dispatch** = every op the dispatch issued.  Ops issued inside a
  scan body (``in_loop``) ran once per folded batch; ``per_loop_iteration``
  is their count over ``scan_len``.

The gather is a real all-gather here (the reference's is a ``psum`` of a
zero-padded buffer, which XLA reports as an all-reduce); both make every
rank hold the ``[B]`` column, and the bytes are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

COLLECTIVE_KINDS = ("all-reduce", "all-gather")


class CollectiveOp(NamedTuple):
    """One collective the fold issued."""

    kind: str            # "all-gather" or "all-reduce"
    name: str            # what it carries, e.g. "packed" or "counted"
    payload_bytes: int   # output bytes (see module docstring)
    group_size: int      # ranks in its group
    in_loop: bool        # issued inside a scan body


class Recorder:
    """The collectives of the dispatches run while it is handed to the
    fold.  ``timed=True`` also brackets each one with CUDA events, read
    by ``device_ms`` once the card has finished them."""

    def __init__(self, timed: bool = False):
        self.ops: list[CollectiveOp] = []
        self.timed = timed
        self._events: list = []

    def issue(self, op: CollectiveOp, call) -> None:
        if self.timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            self._events.append((start, end))
        else:
            call()
        self.ops.append(op)

    def device_ms(self) -> list[float]:
        """Each recorded op's device time (timed recorders only); waits
        for the card."""
        for _, end in self._events:
            end.synchronize()
        return [start.elapsed_time(end) for start, end in self._events]


def _issue(recorder: Recorder | None, kind: str, name: str,
           out: torch.Tensor, group, in_loop: bool, call) -> None:
    if recorder is None:
        call()
        return
    recorder.issue(CollectiveOp(kind, name, out.numel() * out.element_size(),
                                dist.get_world_size(group), in_loop), call)


def all_gather_last(x: torch.Tensor, group, recorder: Recorder | None = None,
                    *, name: str, in_loop: bool = False) -> torch.Tensor:
    """All-gather ``x`` over ``group`` along its LAST axis, in rank order,
    as int32: a ``[b]`` column gives ``[n*b]``, a ``[K, b]`` stack
    ``[K, n*b]`` (one collective for a whole dispatch).  A ``bool`` column
    travels as int32, as the reference gathers it.

    ``dist.all_gather`` into views of one output tensor: the call every
    supported PyTorch has without a deprecation (``all_gather_into_tensor``
    warns on newer releases, ``all_gather_single`` is missing on older)."""
    n = dist.get_world_size(group)
    x32 = x.to(torch.int32).contiguous()
    out = x32.new_empty((n,) + tuple(x32.shape))
    _issue(recorder, "all-gather", name, out, group, in_loop,
           lambda: dist.all_gather(list(out.unbind(0)), x32, group=group))
    return out.movedim(0, -2).reshape(tuple(x.shape[:-1])
                                      + (n * x.shape[-1],))


def all_reduce_sum(x: torch.Tensor, group, recorder: Recorder | None = None,
                   *, name: str, in_loop: bool = False) -> torch.Tensor:
    """Sum the int32 tensor ``x`` (a scalar, or a stack such as the
    session fold's ``[K, 2, D, Wd]`` sketch deltas) over ``group``;
    returns a new tensor of ``x``'s shape."""
    buf = x.reshape(-1).to(torch.int32).clone()
    _issue(recorder, "all-reduce", name, buf, group, in_loop,
           lambda: dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group))
    return buf.reshape(x.shape)


_EXTREMES = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def all_reduce_extreme(x: torch.Tensor, group,
                       recorder: Recorder | None = None, *, op: str,
                       name: str, in_loop: bool = False) -> torch.Tensor:
    """The elementwise ``op`` ("min" or "max") of ``x`` over ``group``, in
    ``x``'s own dtype (the sharded reach query's int64 planes); returns a
    new tensor."""
    buf = x.contiguous().clone()
    _issue(recorder, "all-reduce", name, buf, group, in_loop,
           lambda: dist.all_reduce(buf, op=_EXTREMES[op], group=group))
    return buf


def summarize(ops: list[CollectiveOp], scan_len: int = 1,
              column_bytes_min: int = 64) -> dict:
    """Aggregate recorded ops into the per-dispatch view artifacts cite.

    ``column_bytes`` restricts the byte total to ops whose payload is at
    least ``column_bytes_min``: the gathered batch columns, excluding
    the scalar drop-counter sums (4 B), because the wire-packing claim is
    about column traffic."""

    def _agg(sel, div: int = 1):
        by_kind: dict[str, int] = {}
        total_ops = total_bytes = col_ops = col_bytes = 0
        for op in ops:
            if not sel(op):
                continue
            total_ops += 1
            total_bytes += op.payload_bytes
            if op.payload_bytes >= column_bytes_min:
                col_ops += 1
                col_bytes += op.payload_bytes
            by_kind[op.kind] = by_kind.get(op.kind, 0) + 1
        if any(v % div for v in (total_ops, total_bytes, col_ops,
                                 col_bytes, *by_kind.values())):
            raise ValueError(f"loop-body collectives are not a multiple of "
                             f"scan_len={div}: {ops}")
        return {"ops": total_ops // div, "bytes": total_bytes // div,
                "column_ops": col_ops // div,
                "column_bytes": col_bytes // div,
                "by_kind": {k: v // div for k, v in by_kind.items()}}

    return {
        "scan_len": scan_len,
        "top_level": _agg(lambda op: not op.in_loop),
        "per_loop_iteration": _agg(lambda op: op.in_loop, scan_len),
        "per_dispatch": _agg(lambda op: True),
        "ops": [op._asdict() for op in ops],
    }


def publish_gauges(registry, report: dict) -> None:
    """Mirror an engine ``collective_report`` onto obs gauges:
    ``streambench_collective_{ops,bytes}{kernel="step"|"scan"|"query"}``
    (``query``: the sharded reach engine's)."""
    for kernel in ("step", "scan", "query"):
        r = report.get(kernel)
        if not isinstance(r, dict):
            continue
        registry.gauge("streambench_collective_ops",
                       "collective ops per device dispatch",
                       labels={"kernel": kernel}
                       ).set(r["per_dispatch"]["ops"])
        registry.gauge("streambench_collective_bytes",
                       "collective payload bytes per device dispatch",
                       labels={"kernel": kernel}
                       ).set(r["per_dispatch"]["bytes"])


def report_for(dispatch, scan_len: int = 1, column_bytes_min: int = 64,
               timed: bool = False) -> dict:
    """``summarize`` of what ``dispatch(recorder)`` issues: one real
    dispatch, run now.  The op list is dropped from the result (the
    per-op detail is for tests).  ``timed`` adds ``device_ms``, the sum
    of the ops' device times, and ``device_ms_by_kind``."""
    rec = Recorder(timed=timed)
    dispatch(rec)
    out = summarize(rec.ops, scan_len=scan_len,
                    column_bytes_min=column_bytes_min)
    out.pop("ops")
    if timed:
        ms = rec.device_ms()
        by_kind: dict[str, float] = {}
        for op, t in zip(rec.ops, ms):
            by_kind[op.kind] = by_kind.get(op.kind, 0.0) + t
        out["device_ms"] = sum(ms)
        out["device_ms_by_kind"] = by_kind
    return out
