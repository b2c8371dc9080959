"""The single controller of the sharded engines: one rank drives, the rest follow.

JAX drives every device of a mesh from one program.  Here each device is
one process (a rank), so a sharded engine with more than one rank needs
a controller: rank 0 alone reads the stream and owns the writer, the
fence and the checkpoints, and it sends every device call to the other
ranks (``follow``) on the mesh's gloo group before making it, so all
ranks issue the same collectives in the same order.  A call that carries
batch columns sends each rank only its data slice, as the reference's
``shard_map`` takes the batch data-sharded (``P(DATA_AXIS)``); the fold's
gather assembles the batch on the card's own backend.  An engine whose
fold takes the batch replicated (the session engine, ``P()``) sends
every rank the whole batch.

``SingleController`` is the protocol and the dispatch every sharded
engine shares (``parallel.sharded.ShardedWindowEngine`` and the three
sketch engines of ``parallel.sketches``).  An engine mixes it in before
its single-device parent, calls ``_init_controller(mesh)`` and defines:

- ``_step_local(local, packed, *extra)`` and ``_scan_local(local,
  packed, *extra)``: one batch (``[b]`` columns) or one group (``[K, b]``
  stacks) of this rank's device columns; ``extra`` is what
  ``_fold_args()`` returned on rank 0 (the sketch engines' host clock);
- ``_do_<name>`` for each further device call it issues through
  ``_command(name, ...)``.

At world size 1 ``_command`` just makes the call.  Calls may come from
more than one thread of rank 0 (a query server's, the keepalive's): each
is made whole under one lock.  A follower waits for each call under the
mesh's timeout, and rank 0 may send none for longer (a long flush
interval, a long write), so ``keepalive`` starts a thread on rank 0 that
sends a no-op when no call went out for a second, until the close; and
``sync`` waits until every rank has run every call sent before it.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from streambench_tpu_torch.ops import windowcount as wc
from streambench_tpu_torch.parallel import collectives
from streambench_tpu_torch.parallel.mesh import CAMPAIGN_AXIS, DATA_AXIS


def clone_state(x):
    """A deep copy of a tensor, or of a (nested) tuple of them."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return type(x)(*(clone_state(v) for v in x)) if hasattr(
            x, "_fields") else tuple(clone_state(v) for v in x)
    return x


class SingleController:
    """The multi-rank protocol and the fold dispatch of a sharded engine
    (module doc)."""

    # Whether rank 0 sends each device call to the other ranks (the
    # single controller); the distributed engine's ranks each drive their
    # own partition in lockstep instead.
    COMMANDED = True
    # Whether the fold takes the batch data-sharded (each rank its slice,
    # gathered over the data group) or replicated (every rank the whole
    # batch).
    DATA_SHARDED = True
    # Device-state attributes a collective report's all-invalid dispatches
    # could still rewrite (a digest's re-compression): saved before the
    # report and put back after it.
    REPORT_RESTORES: tuple = ()

    def _init_controller(self, mesh) -> None:
        self.mesh = mesh
        self._leads = self.COMMANDED and mesh.size > 1 and mesh.rank == 0
        self._follows = self.COMMANDED and mesh.size > 1 and mesh.rank != 0
        # set while collective_report records a dispatch
        self._recorder: collectives.Recorder | None = None
        self._obs_reg = None
        # each call made whole: the host loop, a query server's thread
        # and the keepalive's may all command
        self._cmd_lock = threading.RLock()
        # when rank 0 last sent the other ranks a call; set to end the
        # keepalive thread
        self._sent_at = time.monotonic()
        self._keepalive_off: threading.Event | None = None

    # ------------------------------------------------------------------
    # the protocol
    def _command(self, name: str, *args, per_rank=None):
        """Run device call ``name`` here, first sending it to the other
        ranks when this rank leads them.  Every rank receives ``args``,
        or, with ``per_rank``, rank ``r`` receives ``per_rank(r)`` (its
        own data slice or shard)."""
        if self._follows:
            raise RuntimeError(f"rank {self.mesh.rank} follows rank 0: "
                               "call follow(), not the engine's entry "
                               "points")
        with self._cmd_lock:
            if per_rank is not None:
                args = per_rank(self.mesh.rank)
            if self._leads:
                dist.scatter_object_list(
                    [None], [(name, per_rank(r) if per_rank else args)
                             for r in range(self.mesh.size)],
                    src=0, group=self.mesh.host_group)
                self._sent_at = time.monotonic()
            return getattr(self, "_do_" + name)(*args)

    def keepalive(self, every_s: float = 1.0) -> None:
        """On rank 0 of a multi-rank engine, start a thread that sends the
        other ranks a no-op whenever no call went out for ``every_s``
        seconds, until the close: a follower's wait for its next call
        then never reaches the mesh's timeout while rank 0 lives.  A
        no-op elsewhere."""
        if not self._leads or self._keepalive_off is not None:
            return
        off = self._keepalive_off = threading.Event()

        def run() -> None:
            while not off.wait(every_s / 4):
                if time.monotonic() - self._sent_at < every_s:
                    continue
                with self._cmd_lock:
                    if off.is_set():
                        return
                    if time.monotonic() - self._sent_at >= every_s:
                        self._command("noop")

        threading.Thread(target=run, daemon=True, name="keepalive").start()

    def _do_noop(self) -> None:
        pass

    def sync(self) -> None:
        """A barrier on the host group, sent as a call so that it lands in
        the order of the calls: once it returns on rank 0, every rank has
        run every call sent before it."""
        self._command("barrier")

    def _do_barrier(self) -> None:
        dist.barrier(group=self.mesh.host_group)

    def follow(self) -> None:
        """Run the device calls rank 0 sends until it closes its engine
        (ranks other than 0 of a commanded engine).  A call that does not
        come within the mesh's timeout raises."""
        if not self._follows:
            raise RuntimeError("only ranks other than 0 of a multi-rank "
                               "sharded engine follow")
        while True:
            box = [None]
            dist.scatter_object_list(box, None, src=0,
                                     group=self.mesh.host_group)
            name, args = box[0]
            if name == "stop":
                return
            getattr(self, "_do_" + name)(*args)

    def _do_stop(self) -> None:
        pass

    def close(self) -> None:
        """The engine's close on rank 0, then the other ranks' ``follow``
        returns.  A following rank holds no host state (no pending rows,
        no writer): closing it does nothing."""
        if self._follows:
            return
        try:
            self._close_rank0()
        finally:
            if self._leads:
                with self._cmd_lock:
                    if self._keepalive_off is not None:
                        self._keepalive_off.set()
                    self._command("stop")

    def _close_rank0(self) -> None:
        """What ``close`` does on rank 0: the single-device engine's."""
        super(SingleController, self).close()

    def _gather_rows(self, block: torch.Tensor, group) -> torch.Tensor:
        """Every rank's ``block`` of ``group``, concatenated along dim 0 in
        rank order, in a new tensor (a copy of ``block`` for a group of
        one): the caller may keep it while the state moves on in place."""
        n = dist.get_world_size(group)
        if n == 1:
            return block.clone()
        out = block.new_empty((n,) + tuple(block.shape))
        dist.all_gather(list(out.unbind(0)), block.contiguous(), group=group)
        return out.reshape((-1,) + tuple(block.shape[1:]))

    # ------------------------------------------------------------------
    # the batch columns
    def _local(self, cols) -> list:
        """Global host or device columns -> this rank's (padded, data-
        sliced where the fold takes them data-sharded) columns on the
        device."""
        cols = [self._to_device(c) if isinstance(c, np.ndarray) else c
                for c in cols]
        if not self.DATA_SHARDED:
            return cols
        from streambench_tpu_torch.parallel.sharded import (
            data_slice,
            pad_data_cols,
        )
        return [data_slice(self.mesh, c)
                for c in pad_data_cols(self._data_pad, *cols)]

    def _slices_by_rank(self, cols: list, packed: bool, extra: tuple = ()):
        """``per_rank`` of a call that carries global host columns (or
        ``[K, B]`` stacks): rank ``r`` receives its data index's padded
        slice of each (or all of each, for a replicated fold), ``packed``
        and ``extra``."""
        if not self.DATA_SHARDED:
            return lambda r: (cols, packed, extra)
        pad = [(0, 0)] * (cols[0].ndim - 1) + [(0, self._data_pad)]
        cols = [np.pad(c, pad) if self._data_pad else c for c in cols]
        b = cols[0].shape[-1] // self.mesh.shape[DATA_AXIS]
        nc = self.mesh.shape[CAMPAIGN_AXIS]

        def per_rank(r: int) -> tuple:
            d = r // nc             # the grid is row-major
            return ([np.ascontiguousarray(c[..., d * b:(d + 1) * b])
                     for c in cols], packed, extra)
        return per_rank

    def _fold_args(self) -> tuple:
        """Host values rank 0 hands every fold call besides the columns."""
        return ()

    def _step_cols(self, batch) -> tuple[list, bool]:
        """One batch's wire columns: the packed word (with the engine's
        extra columns and the time) where the step packs, else
        ``SCAN_COLUMNS``."""
        if self._pack_ok and self.STEP_PACKS:
            return ([wc.pack_columns(batch.ad_idx, batch.event_type,
                                     batch.valid)]
                    + [getattr(batch, c) for c in self.PACKED_EXTRA_COLS]
                    + [batch.event_time]), True
        return [getattr(batch, c) for c in self.SCAN_COLUMNS], False

    def _device_step(self, batch) -> None:
        cols, packed = self._step_cols(batch)
        self._command("step", per_rank=self._slices_by_rank(
            cols, packed, self._fold_args()))

    def _do_step(self, local: list, packed: bool, extra: tuple) -> None:
        self._step_local([self._to_device(c) for c in local], packed,
                         *extra)

    def _fold_stack(self, batches: list) -> list[np.ndarray]:
        """The base engine's ``[K, B]`` stacks, folded by one scan call on
        every rank.  Returns the host stacks shipped."""
        if self._pack_ok:
            stacks = ([np.stack([wc.pack_columns(b.ad_idx, b.event_type,
                                                 b.valid) for b in batches])]
                      + [np.stack([getattr(b, c) for b in batches])
                         for c in self.PACKED_EXTRA_COLS]
                      + [np.stack([b.event_time for b in batches])])
        else:
            stacks = [np.stack([getattr(b, c) for b in batches])
                      for c in self.SCAN_COLUMNS]
        self._command("scan", per_rank=self._slices_by_rank(
            stacks, self._pack_ok, self._fold_args()))
        return stacks

    def _do_scan(self, local: list, packed: bool, extra: tuple) -> None:
        self._scan_local([self._to_device(s) for s in local], packed,
                         *extra)

    def _device_scan(self, *stacks) -> None:
        """Fold ``[K, B]`` global stacks (this rank folds its slice)."""
        self._scan_local(self._local(stacks), False, *self._fold_args())

    def _device_scan_packed(self, *stacks) -> None:
        """``_device_scan`` over the packed wire word."""
        self._scan_local(self._local(stacks), True, *self._fold_args())

    # ------------------------------------------------------------------
    # the shard-skew stats arm (jax.obs.shard)
    def _stats_on(self) -> bool:
        """Shard-skew stats arm: only when attach_obs handed over a
        ShardSkew tracker (jax.obs.shard); it issues no collective."""
        return self._obs_shard is not None

    def _note_shard(self, out: tuple) -> tuple:
        """Peel and accumulate the trailing (wanted_s, routed_s) outputs
        when the skew tracker is attached."""
        if self._obs_shard is None:
            return out
        self._obs_shard.note(out[-2], out[-1])
        return out[:-2]

    # ------------------------------------------------------------------
    # collective-cost accounting (parallel.collectives)
    def attach_obs(self, registry, lifecycle: bool = False,
                   spans=None, occupancy=None, xfer=None,
                   shard=None) -> None:
        super().attach_obs(registry, lifecycle, spans=spans,
                           occupancy=occupancy, xfer=xfer, shard=shard)
        self._obs_reg = registry

    def collective_report(self, k: int | None = None,
                          timed: bool = False) -> dict:
        """Per-dispatch collective ops and payload bytes of the folds this
        engine dispatches (its step and its hoisted scan, in the wire
        forms it ships), counted over one real step and one real
        ``k``-batch scan of all-invalid rows.  ``timed`` adds each one's
        device time (CUDA only).  Publishes
        ``streambench_collective_{ops,bytes}{kernel=}`` gauges when obs
        is attached.  Every rank takes part."""
        report = self._command("report", int(k or self.scan_batches), timed)
        if self._obs_reg is not None:
            collectives.publish_gauges(self._obs_reg, report)
        return report

    def _report_cols(self, shape: tuple, packed: bool) -> list:
        zeros = lambda: np.zeros(shape, np.int32)  # noqa: E731
        if packed:
            return [zeros() for _ in range(2 + len(self.PACKED_EXTRA_COLS))]
        return [np.zeros(shape, bool) if c == "valid" else zeros()
                for c in self.SCAN_COLUMNS]

    def _do_report(self, k: int, timed: bool) -> dict:
        B = self.batch_size
        saved = {a: clone_state(getattr(self, a))
                 for a in self.REPORT_RESTORES}
        extra = tuple(0 for _ in self._fold_args())

        def dispatch(fold, cols, packed):
            def run(rec):
                self._recorder = rec
                try:
                    fold(self._local(cols), packed, *extra)
                finally:
                    self._recorder = None
            return run

        step_packed = bool(self._pack_ok and self.STEP_PACKS)
        try:
            return {
                "batch_events": B,
                "scan_batches": k,
                "packed": bool(self._pack_ok),
                "step": collectives.report_for(
                    dispatch(self._step_local,
                             self._report_cols((B,), step_packed),
                             step_packed), timed=timed),
                "scan": collectives.report_for(
                    dispatch(self._scan_local,
                             self._report_cols((k, B), self._pack_ok),
                             bool(self._pack_ok)),
                    scan_len=k, timed=timed),
            }
        finally:
            for a, v in saved.items():
                setattr(self, a, v)
