"""Parallel micro-batch encoding: per-thread encoders behind one pool.

Encoding is the host's largest cost per event.  The native scanner is one
ctypes call per batch, and ctypes releases the GIL for the call's
duration, so N worker threads with N independent encoder instances
parallelize it near-linearly.  Workers are host-only: they encode and
never touch torch or the device.

Soundness: worker encoders intern user/page ids INDEPENDENTLY, so their
``user_idx``/``page_idx`` columns are not comparable across batches.
That is fine for the exact count, whose fold reads only
``ad_idx``/``event_type``/``event_time``/``valid`` (the ad table is fixed
up front and shared read-only); an engine whose device state is keyed by
interned ids must clear ``PARALLEL_ENCODE_OK``.

Time rebasing: all encoders must share one ``base_time_ms`` or window
ids would shift between batches.  The pool pins the primary encoder's
base (encoding the first-ever batch sequentially to establish it) and
syncs every worker before its job runs.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

from streambench_tpu_torch.encode.encoder import repack_batches


class ParallelEncodePool:
    def __init__(self, primary, factory: Callable[[], object],
                 workers: int = 4):
        self.primary = primary
        self._factory = factory
        self._workers = max(workers, 1)
        self._tls = threading.local()
        self._pool = ThreadPoolExecutor(max_workers=self._workers,
                                        thread_name_prefix="encode")

    def _worker_enc(self, base: int):
        """Thread-local worker encoder, base-synced to the primary's
        rebase origin (shared by the line and block jobs — any new
        worker-setup step belongs HERE so the two paths cannot drift)."""
        enc = getattr(self._tls, "enc", None)
        if enc is None:
            enc = self._tls.enc = self._factory()
        if enc.base_time_ms != base:
            enc.set_base_time(base)
        return enc

    def _job(self, lines: list[bytes], batch_size: int, base: int):
        return self._worker_enc(base).encode(lines, batch_size)

    def encode_chunks(self, chunks: list[list[bytes]], batch_size: int):
        """Encode each chunk into an ``EncodedBatch``, order-preserving."""
        out = [None] * len(chunks)
        start = 0
        if self.primary.base_time_ms is None and chunks:
            # First data ever: establish the shared rebase origin on the
            # primary before any worker encodes against it.
            out[0] = self.primary.encode(chunks[0], batch_size)
            start = 1
            if self.primary.base_time_ms is None:
                # all-bad first chunk: no base yet; stay sequential
                for i in range(start, len(chunks)):
                    out[i] = self.primary.encode(chunks[i], batch_size)
                return out
        base = self.primary.base_time_ms
        futures = [(i, self._pool.submit(self._job, chunks[i],
                                         batch_size, base))
                   for i in range(start, len(chunks))]
        for i, fut in futures:
            out[i] = fut.result()
        return out

    def _job_block(self, data: bytes, batch_size: int, base: int,
                   start: int, end: int):
        return self._worker_enc(base).carve_block(
            data, batch_size, start=start, end=end)

    def carve_block_parallel(self, data: bytes, batch_size: int
                             ) -> tuple[list, int]:
        """Carve + parse one raw journal block on all workers.

        Record boundaries are found first (a memchr per cut — ~free),
        then each worker scans its region of the SHARED block via the
        start/end bounds (no sub-block copies).  Worker tails are
        partial batches, so the results are repacked into full batches
        before the device sees them.  Same (batches, consumed) contract
        as ``carve_block``; an unterminated trailing record is left
        unconsumed.
        """
        n = len(data)
        start = 0
        head: list = []
        if self.primary.base_time_ms is None and n:
            # First data ever: establish the shared rebase origin by
            # encoding one batch on the primary before workers spread out.
            head, start = self.primary.carve_block(data, batch_size,
                                                   max_batches=1)
            if self.primary.base_time_ms is None:
                return head, start  # all-bad head: no base to share yet
        base = self.primary.base_time_ms
        # record-aligned cut points over [start, n)
        cuts = [start]
        for i in range(1, self._workers):
            want = start + (n - start) * i // self._workers
            pos = data.find(b"\n", max(want, cuts[-1]))
            cuts.append(pos + 1 if pos >= 0 else n)
        cuts.append(n)
        jobs = [(a, b, self._pool.submit(self._job_block, data,
                                         batch_size, base, a, b))
                for a, b in zip(cuts, cuts[1:]) if a < b]
        batches = head
        for a, b, fut in jobs:
            got, stop = fut.result()
            batches += got
            # The reported consumption below assumes every worker parsed
            # its whole region (interior cuts are newline-aligned; the
            # last region may hold an unterminated tail).  Verify with
            # the stop offset the worker actually reached — an early
            # stop would silently drop records while still reporting
            # them consumed.
            expect = (b if data[b - 1] == 0x0A
                      else max(data.rfind(b"\n", a, b) + 1, a))
            if stop != expect:
                raise RuntimeError(
                    f"parallel carve worker stopped at {stop}, expected "
                    f"{expect} for region [{a}, {b})")
        # consumption: everything but an unterminated trailing record
        nl_end = data.rfind(b"\n") + 1
        return repack_batches(batches, batch_size), max(start, nl_end)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
