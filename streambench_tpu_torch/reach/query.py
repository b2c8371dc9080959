"""Batched reach-query evaluation: thousands of ad-hoc queries in a
handful of device dispatches.

The port of ``streambench_tpu/reach/query.py``.  A query is ``(campaign
set, op)`` with op in {union, overlap}.  A batch of Q queries is a
``[Q, C]`` membership mask plus a ``[Q]`` overlap flag, evaluated by one
function of about twenty torch ops:

- the union's signature and registers are the masked elementwise min and
  max over the selected campaigns (a ``[Q, C, k]`` / ``[Q, C, R]``
  broadcast and reduction, no host work per query), kept in the planes'
  integer dtypes;
- ``|∪|`` from the merged HLL plane (``hll.estimate``);
- the m-way Jaccard from the collision fraction: slot j agrees when every
  selected campaign's minimum equals the union minimum, which happens
  exactly when slot j's argmin device is in every selected set, so
  ``P(agree) = |∩|/|∪|`` and ``J_est = agree / k``;
- ``|∩| ≈ |∪| · J``.

``query_chunks`` pads every batch to one shape and dispatches
``ceil(Q/batch)`` times, never once per query.

Error model: the union estimate carries HLL's relative standard error
``1.04/sqrt(R)``; the overlap estimate's error as a fraction of the union
is the Jaccard estimator's ``sqrt(J(1-J)/k) <= 0.5/sqrt(k)`` plus the
union term, and ``1/sqrt(k)`` is the conservative two-sigma figure.

``agree`` is bit-exact against ``oracle.query_oracle_np``; the floats go
through the port's ``hll.estimate`` and may differ from JAX's in the last
place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from streambench_tpu_torch.ops import hll
from streambench_tpu_torch.ops.minhash import EMPTY

#: default queries evaluated per dispatch (one padded shape)
DEFAULT_BATCH = 256


def union_bound(num_registers: int) -> float:
    """Relative standard error of the HLL union estimate."""
    return 1.04 / math.sqrt(num_registers)


def overlap_bound(k: int, num_registers: int) -> float:
    """Conservative relative-to-union error bound for the overlap
    estimate: two-sigma Jaccard (``1/sqrt(k)``) plus the union term."""
    return 1.0 / math.sqrt(k) + union_bound(num_registers)


def batch_query(mins: torch.Tensor, registers: torch.Tensor, mask,
                overlap):
    """Evaluate one padded query batch on the planes' device.

    ``mins [C, k]`` int64 holding uint32 (``ops.minhash``), ``registers
    [C, R]`` int32, ``mask [Q, C]`` bool and ``overlap [Q]`` bool (numpy
    or tensors; numpy crosses to the device here, once).  Returns
    ``(estimate [Q] f32, union [Q] f32, jaccard [Q] f32, agree [Q] i32)``
    as tensors on that device: ``agree`` is the integer collision count,
    the bit-exact quantity.

    All-False mask rows (padding, or a query over no campaign) evaluate
    to 0: the union registers stay zero (estimate 0 by linear counting)
    and no slot agrees (an empty selection's masked min is ``EMPTY``).
    """
    dev = mins.device
    sel = torch.as_tensor(mask, device=dev).to(torch.bool)[:, :, None]
    ov = torch.as_tensor(overlap, device=dev).to(torch.bool)
    # [Q, k]: min and max of each slot over the selected campaigns; a
    # selected campaign never seen holds EMPTY, which the max takes, so
    # any empty member forces disagreement: |∩| with an empty set is 0
    m = mins[None]
    sel_min = torch.where(sel, m, EMPTY).amin(dim=1)
    sel_max = torch.where(sel, m, 0).amax(dim=1)
    agree = ((sel_min == sel_max) & (sel_min != EMPTY)).sum(
        dim=1, dtype=torch.int32)
    union_regs = torch.where(sel, registers[None], 0).amax(dim=1)
    union = hll.estimate(union_regs).to(torch.float32)
    k = mins.shape[1]
    jacc = agree.to(torch.float32) / k
    est = torch.where(ov, union * jacc, union)
    return est, union, jacc, agree


class DispatchCounter:
    """Counts ``batch_query`` dispatches (the ``<= ceil(Q/batch)``
    acceptance is on this number)."""

    def __init__(self) -> None:
        self.dispatches = 0


def query_chunks(mins: torch.Tensor, registers: torch.Tensor,
                 masks: np.ndarray, overlap: np.ndarray, *,
                 batch: int = DEFAULT_BATCH,
                 counter: DispatchCounter | None = None):
    """Evaluate Q queries in ``ceil(Q/batch)`` dispatches of one padded
    shape.

    ``masks [Q, C] bool``, ``overlap [Q] bool`` (numpy).  Returns
    ``(est, union, jacc, agree)`` numpy arrays of length Q."""
    q = masks.shape[0]
    if q == 0:
        z = np.zeros(0, np.float32)
        return z, z.copy(), z.copy(), np.zeros(0, np.int32)
    batch = max(int(batch), 1)
    outs = []
    for off in range(0, q, batch):
        m = masks[off:off + batch]
        o = overlap[off:off + batch]
        rows = m.shape[0]
        if rows < batch:
            m = np.concatenate(
                [m, np.zeros((batch - rows, m.shape[1]), bool)])
            o = np.concatenate([o, np.zeros(batch - rows, bool)])
        res = batch_query(mins, registers, m, o)
        if counter is not None:
            counter.dispatches += 1
        outs.append(tuple(x.cpu().numpy()[:rows] for x in res))
    return tuple(np.concatenate([t[i] for t in outs]) for i in range(4))
