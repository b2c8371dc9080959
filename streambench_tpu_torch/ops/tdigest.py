"""t-digest quantile sketches with fixed shapes: BASELINE config #3.

The port of ``streambench_tpu/ops/tdigest.py``.  ``N`` digests of ``K``
centroids each (the caller maps campaign -> key):

- state: ``means [N, K]``, ``weights [N, K]`` float32 (weight 0 = empty);
- batch fold for hot loops: ``fold_hist`` scatter-adds ``(w, w*value)``
  into a ``[N, HIST_BINS]`` histogram whose bins are the top exponent and
  mantissa bits of float32(value), monotone in value (~3 % wide), and
  ``absorb_hist`` compresses it into the digest once per chunk;
- per-batch fold: ``update``, sort-based (O(B log B), O(N*K) memory);
- compress: centroids sorted by mean, re-bucketed by cumulative-weight
  mid-quantile through the k1 scale ``asin(2q-1)/pi + 1/2``; total weight
  is conserved exactly.

Values below 1.0 share bin 0 and negatives clamp to 0 (built for latency
in ms).  Differences from the JAX functions, all deliberate: torch has no
scatter ``mode="drop"``, so rows that do not count go to a pad element
past each ``[N*X]`` buffer (out-of-range keys too: masked first, never
clamped into a real key); ``lax.associative_scan(max)`` is
``torch.cummax``; the vmapped ``searchsorted`` is one batched
``torch.searchsorted``.  Float sums may differ from XLA's in the last
place (summation order); the weights, sums of ones, are exact.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class TDigestState(NamedTuple):
    means: torch.Tensor    # [N, K] float32
    weights: torch.Tensor  # [N, K] float32


def init_state(num_keys: int, compression: int = 64,
               device: torch.device | str = "cpu") -> TDigestState:
    z = torch.zeros((num_keys, compression), dtype=torch.float32,
                    device=device)
    return TDigestState(means=z, weights=z.clone())


def _k1_bucket(q: torch.Tensor, K: int) -> torch.Tensor:
    """Scale-function bucketing: the tails get narrow centroids."""
    q = torch.clamp(q, 0.0, 1.0)
    k = (torch.asin(2.0 * q - 1.0) / math.pi + 0.5) * K
    return torch.clamp(k.to(torch.int32), 0, K - 1)


# Histogram geometry: float32(value)'s top exponent + HIST_MANT mantissa
# bits, shifted so value 1.0 lands in bin 0; 2^HIST_MANT bins an octave.
HIST_MANT = 5
HIST_BINS = 1024
_HIST_SHIFT = 23 - HIST_MANT
_HIST_OFFSET = 127 << HIST_MANT  # bucket of value 1.0 before shifting


def _value_bucket(value: torch.Tensor) -> torch.Tensor:
    f = torch.clamp(value, min=0.0).to(torch.float32)
    bits = f.view(torch.int32)
    return torch.clamp((bits >> _HIST_SHIFT) - _HIST_OFFSET, 0,
                       HIST_BINS - 1)


def _scatter_add(n: int, flat: torch.Tensor, vals: torch.Tensor
                 ) -> torch.Tensor:
    """A fresh float32 ``[n]`` buffer with ``vals`` added at ``flat``;
    index ``n`` is the pad element that rows which do not count go to."""
    out = torch.zeros(n + 1, dtype=torch.float32, device=vals.device)
    out.index_add_(0, flat.reshape(-1), vals.reshape(-1))
    return out[:n]


def hist_init(num_keys: int, device: torch.device | str = "cpu"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """A fresh (value-sum, weight) accumulator for ``fold_hist``."""
    z = torch.zeros((num_keys, HIST_BINS), dtype=torch.float32,
                    device=device)
    return z, z.clone()


def fold_hist(hist_num: torch.Tensor, hist_w: torch.Tensor,
              key: torch.Tensor, value: torch.Tensor, w: torch.Tensor,
              num_keys: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one batch into the histogram: two O(B) scatter-adds.  Rows
    with ``w == 0`` or a key outside ``[0, num_keys)`` do not count;
    values clamp to 0 first (bin 0's sum must match its bucket)."""
    value = torch.clamp(value.to(torch.float32), min=0.0)
    ok = (w > 0) & (key >= 0) & (key < num_keys)
    n = num_keys * HIST_BINS
    flat = torch.where(ok, key.to(torch.int64) * HIST_BINS
                       + _value_bucket(value), n)
    hist_w = hist_w + _scatter_add(n, flat, w).view(num_keys, HIST_BINS)
    hist_num = hist_num + _scatter_add(n, flat, w * value).view(
        num_keys, HIST_BINS)
    return hist_num, hist_w


def absorb_hist(state: TDigestState, hist_num: torch.Tensor,
                hist_w: torch.Tensor) -> TDigestState:
    """Compress an accumulated histogram into the digest: the histogram
    is value-ordered, so it compresses sort-free; then the ``[N, 2K]``
    merge with the state's centroids."""
    K = state.means.shape[1]
    hist_mean = hist_num / torch.clamp(hist_w, min=1e-9)
    hd = _compress_sorted(hist_mean, hist_w, K)
    return _compress(torch.cat([state.means, hd.means], 1),
                     torch.cat([state.weights, hd.weights], 1), K)


def _fold(key: torch.Tensor, value: torch.Tensor, w: torch.Tensor,
          N: int, K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based batch fold: ``(w, w*value)`` into fresh ``[N, K]``
    buffers, bucketed by exact within-key mid-rank quantile."""
    order = torch.argsort(value, stable=True)
    order = order[torch.argsort(key[order], stable=True)]
    sk = key[order].to(torch.int64)
    sv = value[order]
    sw = w[order]

    csum = torch.cumsum(sw, 0) - sw                 # exclusive prefix
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    # each key run's starting prefix, broadcast down the run: csum is
    # nondecreasing, so a running max of the run starts' values
    run_base = torch.cummax(torch.where(first, csum, 0.0), 0).values
    within = csum - run_base
    in_range = sk < N
    total = _scatter_add(N, torch.where(in_range, sk, N), sw)
    tot_here = total[torch.clamp(sk, 0, N - 1)]
    q = (within + sw * 0.5) / torch.clamp(tot_here, min=1e-9)
    bucket = _k1_bucket(q, K)

    flat = torch.where((sw > 0) & in_range, sk * K + bucket, N * K)
    weights = _scatter_add(N * K, flat, sw).view(N, K)
    means_num = _scatter_add(N * K, flat, sw * sv).view(N, K)
    return means_num, weights


def update(state: TDigestState, key: torch.Tensor, value: torch.Tensor,
           mask: torch.Tensor) -> TDigestState:
    """Fold one batch of (key, value) points, then compress back to K."""
    N, K = state.means.shape
    w = torch.where(mask, 1.0, 0.0).to(torch.float32)
    value = torch.clamp(value.to(torch.float32), min=0.0)
    key = torch.where(mask & (key >= 0) & (key < N), key, N)

    new_num, new_w = _fold(key, value, w, N, K)
    new_mean = new_num / torch.clamp(new_w, min=1e-9)
    return _compress(torch.cat([state.means, new_mean], 1),
                     torch.cat([state.weights, new_w], 1), K)


def _compress_sorted(m2: torch.Tensor, w2: torch.Tensor,
                     K: int) -> TDigestState:
    """Re-bucket value-ORDERED ``[N, M]`` centroids to ``[N, K]`` through
    the k1 scale, sort-free; zero-weight columns drop out."""
    N = m2.shape[0]
    csum = torch.cumsum(w2, 1) - w2
    tot = w2.sum(1, keepdim=True)
    q = (csum + 0.5 * w2) / torch.clamp(tot, min=1e-9)
    bucket = _k1_bucket(q, K).to(torch.int64)
    rows = torch.arange(N, dtype=torch.int64, device=m2.device)[:, None]
    flat = torch.where(w2 > 0, rows * K + bucket, N * K)
    weights = _scatter_add(N * K, flat, w2).view(N, K)
    nums = _scatter_add(N * K, flat, w2 * m2).view(N, K)
    return TDigestState(nums / torch.clamp(weights, min=1e-9), weights)


def _compress(m2: torch.Tensor, w2: torch.Tensor, K: int) -> TDigestState:
    """Re-bucket ``[N, M]`` centroids to ``[N, K]`` through the k1 scale."""
    order = torch.argsort(torch.where(w2 > 0, m2, math.inf), dim=1,
                          stable=True)
    return _compress_sorted(torch.gather(m2, 1, order),
                            torch.gather(w2, 1, order), K)


def quantile(state: TDigestState, qs: torch.Tensor) -> torch.Tensor:
    """Per-key quantiles ``[N, len(qs)]``: linear interpolation between
    centroid means at cumulative-weight midpoints; empty digests give 0."""
    N, K = state.means.shape
    order = torch.argsort(torch.where(state.weights > 0, state.means,
                                      math.inf), dim=1, stable=True)
    m = torch.gather(state.means, 1, order)
    w = torch.gather(state.weights, 1, order)
    tot = w.sum(1, keepdim=True)                          # [N, 1]
    mid = (torch.cumsum(w, 1) - 0.5 * w) / torch.clamp(tot, min=1e-9)
    # empty centroids sort last: their midpoints read +inf, and the
    # interpolation stops at the last OCCUPIED centroid
    mid = torch.where(w > 0, mid, math.inf)
    last = torch.clamp((w > 0).sum(1, dtype=torch.int64) - 1,
                       min=0)[:, None]                   # [N, 1]
    qs = qs.to(torch.float32).to(mid.device)
    qn = qs[None, :].expand(N, -1).contiguous()           # [N, Q]
    idx = torch.searchsorted(mid.contiguous(), qn)        # side "left"
    lo = torch.minimum(torch.clamp(idx - 1, min=0), last)
    hi = torch.minimum(torch.clamp(idx, min=0), last)
    mlo, mhi = torch.gather(mid, 1, lo), torch.gather(mid, 1, hi)
    t = torch.where(mhi > mlo,
                    (qn - mlo) / torch.clamp(mhi - mlo, min=1e-9), 0.0)
    vlo, vhi = torch.gather(m, 1, lo), torch.gather(m, 1, hi)
    v = vlo + t * (vhi - vlo)
    return torch.where(tot > 0, v, 0.0)


def merge(a: TDigestState, b: TDigestState) -> TDigestState:
    """Digest union: exact in total weight."""
    K = a.means.shape[1]
    return _compress(torch.cat([a.means, b.means], 1),
                     torch.cat([a.weights, b.weights], 1), K)
