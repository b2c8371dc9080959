"""Cross-process clock-domain correction for the fleet freshness ledger.

The port's copy of ``streambench_tpu/obs/clock.py`` (host code, no
torch): the same estimator, byte for byte the same estimates.

The freshness hops (obs/fleet.py) subtract wall-clock stamps taken in
DIFFERENT processes — writer stamps (fold/ship) minus replica stamps
(load/reply).  On one host those clocks are the same ``CLOCK_REALTIME``
and the deltas are honest; across hosts they can be skewed by arbitrary
amounts, and a skewed ``tail_lag`` would silently mis-attribute
staleness to the wrong hop.

This module estimates the wall-clock offset between a replica and its
writer with the classic NTP midpoint method over the pub/sub ``ping``
verb (dimensions/pubsub.py):

- the client stamps ``t0`` (local wall), pings, the server answers with
  its own wall stamp ``ts``, the client stamps ``t1``;
- assuming symmetric network delay, the server's clock read maps to the
  local midpoint: ``offset = ts - (t0 + t1) / 2``;
- the asymmetry error is bounded by half the round trip, so the sample
  with the SMALLEST rtt carries the tightest bound — that one wins;
- the bound is RECORDED (``uncertainty_ms``), and a noisy estimate is
  never silently applied: when the winning sample's uncertainty or the
  spread of per-sample offsets exceeds ``jitter_threshold_ms`` the
  estimate comes back ``applied=False`` and callers must keep raw
  stamps (an honest uncorrected delta beats a confidently wrong one).

``offset_from_samples`` is the pure estimator (unit-testable with
synthetic delays); ``sync_pubsub`` drives it over a live endpoint.
"""

from __future__ import annotations

import time

#: past this (winning-sample uncertainty OR cross-sample offset spread,
#: ms) the estimate is reported but NOT applied — the correction would
#: be noisier than the skew it fixes on any same-site deployment
DEFAULT_JITTER_THRESHOLD_MS = 50.0

#: quantization floor: server stamps are integer ms, so even a zero-rtt
#: exchange carries this much rounding uncertainty
QUANTIZATION_MS = 0.5


def offset_from_samples(samples, *,
                        jitter_threshold_ms: float =
                        DEFAULT_JITTER_THRESHOLD_MS) -> dict:
    """Fold ``(t0_local_ms, t_server_ms, t1_local_ms)`` ping samples
    into one offset estimate.

    Returns ``{offset_ms, uncertainty_ms, rtt_min_ms, jitter_ms,
    samples, applied}`` where ``offset_ms`` is ``server - local`` (add
    it to a LOCAL stamp to express it in the server's clock, subtract
    it from a server stamp to map into local time... the ledger does
    ``server_stamp + (-offset)``; see :func:`to_local_ms`).  With a
    symmetric network delay the midpoint method is EXACT; asymmetric
    delay errs by at most ``rtt/2``, which is what ``uncertainty_ms``
    reports.  ``applied=False`` when either the uncertainty or the
    offset spread across samples exceeds the jitter threshold — the
    refusal contract: corrections are never silently applied past it.
    """
    rows = []
    for t0, ts, t1 in samples:
        rtt = float(t1) - float(t0)
        if rtt < 0:
            continue   # a backwards local clock read: unusable sample
        mid = (float(t0) + float(t1)) / 2.0
        rows.append((rtt, float(ts) - mid))
    if not rows:
        return {"offset_ms": 0.0, "uncertainty_ms": None,
                "rtt_min_ms": None, "jitter_ms": None, "samples": 0,
                "applied": False}
    rows.sort()
    rtt_min, offset = rows[0]
    uncertainty = rtt_min / 2.0 + QUANTIZATION_MS
    # jitter over the BEST half of the samples (lowest rtt): one
    # scheduler stall mid-burst would otherwise blow the spread and
    # refuse an estimate the quiet samples agree on perfectly — the
    # gate exists to catch disagreeing GOOD samples, not slow ones
    best = rows[:max((len(rows) + 1) // 2, 1)]
    offsets = [o for _, o in best]
    jitter = max(offsets) - min(offsets)
    applied = (uncertainty <= jitter_threshold_ms
               and jitter <= jitter_threshold_ms)
    return {
        "offset_ms": round(offset, 3),
        "uncertainty_ms": round(uncertainty, 3),
        "rtt_min_ms": round(rtt_min, 3),
        "jitter_ms": round(jitter, 3),
        "samples": len(rows),
        "applied": applied,
    }


def to_local_ms(remote_stamp_ms: float, estimate: "dict | None") -> float:
    """Map a remote (writer-clock) wall stamp into the local clock,
    applying the offset only when the estimate passed the jitter gate.
    ``offset = remote - local``, so ``local = remote - offset``."""
    if estimate and estimate.get("applied"):
        return float(remote_stamp_ms) - float(estimate["offset_ms"])
    return float(remote_stamp_ms)


def sync_pubsub(host: str, port: int, *, n: int = 8,
                timeout_s: float = 5.0,
                jitter_threshold_ms: float =
                DEFAULT_JITTER_THRESHOLD_MS) -> dict:
    """Estimate the offset to the pub/sub server at ``host:port`` via
    ``n`` round trips of its ``ping`` query verb.  Raises ``OSError``
    (connect/timeout) like any socket client — callers treat a failed
    sync as ``applied=False`` evidence, not a fatal error."""
    from streambench_tpu_torch.dimensions.pubsub import PubSubClient

    c = PubSubClient(host, port, timeout_s=timeout_s)
    samples = []
    try:
        for i in range(max(int(n), 1)):
            t0 = time.time() * 1000.0
            c.request({"type": "ping", "id": i})
            data = c.recv().get("data") or {}
            t1 = time.time() * 1000.0
            ts = data.get("t")
            if isinstance(ts, (int, float)):
                samples.append((t0, float(ts), t1))
    finally:
        c.close()
    out = offset_from_samples(samples,
                              jitter_threshold_ms=jitter_threshold_ms)
    out["endpoint"] = f"{host}:{port}"
    return out
