"""The port's clock-offset estimator (``streambench_tpu_torch/obs/
clock.py``) against the JAX package's, on the CPU.

``offset_from_samples`` and ``to_local_ms`` are pure: over the same
seeded ping samples both packages give the same estimate, JSON
byte-identical.  ``sync_pubsub`` drives the port's ``ping`` verb, and the
port's client also syncs against the JAX package's pub/sub server (one
wire format).  A replica whose writer origin is unreachable records
``applied: False`` and keeps raw stamps."""

import json

import numpy as np
import pytest

from streambench_tpu.dimensions.pubsub import PubSubServer as JaxPubSub
from streambench_tpu.obs import clock as jax_clock
from streambench_tpu_torch.dimensions.pubsub import (
    PubSubClient,
    PubSubServer,
)
from streambench_tpu_torch.obs import clock as obs_clock
from streambench_tpu_torch.utils.ids import now_ms


def _samples(true_offset, delays):
    """Synthetic ping samples: (d1, d2) network delays per exchange,
    server clock ahead of local by ``true_offset`` ms."""
    out = []
    t0 = 1_000_000.0
    for d1, d2 in delays:
        ts = t0 + d1 + true_offset
        out.append((t0, ts, t0 + d1 + d2))
        t0 += 100.0
    return out


def _seeded_samples(seed: int):
    """Seeded ping samples: an offset, n exchanges with asymmetric
    delays, and now and then a stall or a backwards local clock read."""
    rng = np.random.default_rng(seed)
    offset = float(rng.uniform(-5_000, 5_000))
    out = []
    t0 = float(rng.uniform(1e12, 2e12))
    for _ in range(int(rng.integers(1, 12))):
        d1, d2 = (float(x) for x in rng.exponential(3.0, 2))
        if rng.random() < 0.2:
            d1 += float(rng.uniform(50, 300))           # a stall
        t1 = t0 + d1 + d2
        if rng.random() < 0.1:
            t1 = t0 - 1.0                               # backwards read
        out.append((t0, t0 + d1 + offset, t1))
        t0 += float(rng.uniform(0.5, 20))
    return out


def _dump(est) -> str:
    return json.dumps(est, sort_keys=True)


# ----------------------------------------------- pure functions, equal
@pytest.mark.parametrize("seed", range(8))
def test_offset_from_samples_equals_the_jax_package(seed):
    samples = _seeded_samples(seed)
    for thr in (5.0, 50.0, 500.0):
        assert _dump(obs_clock.offset_from_samples(
            samples, jitter_threshold_ms=thr)) == _dump(
            jax_clock.offset_from_samples(samples,
                                          jitter_threshold_ms=thr))


@pytest.mark.parametrize("seed", range(3))
def test_to_local_ms_equals_the_jax_package(seed):
    rng = np.random.default_rng(100 + seed)
    est = obs_clock.offset_from_samples(_seeded_samples(seed))
    refused = dict(est, applied=False)
    for stamp in rng.uniform(1e12, 2e12, 20):
        for e in (est, refused, None, {}):
            assert obs_clock.to_local_ms(stamp, e) == \
                jax_clock.to_local_ms(stamp, e)


# ------------------------------------------- the reference's unit cases
def test_clock_symmetric_rtt_exact():
    est = obs_clock.offset_from_samples(
        _samples(1234.5, [(5, 5), (8, 8), (3, 3)]))
    assert est["applied"]
    assert est["offset_ms"] == pytest.approx(1234.5, abs=1e-6)
    assert est["rtt_min_ms"] == pytest.approx(6.0)
    assert est["uncertainty_ms"] == pytest.approx(3.5)


def test_clock_asymmetric_bounded():
    est = obs_clock.offset_from_samples(_samples(-500.0, [(9, 1)]))
    assert abs(est["offset_ms"] - (-500.0)) <= est["uncertainty_ms"]
    assert abs(est["offset_ms"] - (-500.0)) <= 5.0 + 1e-6


def test_clock_jitter_threshold_refusal():
    est = obs_clock.offset_from_samples(
        _samples(0.0, [(1, 1), (200, 1), (1, 200)]),
        jitter_threshold_ms=50.0)
    assert not est["applied"] and est["jitter_ms"] > 50.0
    est = obs_clock.offset_from_samples(
        _samples(0.0, [(120, 120)]), jitter_threshold_ms=50.0)
    assert not est["applied"]
    assert obs_clock.to_local_ms(777.0, est) == 777.0
    applied = obs_clock.offset_from_samples(_samples(100.0, [(2, 2)]))
    assert obs_clock.to_local_ms(777.0, applied) == pytest.approx(677.0)


def test_clock_no_samples():
    est = obs_clock.offset_from_samples([])
    assert not est["applied"] and est["samples"] == 0
    assert _dump(est) == _dump(jax_clock.offset_from_samples([]))


# ------------------------------------------------------- live endpoints
def test_ping_verb_and_live_sync():
    ps = PubSubServer(port=0).start()
    try:
        host, port = ps.address
        c = PubSubClient(host, port, timeout_s=10)
        c.request({"type": "ping", "id": 7})
        d = c.recv()["data"]
        c.close()
        assert d["id"] == 7 and abs(d["t"] - now_ms()) < 5_000
        est = obs_clock.sync_pubsub(host, port, n=8,
                                    jitter_threshold_ms=2_000)
        assert est["applied"], est
        assert est["samples"] == 8
        assert est["endpoint"] == f"{host}:{port}"
        assert abs(est["offset_ms"]) <= est["uncertainty_ms"] + 50.0
    finally:
        ps.close()


def test_port_sync_against_the_jax_pubsub_server():
    """One wire format: the port's sync pings the JAX package's pub/sub
    server as it pings its own."""
    ps = JaxPubSub(port=0).start()
    try:
        est = obs_clock.sync_pubsub(*ps.address, n=4,
                                    jitter_threshold_ms=2_000)
        assert est["samples"] == 4 and est["applied"], est
    finally:
        ps.close()


def test_sync_to_a_closed_port_raises_oserror():
    ps = PubSubServer(port=0).start()
    host, port = ps.address
    ps.close()
    with pytest.raises(OSError):
        obs_clock.sync_pubsub(host, port, n=2, timeout_s=1.0)


def test_replica_with_an_unreachable_origin_keeps_raw_stamps(tmp_path):
    """A fleet replica whose writer origin is gone records
    ``applied: False`` with the error and maps no stamp."""
    from streambench_tpu_torch.reach.replica import ReachReplica

    ps = PubSubServer(port=0).start()
    host, port = ps.address
    ps.close()
    rep = ReachReplica(str(tmp_path / "dimensions.log"), fleet=True,
                       device="cpu")
    try:
        rep._sync_clock({"addr": f"{host}:{port}"})
        assert rep.clock["applied"] is False and "error" in rep.clock
        fresh = rep._freshness({"folded_ms": 1000, "submit_ms": 1100,
                                "shipped_ms": 1200}, 1300)
        assert (fresh["folded_ms"], fresh["submit_ms"],
                fresh["shipped_ms"], fresh["loaded_ms"]) == (
                    1000.0, 1100.0, 1200.0, 1300)
        assert fresh["clock"]["applied"] is False
        # the same origin is not pinged again
        rep.clock = None
        rep._sync_clock({"addr": f"{host}:{port}"})
        assert rep.clock is None
    finally:
        rep.close()
