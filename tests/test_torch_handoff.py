"""The columnar handoff benchmark of the port
(``streambench_tpu_torch/handoff.py``) against the JAX package's
(``streambench_tpu/handoff.py``), on the CPU: the round trip and the
reference's three-hash Redis schema (``tests/test_metrics.py:109``), each
package reading what the other wrote, and the CLI's summary line."""

import json
import random

import pytest
import torch

from streambench_tpu import handoff as jax_handoff
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu_torch import handoff
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.encode.encoder import EventEncoder
from streambench_tpu_torch.io.fakeredis import FakeRedisStore
from streambench_tpu_torch.io.redis_schema import as_redis


def _make_windows(n_windows=3, batch=200):
    rng = random.Random(5)
    campaigns = gen.make_ids(10, rng)
    ads = gen.make_ids(100, rng)
    mapping = {a: campaigns[i % 10] for i, a in enumerate(ads)}
    src = gen.EventSource(ads=ads, user_ids=gen.make_ids(20, rng),
                          page_ids=gen.make_ids(20, rng), rng=rng)
    base = 1_700_000_000_000
    windows, starts = [], []
    for w in range(n_windows):
        ts = [base + w * 10_000 + i for i in range(batch)]
        windows.append([e.encode() for e in src.events_at(ts)])
        starts.append(base + w * 10_000)
    return mapping, campaigns, windows, starts


def test_handoff_roundtrip_and_redis_schema():
    mapping, campaigns, windows, starts = _make_windows()
    enc = EventEncoder(mapping, campaigns)
    samples = handoff.run_handoff(enc, windows, starts, device="cpu")
    assert len(samples) == 3
    assert all(s.r2c_ms > 0 and s.c2r_ms > 0 for s in samples)
    assert [s.window_start_ms for s in samples] == starts

    r = as_redis(FakeRedisStore())
    handoff.dump_handoff(r, "t1_handoff", samples)
    got = handoff.read_handoff(r, "t1_handoff")
    assert set(got) == set(starts)
    w, r2c, c2r = got[starts[0]]
    assert r2c > 0 and c2r > 0
    # the three hashes, field for field the reference's
    assert set(r.hgetall("t1_handoff_window")) == {str(s) for s in starts}
    assert set(r.hgetall("t1_handoff_r2c")) == {str(s) for s in starts}
    assert set(r.hgetall("t1_handoff_c2r")) == {str(s) for s in starts}


def test_each_package_reads_what_the_other_wrote():
    _, _, _, starts = _make_windows()
    samples = [handoff.HandoffSample(s, 3, 1.25, 0.5) for s in starts]
    jax_samples = [jax_handoff.HandoffSample(s, 3, 1.25, 0.5)
                   for s in starts]
    r, jr = as_redis(FakeRedisStore()), jax_as_redis(JaxStore())
    handoff.dump_handoff(r, "t", samples)
    jax_handoff.dump_handoff(jr, "t", jax_samples)
    for name in ("t_window", "t_r2c", "t_c2r"):
        assert r.hgetall(name) == jr.hgetall(name)
    assert handoff.read_handoff(r, "t") == jax_handoff.read_handoff(jr, "t")
    assert handoff.read_handoff(r, "t")[starts[0]] == (3, 1.25, 0.5)


def test_handoff_defaults_to_cuda_and_raises_without_it(monkeypatch):
    mapping, campaigns, windows, starts = _make_windows(1, 10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        handoff.run_handoff(EventEncoder(mapping, campaigns), windows)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        handoff._main(["--inprocessRedis", "--windows", "2",
                       "--batchSize", "10"])


def test_cli_prints_the_reference_summary(capsys):
    args = ["--inprocessRedis", "--windows", "4", "--batchSize", "300"]
    assert jax_handoff._main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert handoff._main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["windows"] == want["windows"] == 3   # the first is dropped
    assert got["batch_size"] == 300 and got["table"] == want["table"]
    assert 0 < got["r2c_ms_p50"] <= got["r2c_ms_max"]
    assert 0 < got["c2r_ms_p50"] <= got["c2r_ms_max"]
