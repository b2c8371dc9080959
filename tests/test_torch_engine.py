"""The whole slice: the port's engine, runner and CLI against the JAX
package's, on the CPU.

One generated journal (skew on) goes through the JAX ``AdAnalyticsEngine``
+ ``StreamRunner.run_catchup`` and through the port's on ``device="cpu"``;
each writes into its own in-process Redis store.  Every ``seen_count`` per
(campaign, window) must agree bit for bit, and both must pass the
generator's oracle exactly.
"""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import AdAnalyticsEngine as JaxEngine
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.fakeredis import make_store as jax_make_store
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.engine import __main__ as cli
from streambench_tpu_torch.engine import pipeline
from streambench_tpu_torch.io.fakeredis import FakeRedisStore, make_store
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    as_redis,
    read_seen_counts,
    seed_campaigns,
)
from streambench_tpu_torch.utils import device as device_mod
from streambench_tpu_torch.utils.ids import make_ids

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPIC = "ad-events"

# tiny tensors: one intra-op thread keeps these tests from crowding the
# other test workers' CPUs
torch.set_num_threads(1)


def write_journal(workdir, n, spacing_ms, seed, skew=True):
    """Ids, ad->campaign map, the broker topic and ``kafka-json.txt``
    (the oracle's copy) for ``n`` generator events, as ``gen.do_setup``
    lays them out, but with the generator's skew switch on."""
    rng = random.Random(seed)
    campaigns = make_ids(100, rng)
    ads = make_ids(1000, rng)
    gen.write_ids(campaigns, ads, workdir)
    gen.write_ad_mapping_file(campaigns, ads, workdir)
    src = gen.EventSource(ads=ads, user_ids=make_ids(100, rng),
                          page_ids=make_ids(100, rng), with_skew=skew,
                          rng=rng)
    start = 1_700_000_000_000
    blob = "".join(src.event_at(start + spacing_ms * i) + "\n"
                   for i in range(n)).encode()
    with open(os.path.join(workdir, gen.KAFKA_JSON_FILE), "wb") as f:
        f.write(blob)
    broker = FileBroker(os.path.join(workdir, "broker"))
    with broker.writer(TOPIC, append=False) as w:
        w.append_bytes(blob)
    return campaigns


def run_jax(workdir, campaigns, mapping, overrides):
    cfg = jax_default_config(kafka_topic=TOPIC, **overrides)
    r = jax_as_redis(jax_make_store())
    jax_seed(r, campaigns)
    engine = JaxEngine(cfg, mapping, campaigns=campaigns, redis=r)
    reader = JaxBroker(os.path.join(workdir, "broker")).reader(TOPIC)
    stats = JaxRunner(engine, reader).run_catchup()
    engine.close()
    reader.close()
    return r, stats, engine.dropped


def run_port(workdir, campaigns, mapping, overrides, method=None,
             packed=True):
    cfg = default_config(kafka_topic=TOPIC, **overrides)
    r = as_redis(make_store())
    seed_campaigns(r, campaigns)
    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns, redis=r,
                               device="cpu", method=method)
    engine._pack_ok = packed
    reader = FileBroker(os.path.join(workdir, "broker")).reader(TOPIC)
    stats = StreamRunner(engine, reader).run_catchup()
    engine.close()
    reader.close()
    return r, stats, engine


# spacing 10 ms: the stock catchup (every 8192-row batch outspans the
# ring's safe span, so batches are halved and drained per step);
# spacing 1 ms: groups of K batches fit the span and fold as one stack
# (the scan path, with a partial group at the end)
@pytest.mark.parametrize("spacing_ms,overrides", [
    (10, {}),
    (1, {"jax_batch_size": 1024, "jax_scan_batches": 4}),
], ids=["stock_halved_steps", "stacked_scan_groups"])
def test_catchup_matches_jax_engine_bit_for_bit(tmp_path, spacing_ms,
                                                overrides):
    workdir = str(tmp_path)
    campaigns = write_journal(workdir, 30_000, spacing_ms, seed=42)
    mapping = gen.load_ad_mapping_file(
        os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE))

    jr, jstats, jdropped = run_jax(workdir, campaigns, mapping, overrides)
    tr, tstats, engine = run_port(workdir, campaigns, mapping, overrides)
    assert engine.method == "scatter"
    assert tstats.events == jstats.events == 30_000
    assert engine.dropped == jdropped == 0

    want = jax_seen(jr)
    got = read_seen_counts(tr)
    assert got == want
    assert sum(len(v) for v in got.values()) > 100
    for r in (jr, tr):
        logs = []
        correct, differ, missing = gen.check_correct(r, workdir,
                                                     log=logs.append)
        assert differ == 0 and missing == 0, logs[:5]
        assert correct == sum(len(v) for v in got.values())


def test_unpacked_columns_and_kernel_method_give_the_same_rows(tmp_path):
    """The unpacked wire format and the count wrapper (its CPU arm) fold
    the same journal to the same rows as the packed plain path."""
    workdir = str(tmp_path)
    campaigns = write_journal(workdir, 12_000, 3, seed=5)
    mapping = gen.load_ad_mapping_file(
        os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE))
    ov = {"jax_batch_size": 512, "jax_scan_batches": 4}
    base, _, _ = run_port(workdir, campaigns, mapping, ov)
    kern, _, eng = run_port(workdir, campaigns, mapping, ov,
                            method="kernel")
    assert eng.method == "kernel"
    unp, _, _ = run_port(workdir, campaigns, mapping, ov, packed=False)
    want = read_seen_counts(base)
    assert read_seen_counts(kern) == want
    assert read_seen_counts(unp) == want


def test_streaming_run_with_partial_batches_matches_jax_catchup(tmp_path):
    """``StreamRunner.run`` (buffer timeout, adaptive batch target, idle
    timeout) folds the same journal to the same rows as the JAX catchup:
    the count is exact whatever the batching."""
    workdir = str(tmp_path)
    campaigns = write_journal(workdir, 6_000, 10, seed=21)
    mapping = gen.load_ad_mapping_file(
        os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE))
    ov = {"jax_batch_size": 256}
    jr, _, _ = run_jax(workdir, campaigns, mapping, ov)
    cfg = default_config(kafka_topic=TOPIC, **ov)
    r = as_redis(make_store())
    seed_campaigns(r, campaigns)
    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns, redis=r,
                               device="cpu")
    reader = FileBroker(os.path.join(workdir, "broker")).reader(TOPIC)
    runner = StreamRunner(engine, reader, buffer_timeout_ms=20,
                          flush_interval_ms=100)
    stats = runner.run(idle_timeout_s=0.5)
    engine.close()
    reader.close()
    assert stats.events == 6_000 and stats.flushes >= 1
    assert read_seen_counts(r) == jax_seen(jr)


class FlakyRedis:
    """A RESP-client-shaped sink whose first ``fail`` pipelines raise, as
    a sink outage would."""

    def __init__(self, inner, fail):
        self.inner = inner
        self.fail = fail

    def execute(self, *args):
        return self.inner.execute(*args)

    def pipeline_execute(self, commands):
        if self.fail:
            self.fail -= 1
            raise ConnectionError("sink down")
        return self.inner.pipeline_execute(commands)


def test_failed_writes_are_retained_and_rewritten(tmp_path):
    """The writer keeps a failed batch, the engine reclaims it into the
    next flush, and close() leaves nothing unwritten: the rows equal a
    fault-free run's."""
    workdir = str(tmp_path)
    campaigns = write_journal(workdir, 8_000, 10, seed=33)
    mapping = gen.load_ad_mapping_file(
        os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE))
    want, _, _ = run_port(workdir, campaigns, mapping, {})
    cfg = default_config(kafka_topic=TOPIC, jax_sink_retry_base_ms=1,
                         jax_sink_retry_cap_ms=2)
    store = as_redis(FakeRedisStore())
    seed_campaigns(store, campaigns)
    flaky = FlakyRedis(store, fail=2)
    engine = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                               redis=flaky, device="cpu")
    with FileBroker(os.path.join(workdir, "broker")).reader(TOPIC) as rd:
        stats = StreamRunner(engine, rd).run_catchup()
    engine.close()
    faults = engine.faults.snapshot()
    assert faults["sink_errors"] >= 1 and faults["sink_retries"] > 0
    assert "rows_lost" not in faults and stats.events == 8_000
    assert flaky.fail == 0
    assert read_seen_counts(store) == read_seen_counts(want)


def test_cli_catchup_on_cpu(tmp_path):
    workdir = str(tmp_path)
    write_journal(workdir, 5_000, 10, seed=9)
    conf = tmp_path / "conf.yaml"
    conf.write_text(f'redis.host: ":inprocess:"\nkafka.topic: "{TOPIC}"\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.engine",
         "--confPath", str(conf), "--workdir", workdir, "--catchup",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert any("engine up:" in ln and "device=cpu" in ln for ln in lines)
    stats = json.loads(lines[-1])
    assert stats["events"] == 5_000 and stats["dropped"] == 0
    assert stats["windows_written"] > 0 and stats["faults"] == {}


@pytest.mark.parametrize("extra,conf_line,word,ranks,cards", [
    # --sharded runs one rank a device, as many as jax.mesh.shape asks
    # for; what stays refused: more ranks on cuda than the host has
    # cards (named before any rank starts), a mesh whose rank count is
    # not an outside launcher's, and hllx (the reference's refusal)
    (["--sharded", "--device", "cuda"], "jax.mesh.shape: [2]",
     "--sharded over 2 ranks: 2 ranks on cuda need 2 cards, one a rank; "
     "this host has 1", None, 1),
    (["--sharded", "--engine", "hllx"], "",
     "--sharded supports exact/hll/sliding/session/reach, not --engine "
     "hllx", None, None),
    (["--sharded", "--traceDir", "trace"], "jax.obs.fleet: true",
     "jax.mesh.shape [1] needs 1 ranks; STREAMBENCH_NUM_PROCESSES=3", "3",
     None),
    (["--microbatch", "--sharded"], "jax.mesh.shape: [2]",
     "jax.mesh.shape [2] needs 2 ranks; STREAMBENCH_NUM_PROCESSES=4", "4",
     None),
    (["--sharded", "--engine", "session", "--device", "cuda"],
     "jax.admission.enabled: true\njax.mesh.shape: [2, 2]",
     "--sharded over 4 ranks: 4 ranks on cuda need 4 cards, one a rank; "
     "this host has 2", None, 2),
], ids=["sharded", "engine", "trace", "microbatch", "tenants"])
def test_cli_rejects_what_is_not_ported(tmp_path, capsys, monkeypatch, extra,
                                       conf_line, word, ranks, cards):
    """Each form still refused exits 2 with its own message, before any
    rank or engine starts (the card count patched where the case names
    one)."""
    monkeypatch.delenv("STREAMBENCH_NUM_PROCESSES", raising=False)
    if ranks is not None:
        monkeypatch.setenv("STREAMBENCH_NUM_PROCESSES", ranks)
    if cards is not None:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\n' + conf_line + "\n")
    rc = cli.main(["--confPath", str(conf), "--workdir", str(tmp_path),
                   "--device", "cpu", *extra])
    err = capsys.readouterr().err
    assert rc == 2
    assert f"error: {word}" in err
    assert not list(tmp_path.glob("engine.rank*.log"))


def test_cli_rejects_an_unknown_engine_as_the_reference_does():
    """``--engine`` takes the reference's choices: an unknown name is
    argparse's "invalid choice" (exit 2) in both CLIs, the same message
    after the program name."""
    out = {}
    for mod in ("streambench_tpu_torch.engine", "streambench_tpu.engine"):
        proc = subprocess.run(
            [sys.executable, "-m", mod, "--engine", "bogus"],
            capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
        assert proc.returncode == 2
        out[mod] = proc.stderr.strip().splitlines()[-1]
    port, ref = out.values()
    assert "error: argument --engine: invalid choice: 'bogus'" in port
    assert port.split(": error: ")[1] == ref.split(": error: ")[1]


# ----------------------------------------------------------------------
def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """No device argument means CUDA; with CUDA absent the constructor
    raises instead of carrying on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = default_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AdAnalyticsEngine(cfg, {"ad": "camp"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdAnalyticsEngine(cfg, {"ad": "camp"}, device="cuda")
    assert AdAnalyticsEngine(cfg, {"ad": "camp"},
                             device="cpu").device.type == "cpu"


def test_resolve_device_and_method_choice():
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        device_mod.resolve_device("meta")
    assert pipeline.default_method(torch.device("cuda")) == "kernel"
    assert pipeline.default_method(torch.device("cpu")) == "scatter"
    with pytest.raises(ValueError, match="unknown method"):
        AdAnalyticsEngine(default_config(), {"ad": "camp"}, device="cpu",
                          method="pallas")


def test_warmup_leaves_state_and_output_unchanged():
    cfg = default_config(jax_batch_size=64, jax_scan_batches=4)
    engine = AdAnalyticsEngine(cfg, {"ad": "camp"}, device="cpu")
    engine.warmup()
    counts, window_ids, watermark, dropped = engine.state
    assert not counts.any() and (window_ids == -1).all()
    assert int(watermark) == 0 and int(dropped) == 0
    assert engine.flush(final=True) == 0 and engine.dropped == 0


def test_native_store_replies_after_one_large_reply():
    """A reply of tens of MB (SMEMBERS over many campaigns) grows the
    native store's reply buffer; every later reply is still exactly its
    own bytes."""
    r = as_redis(make_store())
    campaigns = [f"campaign-{i:07d}" for i in range(60_000)]
    seed_campaigns(r, campaigns)
    assert sorted(r.execute("SMEMBERS", "campaigns")) == campaigns
    r.execute("HSET", "h", "f", "v")
    assert r.execute("HGET", "h", "f") == "v"
    assert r.execute("HGET", "h", "missing") is None
    assert r.execute("LLEN", "no-list") == 0
