"""The port's engine CLI and harness with the observability keys on, on
the CPU: the journal, the span trace, the flight recorder's SIGTERM
dump, the triggered capture, the ``obs`` CLI reading what they wrote,
and the keys and knobs that stay refused."""

import glob
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from streambench_tpu_torch.engine import __main__ as cli
from streambench_tpu_torch.obs import __main__ as obs_cli
from tests.test_torch_engine import REPO, TOPIC, write_journal

OBS_CONF = """redis.host: ":inprocess:"
kafka.topic: "ad-events"
jax.batch.size: 1024
jax.metrics.interval.ms: 100
jax.metrics.port: 0
jax.obs.lifecycle: true
jax.obs.flightrec.enabled: true
jax.obs.spans: true
jax.obs.occupancy: true
jax.obs.xfer: true
jax.obs.devmem: true
jax.obs.capture.enabled: true
jax.obs.capture.oneshot: true
jax.obs.capture.window.s: 0.1
jax.slo.p99.ms: 15000
"""


def _engine(workdir, conf, *extra):
    return [sys.executable, "-m", "streambench_tpu_torch.engine",
            "--confPath", conf, "--workdir", workdir, "--device", "cpu",
            *extra]


def test_cli_catchup_with_obs_on(tmp_path, capsys):
    workdir = str(tmp_path)
    write_journal(workdir, 20_000, 10, seed=31)
    conf = tmp_path / "conf.yaml"
    conf.write_text(OBS_CONF)
    proc = subprocess.run(
        _engine(workdir, str(conf), "--catchup"), capture_output=True,
        text=True, timeout=180, env=dict(os.environ, PYTHONPATH=REPO),
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert any(ln.startswith("metrics: interval=100ms") and "endpoint="
               in ln for ln in lines)
    stats = json.loads(lines[-1])
    assert stats["events"] == 20_000 and stats["dropped"] == 0
    assert stats["occupancy"]["dispatches"] > 0
    assert stats["occupancy"]["compiles"]["compiles_steady"] == 0
    assert stats["xfer"]["formats"]["packed"]["bytes_per_row"] == 8.0
    assert stats["devmem"]["live"]["supported"] is False   # the CPU
    assert stats["slo"]["pass"] in (True, False)
    assert "capture" in stats

    metrics = os.path.join(workdir, "metrics.jsonl")
    recs = [json.loads(ln) for ln in open(metrics)]
    assert recs[-1]["kind"] == "final"
    assert recs[-1]["run_stats"] == stats
    att = recs[-1]["attribution"]
    assert att["writes_observed"] > 0
    # the unclamped sums agree: segments telescope to the e2e
    clamps = stats["attribution_clamps"]
    seg_sum = sum(v["sum"] for v in att["segments"].values())
    assert seg_sum - sum(clamps["segments_ms"].values()) == pytest.approx(
        att["e2e_ms"]["sum"] - clamps["e2e_ms"], abs=0.01)
    capsys.readouterr()
    for args in (["report", metrics], ["attribution", metrics],
                 ["trace", *glob.glob(os.path.join(workdir,
                                                   "trace_*.json"))]):
        assert obs_cli.main(args) == 0, args
    out = capsys.readouterr().out
    assert "window latency attribution" in out and "device_step" in out


def test_sigterm_dumps_the_flight_recorder(tmp_path):
    workdir = str(tmp_path)
    write_journal(workdir, 5_000, 10, seed=32)
    conf = tmp_path / "conf.yaml"
    conf.write_text(OBS_CONF)
    proc = subprocess.Popen(
        _engine(workdir, str(conf)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    try:
        deadline = time.monotonic() + 120
        for line in proc.stdout:
            if line.startswith("engine up:"):
                break
            assert time.monotonic() < deadline
        time.sleep(1.5)           # a few flush ticks
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["events"] == 5_000
    path = os.path.join(workdir, "flight_sigterm.jsonl")
    recs = [json.loads(ln) for ln in open(path)]
    kinds = [r["kind"] for r in recs]
    assert "tick" in kinds and "spans" in kinds
    # the ring, then the span tail (no terminal record on a signal)
    assert recs[-1]["kind"] == "spans"
    assert recs[-2]["kind"] == "signal" and recs[-2]["event"] == "sigterm"
    # the one-shot fired at the first flush with events folded
    assert [c["reason"] for c in stats["capture"]["captures"]] == [
        "oneshot"]
    trace = glob.glob(os.path.join(workdir, "xprof_*_oneshot",
                                   "trace.json"))
    assert len(trace) == 1 and json.load(open(trace[0]))["traceEvents"]


@pytest.mark.parametrize("capture", [False, True],
                         ids=["alone", "oneshot_suppressed"])
def test_cli_trace_dir_writes_a_profiler_trace(tmp_path, capture):
    workdir = str(tmp_path)
    write_journal(workdir, 20_000, 10, seed=33)
    conf = tmp_path / "conf.yaml"
    text = ('redis.host: ":inprocess:"\nkafka.topic: "ad-events"\n'
            "jax.batch.size: 1024\n")
    if capture:
        # a flush at every step: the one-shot is claimed at the first
        # flush with events and refused at the next, --traceDir holding
        # the profiler
        text += ("jax.flush.interval.ms: 1\n"
                 "jax.obs.capture.enabled: true\n"
                 "jax.obs.capture.oneshot: true\n")
    conf.write_text(text)
    trace_dir = str(tmp_path / "tdir")
    proc = subprocess.run(
        _engine(workdir, str(conf), "--catchup", "--traceDir", trace_dir),
        capture_output=True, text=True, timeout=180,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["events"] == 20_000 and stats["dropped"] == 0
    events = json.load(open(os.path.join(trace_dir,
                                         "trace.json")))["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    if capture:
        assert stats["capture"]["captures"] == []
        assert stats["capture"]["suppressed"] == 1
        assert not glob.glob(os.path.join(workdir, "xprof_*"))


@pytest.mark.parametrize("extra,conf_line,word,env,cards", [
    # jax.obs.query, jax.obs.fleet and jax.obs.shard run with --sharded
    # over as many ranks as jax.mesh.shape asks for; refused are more
    # ranks on cuda than cards, and a mesh whose rank count is not an
    # outside launcher's
    (["--sharded", "--engine", "reach", "--device", "cuda"],
     "jax.obs.query: true\njax.mesh.shape: [2]",
     "--sharded over 2 ranks: 2 ranks on cuda need 2 cards, one a rank; "
     "this host has 1", {}, 1),
    (["--sharded", "--engine", "reach"],
     "jax.obs.fleet: true\njax.mesh.shape: [2]",
     "jax.mesh.shape [2] needs 2 ranks; STREAMBENCH_NUM_PROCESSES=3",
     {"STREAMBENCH_NUM_PROCESSES": "3"}, None),
    (["--sharded", "--engine", "reach"],
     "jax.obs.shard: true\njax.mesh.shape: [2, 2]",
     "jax.mesh.shape [2, 2] needs 4 ranks; STREAMBENCH_NUM_PROCESSES=2",
     {"STREAMBENCH_NUM_PROCESSES": "2"}, None),
    (["--sharded", "--device", "cuda"],
     "jax.obs.shard: true\njax.mesh.shape: [1, 4]",
     "--sharded over 4 ranks: 4 ranks on cuda need 4 cards, one a rank; "
     "this host has 0", {}, 0),
], ids=["query", "fleet", "shard", "shard_sharded"])
def test_cli_refuses_the_obs_keys_not_ported(tmp_path, capsys, monkeypatch,
                                             extra, conf_line, word, env,
                                             cards):
    monkeypatch.delenv("STREAMBENCH_NUM_PROCESSES", raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
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


@pytest.mark.parametrize("args", [["serve", "{tmp}/missing.jsonl"],
                                  ["fleet", "{tmp}"],
                                  ["trace", "a.json", "b.json"]],
                         ids=["serve", "fleet", "trace_merge"])
def test_obs_cli_refuses_what_is_not_ported(tmp_path, capsys, args):
    """``serve``, ``fleet`` and ``trace --merge`` are ported: what they
    refuse, with exit 2 and an error line, is input they cannot read — a
    missing journal, a directory without one, several traces without
    ``--merge``."""
    assert obs_cli.main([a.format(tmp=tmp_path) for a in args]) == 2
    assert "error:" in capsys.readouterr().err


HARNESS_OBS = {"METRICS_INTERVAL_MS": "1000", "OBS_LIFECYCLE": "1",
               "FLIGHTREC": "1", "OBS_SPANS": "1", "OBS_OCCUPANCY": "1",
               "OBS_XFER": "1", "OBS_DEVMEM": "1", "OBS_CAPTURE": "1",
               "SLO_P99_MS": "15000"}


def _harness_env(workdir, port, **extra):
    return dict(os.environ, PYTHONPATH=REPO, WORKDIR=workdir,
                REDIS_PORT=str(port), TOPIC=TOPIC, DEVICE="cpu",
                PYTHONUNBUFFERED="1", **extra)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_harness_torch_test_with_obs_knobs_on_the_cpu(tmp_path):
    workdir = str(tmp_path / "run")
    harness = [sys.executable, "-m", "streambench_tpu_torch.harness"]
    env = _harness_env(workdir, _free_port(), LOAD="600", TEST_TIME="6",
                       INGEST_PIPELINE="on", VERIFY="1",
                       STOP_STATS_GRACE="2", **HARNESS_OBS)
    try:
        p = subprocess.run([*harness, "TORCH_TEST"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=240)
        assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
        conf = open(os.path.join(workdir, "localConf.yaml")).read()
        for key in ("jax.obs.lifecycle: true", "jax.obs.devmem: true",
                    "jax.obs.capture.oneshot: true", "jax.slo.p99.ms: 15000",
                    "jax.metrics.interval.ms: 1000"):
            assert key in conf
        verify = json.load(open(os.path.join(workdir, "verify.json")))
        assert verify["windows_correct"] > 0 and not (
            verify["windows_differ"] or verify["windows_missing"]
            or verify["windows_extra"])
        engine_log = open(os.path.join(workdir, "logs",
                                       "engine.log")).read()
        stats = json.loads([ln for ln in engine_log.splitlines()
                            if ln.startswith("{")][-1])
        assert stats["events"] == verify["journal_events"]
        assert stats["slo"]["pass"] is True
        assert os.path.exists(os.path.join(workdir, "flight_sigterm.jsonl"))
        assert glob.glob(os.path.join(workdir, "xprof_*", "trace.json"))
        metrics = os.path.join(workdir, "metrics.jsonl")
        assert obs_cli.main(["attribution", metrics]) == 0
        traces = glob.glob(os.path.join(workdir, "trace_*.json"))
        assert len(traces) == 1 and obs_cli.main(["trace", traces[0]]) == 0
    finally:
        subprocess.run([*harness, "STOP_ALL"], cwd=REPO, env=env,
                       capture_output=True, timeout=120)


def test_harness_sharded_with_obs_shard_on_the_cpu(tmp_path):
    """``SHARDED=1 OBS_SHARD=1``: the composite runs the sharded engine
    (one gloo rank) with the per-shard skew on; the windows are exact and
    the skew shows in the sampler's records and the stats line."""
    workdir = str(tmp_path / "run")
    harness = [sys.executable, "-m", "streambench_tpu_torch.harness"]
    env = _harness_env(workdir, _free_port(), LOAD="600", TEST_TIME="6",
                       VERIFY="1", STOP_STATS_GRACE="2", SHARDED="1",
                       OBS_SHARD="1", METRICS_INTERVAL_MS="1000")
    try:
        p = subprocess.run([*harness, "TORCH_TEST"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=240)
        assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
        conf = open(os.path.join(workdir, "localConf.yaml")).read()
        assert "jax.obs.shard: true" in conf
        verify = json.load(open(os.path.join(workdir, "verify.json")))
        assert verify["windows_correct"] > 0 and not (
            verify["windows_differ"] or verify["windows_missing"]
            or verify["windows_extra"])
        engine_log = open(os.path.join(workdir, "logs",
                                       "engine.log")).read()
        assert "mesh=1x1 backend=gloo" in engine_log
        stats = json.loads([ln for ln in engine_log.splitlines()
                            if ln.startswith("{")][-1])
        assert stats["events"] == verify["journal_events"]
        skew = stats["shard_skew"]
        assert skew["shards"] == 1 and skew["imbalance_ratio"] == 1.0
        assert skew["rows"][0] > 0 and skew["dropped"] == [0]
        records = [json.loads(ln) for ln in open(
            os.path.join(workdir, "metrics.jsonl"))]
        assert any(r.get("shard_skew", {}).get("rows") for r in records)
    finally:
        subprocess.run([*harness, "STOP_ALL"], cwd=REPO, env=env,
                       capture_output=True, timeout=120)


@pytest.mark.parametrize("knob,extra", [
    # OBS_SHARD, OBS_QUERY and OBS_FLEET run with SHARDED=1 ENGINE=reach
    # (below), and the multi-tenant host runs; the host with SHARDED=1
    # stays refused (the reference's host has no mesh), and the refusal
    # names both the host's knob and the obs knob
    ("OBS_SHARD", {"SHARDED": "1", "ENGINE": "reach", "TENANTS": "a:hll"}),
    ("OBS_QUERY", {"SHARDED": "1", "ENGINE": "reach",
                   "TENANTS": "a:exact"}),
    ("OBS_FLEET", {"SHARDED": "1", "ENGINE": "reach", "TENANTS": "a:reach",
                   "ADMISSION": "1"})],
    ids=["OBS_SHARD", "OBS_QUERY", "OBS_FLEET"])
def test_harness_refuses_the_obs_knobs_not_ported(tmp_path, knob, extra):
    workdir = str(tmp_path / "run")
    p = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.harness", "SETUP"],
        cwd=REPO, env=_harness_env(workdir, _free_port(), **{knob: "1"},
                                   **extra),
        capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "not ported" in p.stderr and knob in p.stderr
    host = next(k for k in ("MICROBATCH", "TENANTS", "ADMISSION")
                if k in extra)
    assert host in p.stderr
    assert not os.path.exists(os.path.join(workdir, "localConf.yaml"))


@pytest.mark.parametrize("knob,key", [
    ("OBS_SHARD", "jax.obs.shard"), ("OBS_QUERY", "jax.obs.query"),
    ("OBS_FLEET", "jax.obs.fleet")])
def test_harness_setup_with_sharded_reach_writes_the_obs_keys(tmp_path,
                                                              knob, key):
    """``SHARDED=1 ENGINE=reach`` with each obs knob: SETUP writes the
    knob's key (the sharded reach engine is ported)."""
    workdir = str(tmp_path / "run")
    p = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.harness", "SETUP"],
        cwd=REPO, env=_harness_env(workdir, _free_port(), SHARDED="1",
                                   ENGINE="reach", **{knob: "1"}),
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    conf = open(os.path.join(workdir, "localConf.yaml")).read()
    assert f"{key}: true" in conf


@pytest.mark.parametrize("knob,env", [
    # MICROBATCH, TENANTS and ADMISSION are ported (TENANTS and ADMISSION
    # write jax.tenants and jax.admission.enabled, as stream_bench.py
    # does: tests/test_torch_tenants.py); each case moved to a
    # combination the reference's host cannot run, still refused by name
    ("MICROBATCH", {"TENANTS": "a:hll", "MICROBATCH": "1"}),
    ("SHARDED", {"TENANTS": "a:exact,b:hll", "SHARDED": "1"}),
    ("VERIFY", {"TENANTS": "a:exact", "ADMISSION": "1", "VERIFY": "1"})],
    ids=["MICROBATCH-1", "TENANTS-a:exact,b:hll", "ADMISSION-1"])
def test_harness_refuses_the_host_knobs_not_ported(tmp_path, knob, env):
    """The multi-tenant host with a knob it has no form for: SETUP exits
    non-zero naming both instead of running another job."""
    workdir = str(tmp_path / "run")
    p = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.harness", "SETUP"],
        cwd=REPO, env=_harness_env(workdir, _free_port(), **env),
        capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert f"not ported to the PyTorch harness: TENANTS with {knob}" \
        in p.stderr
    assert not os.path.exists(os.path.join(workdir, "localConf.yaml"))
