"""The port's harness (``python -m streambench_tpu_torch.harness``) end to
end on the CPU.

The composite is the ``FLINK_TEST`` shape, ``TORCH_TEST``: a RESP server
process, the engine process (``DEVICE=cpu``, the staged pipeline on, two
encode workers), the paced generator process, then ``-g`` stats into
``seen.txt``/``updated.txt``.  As ``tests/test_harness.py`` does for the
JAX harness, the load phase ends on observed window progress rather than
a fixed sleep, under a hard deadline of its own; ``VERIFY`` then holds
every window in Redis against the generator's oracle over the journal
the load wrote — once over the file journal, once over the fake Kafka
broker process.  Then the harness's own lifecycle rules: unknown ops,
re-runnable STOPs, recycled pids, adopted services, and the
"measured no window rows" failure.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import time

import pytest

from streambench_tpu_torch.io.fakeredis import FakeRedisServer
from streambench_tpu_torch.io.redis_schema import read_stats
from streambench_tpu_torch.io.resp import RespClient
from streambench_tpu_torch.utils import pidfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_harness(ops, env_extra, timeout=120):
    env = dict(os.environ, **env_extra, PYTHONUNBUFFERED="1",
               PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.harness", *ops],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def _await_window_progress(port: int, min_windows: int,
                           deadline_s: float) -> int:
    deadline = time.monotonic() + deadline_s
    n = 0
    while time.monotonic() < deadline:
        try:
            with RespClient("127.0.0.1", port, timeout_s=2.0) as c:
                n = len(read_stats(c))
        except OSError:
            n = 0
        if n >= min_windows:
            return n
        time.sleep(0.5)
    raise AssertionError(
        f"only {n}/{min_windows} windows visible after {deadline_s}s")


@pytest.mark.parametrize("kafka", [False, True], ids=["journal",
                                                      "fake_kafka"])
def test_torch_test_end_to_end_on_cpu(tmp_path, kafka):
    wd = str(tmp_path / "run")
    port = free_port()
    env = {"WORKDIR": wd, "REDIS_PORT": str(port), "LOAD": "400",
           "STOP_STATS_GRACE": "3", "TOPIC": "ad-events", "DEVICE": "cpu",
           "INGEST_PIPELINE": "on", "ENCODE_WORKERS": "2"}
    up_ops = ["SETUP", "START_REDIS", "START_TORCH_PROCESSING",
              "START_LOAD"]
    down_ops = ["STOP_LOAD", "STOP_TORCH_PROCESSING", "VERIFY"]
    if kafka:
        env.update(KAFKA_FAKE="1", KAFKA_BROKERS=f"127.0.0.1:{free_port()}")
        up_ops.insert(2, "START_KAFKA")
    up = run_harness(up_ops, env, timeout=180)
    try:
        assert up.returncode == 0, up.stdout + up.stderr
        _await_window_progress(port, min_windows=3, deadline_s=90)
    finally:
        down = run_harness(down_ops, env, timeout=180)
        stop = run_harness(["STOP_KAFKA", "STOP_REDIS", "STOP_ALL"], env)
    assert down.returncode == 0, down.stdout + down.stderr
    assert stop.returncode == 0, stop.stdout + stop.stderr

    seen = open(os.path.join(wd, "seen.txt")).read().split()
    updated = open(os.path.join(wd, "updated.txt")).read().split()
    assert seen and len(seen) == len(updated)
    assert all(int(s) > 0 for s in seen)

    engine_log = open(os.path.join(wd, "logs", "engine.log")).read()
    assert "device=cpu" in engine_log and "pipeline=on" in engine_log
    stats = json.loads(engine_log.strip().splitlines()[-1])
    load_log = open(os.path.join(wd, "logs", "load.log")).read()
    emitted = int(load_log.split("emitted ")[-1].split()[0])
    assert stats["events"] == emitted > 0
    assert stats["dropped"] == 0

    verdict = json.load(open(os.path.join(wd, "verify.json")))
    assert verdict["journal_events"] == emitted
    assert verdict["windows_correct"] > 0
    assert (verdict["windows_differ"], verdict["windows_missing"],
            verdict["windows_extra"]) == (0, 0, 0)
    for name in ("redis", "engine", "load", "kafka"):
        assert not os.path.exists(os.path.join(wd, "pids", f"{name}.pid"))


def test_torch_test_composite_in_one_call(tmp_path):
    """``TORCH_TEST`` itself, one call: services, engine, a short paced
    load, stats, ``VERIFY=1``, teardown.  The load starts only once the
    engine printed ``engine up:``, so its seconds are all stream."""
    wd = str(tmp_path / "run")
    p = run_harness(["TORCH_TEST"], {
        "WORKDIR": wd, "REDIS_PORT": str(free_port()), "LOAD": "400",
        "TEST_TIME": "6", "STOP_STATS_GRACE": "3", "DEVICE": "cpu",
        "INGEST_PIPELINE": "on", "VERIFY": "1"}, timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "TORCH_TEST evidence:" in p.stdout
    verdict = json.load(open(os.path.join(wd, "verify.json")))
    assert verdict["windows_correct"] > 0 and verdict["journal_events"] > 0
    assert not os.listdir(os.path.join(wd, "pids"))


def test_torch_test_with_device_decode_on_cpu(tmp_path):
    """``TORCH_TEST`` with ``DECODE_DEVICE=on``: the engine decodes the
    journal's raw blocks on its device (here the CPU, through the decode
    kernel's plain version) and ``VERIFY`` finds every window exact."""
    wd = str(tmp_path / "run")
    p = run_harness(["TORCH_TEST"], {
        "WORKDIR": wd, "REDIS_PORT": str(free_port()), "LOAD": "400",
        "TEST_TIME": "6", "STOP_STATS_GRACE": "3", "DEVICE": "cpu",
        "DECODE_DEVICE": "on", "VERIFY": "1"}, timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    engine_log = open(os.path.join(wd, "logs", "engine.log")).read()
    assert "decode=device" in engine_log
    stats = json.loads(engine_log.strip().splitlines()[-1])
    assert stats["events"] > 0 and stats["dropped"] == 0
    assert stats["kernel_launches"] == {"count_cells": 0, "decode_rows": 0,
                                        "cms_rows": 0}
    verdict = json.load(open(os.path.join(wd, "verify.json")))
    assert verdict["journal_events"] == stats["events"]
    assert verdict["windows_correct"] > 0
    assert (verdict["windows_differ"], verdict["windows_missing"],
            verdict["windows_extra"]) == (0, 0, 0)


def test_unknown_operation_lists_supported(tmp_path):
    proc = run_harness(["NO_SUCH_OP"], {"WORKDIR": str(tmp_path)})
    assert proc.returncode == 1
    assert "UNKNOWN OPERATION" in proc.stdout
    assert "TORCH_TEST" in proc.stdout


def test_ops_are_rerunnable(tmp_path):
    """STOP on nothing is a no-op, like stop_if_needed (stream-bench.sh:66)."""
    proc = run_harness(["STOP_ALL"], {"WORKDIR": str(tmp_path / "run")})
    assert proc.returncode == 0
    assert "No running instances" in proc.stdout


@pytest.fixture
def hm(tmp_path, monkeypatch):
    """The harness module with its paths pinned to ``tmp_path``."""
    monkeypatch.setenv("WORKDIR", str(tmp_path))
    from streambench_tpu_torch import harness

    mod = importlib.reload(harness)
    yield mod
    monkeypatch.delenv("WORKDIR")
    importlib.reload(harness)


def test_pidfile_starttime_match(hm):
    """A pidfile whose recorded start time no longer matches reads as
    not running, so STOP never signals a recycled pid."""
    os.makedirs(hm.PID_DIR, exist_ok=True)
    me = os.getpid()
    started = pidfile.proc_starttime(me)
    assert started is not None
    with open(hm._pidfile("redis"), "w") as f:
        f.write(f"{me} {started}")
    assert hm.running_pid("redis") == me
    with open(hm._pidfile("redis"), "w") as f:
        f.write(f"{me} 12345")
    assert hm.running_pid("redis") is None
    hm.stop_if_needed("redis")            # a no-op: we are still alive
    with open(hm._pidfile("redis"), "w") as f:
        f.write(str(me))                  # a bare pid still works
    assert hm.running_pid("redis") == me
    os.remove(hm._pidfile("redis"))


def test_pidfile_acquire_refuses_a_live_slot(tmp_path):
    path = str(tmp_path / "pids" / "role_0")
    assert pidfile.acquire_pidfile(path) == os.getpid()
    assert pidfile.pidfile_alive(path) == os.getpid()
    assert pidfile.acquire_pidfile(path) is None     # slot is taken
    pidfile.release_pidfile(path)
    assert not os.path.exists(path)
    with open(path, "w") as f:
        f.write("999999999 1")                       # dead: overwritten
    assert pidfile.acquire_pidfile(path) == os.getpid()


def test_external_redis_adopted_not_stopped(hm, monkeypatch):
    """A server already answering at REDIS_HOST:REDIS_PORT is adopted
    (a marker file, not a pidfile) and STOP leaves it running."""
    srv = FakeRedisServer(host="127.0.0.1", port=0).start()
    try:
        monkeypatch.setattr(hm, "REDIS_PORT", srv.port)
        assert hm._redis_alive()
        assert hm.running_pid("redis") is None
        hm._adopt("redis", f"127.0.0.1:{srv.port}")
        hm.op_stop_redis()
        assert not os.path.exists(hm._external_marker("redis"))
        with RespClient("127.0.0.1", srv.port, timeout_s=2.0) as c:
            assert c.ping() == "PONG"
        hm.op_stop_redis()                # no marker, no pidfile: no-op
    finally:
        srv.stop()


def test_torch_test_without_window_rows_fails(hm, monkeypatch):
    """A composite that produced load but measured nothing fails."""
    for op in ("op_setup", "op_start_redis", "op_start_torch_processing",
               "op_start_load", "op_stop_load",
               "op_stop_torch_processing", "op_stop_redis"):
        monkeypatch.setattr(hm, op, lambda: None)
    monkeypatch.setattr(hm, "TEST_TIME", 0.0)
    with pytest.raises(SystemExit, match="measured no window rows"):
        hm.op_torch_test()


def test_verify_reports_a_window_that_differs(hm, tmp_path, monkeypatch):
    """VERIFY compares every window both ways: a count off by one in the
    store is a failure, recorded in verify.json."""
    from streambench_tpu_torch.config import write_local_conf
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.io.journal import FileBroker
    from streambench_tpu_torch.io.redis_schema import (seed_campaigns,
                                                       write_window)

    srv = FakeRedisServer(host="127.0.0.1", port=0).start()
    try:
        monkeypatch.setattr(hm, "REDIS_PORT", srv.port)
        write_local_conf(hm.CONF_FILE, {"kafka.topic": "ad-events",
                                        "redis.port": srv.port})
        gen.do_new_setup(RespClient("127.0.0.1", srv.port),
                         num_campaigns=3, ads_per_campaign=2,
                         workdir=str(tmp_path))
        campaigns, ads = gen.load_ids(str(tmp_path))
        mapping = gen.load_ad_mapping_file(
            str(tmp_path / gen.AD_TO_CAMPAIGN_FILE))
        lines = [
            json.dumps({"user_id": "u", "page_id": "p", "ad_id": ads[i % 6],
                        "ad_type": "banner", "event_type": "view",
                        "event_time": str(1_000_000 + 10 * i),
                        "ip_address": "1.2.3.4"}).encode()
            for i in range(12)]
        with FileBroker(hm.BROKER_DIR).writer("ad-events") as w:
            w.append_many(lines)
        counts = {}
        for line in lines:
            ev = json.loads(line)
            key = (mapping[ev["ad_id"]], int(ev["event_time"]) // 10_000
                   * 10_000)
            counts[key] = counts.get(key, 0) + 1
        with RespClient("127.0.0.1", srv.port) as r:
            seed_campaigns(r, campaigns)
            for (campaign, ts), n in counts.items():
                write_window(r, campaign, ts, n, time_updated=2_000_000)
        hm.op_verify()
        ok = json.load(open(hm.VERIFY_FILE))
        assert ok["journal_events"] == 12 and ok["windows_correct"] == 3
        with RespClient("127.0.0.1", srv.port) as r:
            write_window(r, *next(iter(counts)), 1, time_updated=2_000_001)
        with pytest.raises(SystemExit, match="do not match"):
            hm.op_verify()
        bad = json.load(open(hm.VERIFY_FILE))
        assert bad["windows_differ"] == 1
    finally:
        srv.stop()


class _CountingSink:
    """A journal writer that counts the records it holds; ``on_write``
    runs after each write (a signal landing right after it)."""

    def __init__(self, on_write=None):
        self.records = 0
        self.on_write = on_write

    def append_many(self, lines):
        self.records += len(lines)
        if self.on_write is not None:
            self.on_write()

    def flush(self):
        pass


def _ids(workdir):
    from streambench_tpu_torch.datagen import gen

    gen.write_ids([f"c{i}" for i in range(3)], [f"a{i}" for i in range(9)],
                  str(workdir))


def test_paced_generator_counts_exactly_what_it_wrote(tmp_path):
    """The generator's SIGTERM raises a flag checked between batches, so
    "emitted N" is exactly what reached the sink.  The JAX generator's
    handler raises ``SystemExit``; landing after a write and before the
    count, it reports fewer events than the sink holds — the case the
    port's ``stop`` closes (queue 3 of ROADMAP.md)."""
    from streambench_tpu.datagen import gen as jax_gen
    from streambench_tpu_torch.datagen import gen

    _ids(tmp_path)
    flag = {"stop": False}
    sink = _CountingSink(on_write=lambda: flag.update(stop=True))
    sent = gen.run_paced(sink, 2_000, duration_s=5, workdir=str(tmp_path),
                         stop=lambda: flag["stop"])
    assert sent == sink.records > 0

    def interrupt():
        raise SystemExit(0)

    jax_sink = _CountingSink(on_write=interrupt)
    jax_sent = jax_gen.run_paced(jax_sink, 2_000, duration_s=5,
                                 workdir=str(tmp_path))
    assert jax_sent == 0 < jax_sink.records
