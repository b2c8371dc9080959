"""``--sharded`` over 2 ranks: what ends the run, on gloo ranks on the CPU.

- A killed follower (SIGKILL) ends rank 0 with exit 1, naming the rank.
- An idle topic: with the groups' timeout cut to 5 s
  (``STREAMBENCH_MESH_TIMEOUT_S``) and a flush a minute (a flush is a
  call to every rank, at 1 s by default), rank 0 tails an empty topic for
  more than three times the timeout before the journal lands; then
  SIGTERM folds it and every rank exits 0, the windows exact.
- An outside launcher: two processes started with
  ``STREAMBENCH_NUM_PROCESSES``, ``_PROCESS_ID`` and ``_COORDINATOR``
  set each take their rank and start none; the windows exact.
- The harness: ``SHARDED=1 VERIFY=1 TORCH_TEST`` with a conf of
  ``jax.mesh.shape: [2]`` runs the engine process as rank 0 of two.
- More ranks on ``cuda`` than cards is refused by name, with the card
  count patched: ``parallel/mesh.py`` and the CLI before any rank starts.

Helpers are ``tests/test_torch_cli_ranks.py``'s.
"""

import json
import os
import signal
import subprocess
import time

import pytest
import torch
import torch.distributed as dist

from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import __main__ as cli
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.resp import RespClient
from streambench_tpu_torch.parallel import mesh as M
from tests.test_torch_cli_ranks import (
    PORT_CLI,
    REPO,
    alive,
    await_line,
    children,
    cli_argv,
    cli_env,
    make_journal,
    stop,
    stores,
    write_conf,
)
from tests.test_torch_harness import run_harness
from tests.test_torch_sharded import free_port

TOPIC = default_config().kafka_topic
MESH_TIMEOUT_S = 5


def start_cli(tmp_path, conf: str, wd: str, broker: str, **env):
    """A tailing ``--sharded`` CLI at 2 ranks, up: (process, its stdout
    path, the other rank's pid)."""
    out = os.path.join(wd, "cli.out")
    with open(out, "w") as f:
        proc = subprocess.Popen(
            cli_argv(PORT_CLI, conf, wd, "--device", "cpu", "--brokerDir",
                     broker), stdout=f, stderr=subprocess.STDOUT,
            env=cli_env(**env), cwd=REPO)
    try:
        await_line(out, "engine up:", proc)
        (follower,) = children(proc.pid)
    except BaseException:
        stop(proc)
        raise
    return proc, out, follower


def test_a_killed_follower_ends_rank0_non_zero(tmp_path):
    wd = str(tmp_path)
    campaigns = make_journal(wd, 10_000, seed=24)
    with stores(1, campaigns) as (port,):
        conf = write_conf(tmp_path / "conf.yaml", port, [2])
        proc, out, follower = start_cli(tmp_path, conf, wd,
                                        os.path.join(wd, "broker"))
        try:
            os.kill(follower, signal.SIGKILL)
            proc.wait(timeout=30)
        finally:
            stop(proc)
        assert proc.returncode == 1
        assert "error: rank 1 exited with code -9 before rank 0 closed" in (
            open(out).read())
        assert not alive(follower)


def test_an_idle_topic_outlasts_the_timeout_and_sigterm_ends_every_rank(
        tmp_path):
    wd = str(tmp_path)
    campaigns = make_journal(wd, 15_000, seed=25, broker="full")
    live = FileBroker(os.path.join(wd, "live"))
    live.create_topic(TOPIC)
    with stores(1, campaigns) as (port,):
        conf = write_conf(tmp_path / "conf.yaml", port, [2],
                          **{"jax.flush.interval.ms": 60_000})
        proc, out, follower = start_cli(
            tmp_path, conf, wd, os.path.join(wd, "live"),
            STREAMBENCH_MESH_TIMEOUT_S=str(MESH_TIMEOUT_S))
        try:
            time.sleep(3 * MESH_TIMEOUT_S + 1)
            assert proc.poll() is None and alive(follower)
            with live.writer(TOPIC) as w:
                w.append_many(list(FileBroker(os.path.join(
                    wd, "full")).read_all(TOPIC)))
            time.sleep(1)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
        finally:
            stop(proc)
        text = open(out).read()
        assert proc.returncode == 0, text[-3000:]
        stats = json.loads(text.strip().splitlines()[-1])
        assert stats["events"] == 15_000 and stats["dropped"] == 0
        assert stats["followers"][0]["exit_code"] == 0
        assert not alive(follower)
        correct, differ, missing = gen.check_correct(
            RespClient("127.0.0.1", port), wd, log=lambda s: None)
        assert differ == 0 and missing == 0 and correct > 0


def test_an_outside_launcher_starts_each_rank(tmp_path):
    wd = str(tmp_path)
    campaigns = make_journal(wd, 10_000, seed=26)
    coordinator = f"127.0.0.1:{free_port()}"
    with stores(1, campaigns) as (port,):
        conf = write_conf(tmp_path / "conf.yaml", port, [2])
        procs = [subprocess.Popen(
            cli_argv(PORT_CLI, conf, wd, "--catchup", "--device", "cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=cli_env(STREAMBENCH_NUM_PROCESSES="2",
                        STREAMBENCH_PROCESS_ID=str(rank),
                        STREAMBENCH_COORDINATOR=coordinator), cwd=REPO)
            for rank in (0, 1)]
        try:
            outs = [p.communicate(timeout=120) for p in procs]
        finally:
            for p in procs:
                stop(p)
        assert [p.returncode for p in procs] == [0, 0], outs[0][1][-3000:]
        stats = json.loads(outs[0][0].strip().splitlines()[-1])
        assert stats["events"] == 10_000 and "followers" not in stats
        assert json.loads(outs[1][0].strip().splitlines()[-1])["rank"] == 1
        assert not list(tmp_path.glob("engine.rank*.log"))
        correct, differ, missing = gen.check_correct(
            RespClient("127.0.0.1", port), wd, log=lambda s: None)
        assert differ == 0 and missing == 0 and correct > 0


def test_harness_sharded_verify_over_two_ranks(tmp_path):
    wd = str(tmp_path / "run")
    os.makedirs(wd)
    with open(os.path.join(wd, "localConf.yaml"), "w") as f:
        f.write("jax.mesh.shape: [2]\n")
    env = {"WORKDIR": wd, "REDIS_PORT": str(free_port()), "LOAD": "400",
           "TEST_TIME": "6", "STOP_STATS_GRACE": "2", "TOPIC": "ad-events",
           "DEVICE": "cpu", "SHARDED": "1", "VERIFY": "1",
           "OMP_NUM_THREADS": "1"}
    try:
        proc = run_harness(["TORCH_TEST"], env, timeout=240)
    finally:
        run_harness(["STOP_ALL"], env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    verify = json.load(open(os.path.join(wd, "verify.json")))
    assert verify["windows_correct"] > 0
    assert verify["windows_differ"] == verify["windows_missing"] == 0
    assert verify["windows_extra"] == 0
    log = open(os.path.join(wd, "logs", "engine.log")).read()
    assert "mesh=2x1 backend=gloo ranks=2" in log
    stats = json.loads(log.strip().splitlines()[-1])
    assert stats["followers"][0]["exit_code"] == 0
    assert stats["events"] == verify["journal_events"] > 0
    assert os.path.exists(os.path.join(wd, "engine.rank1.log"))


def test_more_ranks_than_cards_is_refused_by_name(monkeypatch, tmp_path,
                                                  capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    cuda = torch.device("cuda")
    assert M.rank_device(cuda, 0) == torch.device("cuda", 0)
    assert M.rank_device(torch.device("cuda", 0), 1) == torch.device(
        "cuda", 0)
    assert M.rank_device(torch.device("cpu"), 3) == torch.device("cpu")
    words = "2 ranks on cuda need 2 cards, one a rank; this host has 1"
    with pytest.raises(ValueError, match=words):
        M.rank_device(cuda, 1)
    with pytest.raises(ValueError, match=words):
        M.init_process_group("cuda", num_processes=2, process_id=0,
                             coordinator_address="127.0.0.1:1")
    # the CLI, before any rank starts: a subprocess that would spawn one
    # would leave its log in the workdir; and a card named for every rank
    conf = write_conf(tmp_path / "conf.yaml", 1, [2])
    monkeypatch.delenv("STREAMBENCH_NUM_PROCESSES", raising=False)
    assert cli.main(["--confPath", conf, "--workdir", str(tmp_path),
                     "--sharded", "--device", "cuda:0"]) == 2
    assert ("error: --sharded over 2 ranks puts rank k on cuda:k; it takes "
            "--device cuda, not cuda:0") in capsys.readouterr().err
    proc = subprocess.run(
        cli_argv(PORT_CLI, conf, str(tmp_path), "--catchup"),
        capture_output=True, text=True, timeout=120,
        env=cli_env(CUDA_VISIBLE_DEVICES=""), cwd=REPO)
    assert proc.returncode == 2
    assert ("error: --sharded over 2 ranks: 2 ranks on cuda need 2 cards, "
            "one a rank; this host has 0") in proc.stderr
    assert not list(tmp_path.glob("engine.rank*.log"))
