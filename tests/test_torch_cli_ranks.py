"""``--sharded`` over N ranks from one command, against the JAX CLI over N devices.

``python -m streambench_tpu_torch.engine --sharded --device cpu`` with a
``jax.mesh.shape`` of N devices starts N gloo ranks: the process started
is rank 0 and drives the mesh, ranks 1..N-1 are its child processes and
follow.  ``python -m streambench_tpu.engine --sharded`` runs the same
mesh over N of the 8 virtual CPU devices (``tests/conftest.py``).  Both
fold one generated journal into their own RESP store (``io/fakeredis``):

- the exact engine at ``[2, 2]`` (4 ranks): the windows equal the JAX
  CLI's, ``gen.check_correct`` is exact, the ``jax.obs.shard`` skew
  equals the JAX CLI's (its shards are the campaign axis's), and each
  other rank exits 0 with its own stats line in ``engine.rank<k>.log``;
- the hll and sliding engines at ``[2]``: HLL estimates within 1 of the
  JAX CLI's (the last-place float32 sum, ROADMAP), sliding windows
  equal.

``tests/test_torch_cli_ranks_sketches.py`` holds the session and reach
engines and a resume; ``tests/test_torch_cli_ranks_lifecycle.py`` the
rank deaths, SIGTERM, an idle topic, the harness and the card check.
"""

import json
import os
import random
import signal
import subprocess
import sys
import time
from contextlib import contextmanager

import pytest
import yaml

from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    read_seen_counts,
    seed_campaigns,
)
from streambench_tpu_torch.io.resp import RespClient
from tests.test_torch_sharded import _resp_server, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CLI = "streambench_tpu_torch.engine"
JAX_CLI = "streambench_tpu.engine"


def make_journal(wd: str, events: int, seed: int, broker: str = "broker"
                 ) -> list[str]:
    """A generated journal (and the oracle's files) in ``wd``; the
    campaign ids."""
    gen.do_setup(None, default_config(),
                 broker=FileBroker(os.path.join(wd, broker)),
                 events_num=events, rng=random.Random(seed), workdir=wd)
    return gen.load_ids(wd)[0]


@contextmanager
def stores(n: int, campaigns: list[str]):
    """``n`` RESP store processes, seeded with ``campaigns``: their
    ports."""
    ports = [free_port() for _ in range(n)]
    servers = [_resp_server(p) for p in ports]
    try:
        for p in ports:
            seed_campaigns(RespClient("127.0.0.1", p), campaigns)
        yield ports
    finally:
        for s in servers:
            s.kill()
            s.communicate()


def write_conf(path, port: int, mesh: list[int], **keys) -> str:
    conf = {"redis.host": "127.0.0.1", "redis.port": port,
            "jax.mesh.shape": mesh, **keys}
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return str(path)


def cli_env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)


def cli_argv(module: str, conf: str, wd: str, *extra: str) -> list[str]:
    return [sys.executable, "-m", module, "--confPath", conf,
            "--workdir", wd, "--sharded", *extra]


def run_cli(module: str, conf: str, wd: str, *extra: str,
            timeout: float = 240) -> tuple[list[str], dict]:
    """One ``--sharded`` CLI run to its end (rc 0): its stdout lines and
    its stats line."""
    proc = subprocess.run(cli_argv(module, conf, wd, *extra),
                          capture_output=True, text=True, timeout=timeout,
                          env=cli_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    return lines, json.loads(lines[-1])


def engine_up(lines: list[str]) -> str:
    (line,) = [ln for ln in lines if ln.startswith("engine up:")]
    return line


def rows(seen: dict) -> dict:
    return {(c, w): n for c in seen for w, n in seen[c].items()}


def assert_followers_left_clean(stats: dict, wd: str, n: int) -> None:
    """Ranks 1..n-1 exited 0, each with its own stats line in its log."""
    assert [(f["rank"], f["exit_code"]) for f in stats["followers"]] == [
        (k, 0) for k in range(1, n)]
    for k in range(1, n):
        with open(os.path.join(wd, f"engine.rank{k}.log")) as f:
            last = json.loads(f.read().strip().splitlines()[-1])
        assert last["rank"] == k
        assert last["kernel_launches"]["count_cells"] == 0     # CPU


def children(pid: int) -> list[int]:
    with open(f"/proc/{pid}/task/{pid}/children") as f:
        return [int(p) for p in f.read().split()]


def alive(pid: int) -> bool:
    """Running, and not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def await_line(path: str, word: str, proc, timeout: float = 120) -> None:
    """Wait until ``path`` holds ``word`` (a running CLI's stdout)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(path) as f:
            if word in f.read():
                return
        assert proc.poll() is None, open(path).read()[-3000:]
        time.sleep(0.1)
    raise AssertionError(f"no {word!r} in {path} within {timeout} s")


def stop(proc, sig=signal.SIGKILL) -> None:
    if proc.poll() is None:
        proc.send_signal(sig)
    proc.wait(timeout=60)


def test_exact_at_2x2_runs_four_ranks_as_the_jax_cli_four_devices(
        tmp_path):
    wd = str(tmp_path)
    campaigns = make_journal(wd, 20_000, seed=21)
    with stores(2, campaigns) as (mine, ref):
        shard = {"jax.obs.shard": True}
        lines, stats = run_cli(
            PORT_CLI, write_conf(tmp_path / "port.yaml", mine, [2, 2],
                                 **shard), wd, "--catchup", "--device", "cpu")
        _, want = run_cli(JAX_CLI, write_conf(tmp_path / "jax.yaml", ref,
                                              [2, 2], **shard),
                          wd, "--catchup")
        assert "mesh=2x2 backend=gloo ranks=4" in engine_up(lines)
        assert stats["events"] == want["events"] == 20_000
        assert stats["dropped"] == want["dropped"] == 0
        assert_followers_left_clean(stats, wd, 4)
        # the skew over the campaign axis's shards, as the JAX CLI's
        assert stats["shard_skew"]["shards"] == 2
        for key in ("shards", "rows", "wanted", "dropped"):
            assert stats["shard_skew"][key] == want["shard_skew"][key], key
        got = read_seen_counts(RespClient("127.0.0.1", mine))
        assert got == read_seen_counts(RespClient("127.0.0.1", ref)) and got
        correct, differ, missing = gen.check_correct(
            RespClient("127.0.0.1", mine), wd, log=lambda s: None)
        assert differ == 0 and missing == 0 and correct > 0


@contextmanager
def sketch_at_2(tmp_path, engine: str):
    """``--sharded --engine ENGINE`` at ``[2]`` in both CLIs over one
    journal: (port stdout, port stats, port store, JAX store), the stores
    open while the caller checks them."""
    wd = str(tmp_path)
    campaigns = make_journal(wd, 10_000, seed=22)

    def keys(side: str) -> dict:
        # reach ships its close-time planes, read after the engine closed
        ship = ({"jax.reach.ship.dir": str(tmp_path / f"ship_{side}")}
                if engine == "reach" else {})
        return {"jax.window.slots": 128, **ship}

    with stores(2, campaigns) as (mine, ref):
        lines, stats = run_cli(
            PORT_CLI, write_conf(tmp_path / "port.yaml", mine, [2],
                                 **keys("port")),
            wd, "--catchup", "--device", "cpu", "--engine", engine)
        run_cli(JAX_CLI, write_conf(tmp_path / "jax.yaml", ref, [2],
                                    **keys("jax")),
                wd, "--catchup", "--engine", engine)
        assert f"engine={engine}" in engine_up(lines)
        assert "mesh=2x1 backend=gloo ranks=2" in engine_up(lines)
        assert stats["events"] == 10_000 and stats["dropped"] == 0
        assert_followers_left_clean(stats, wd, 2)
        yield (lines, stats, RespClient("127.0.0.1", mine),
               RespClient("127.0.0.1", ref))


@pytest.mark.parametrize("engine", ["hll", "sliding"])
def test_sketch_engine_at_2_ranks_as_the_jax_cli(tmp_path, engine):
    with sketch_at_2(tmp_path, engine) as (_, _, got, want):
        g, w = rows(read_seen_counts(got)), rows(read_seen_counts(want))
        assert set(g) == set(w) and g
        if engine == "hll":
            # the estimate's last float32 place (ROADMAP, queue 3)
            assert max(abs(g[k] - w[k]) for k in w) <= 1
        else:
            assert g == w
            assert len(got.hgetall("t1_quantiles")) == len(
                want.hgetall("t1_quantiles")) > 0
