"""``--sharded`` over 2 ranks: the session and reach engines against the
JAX CLI over 2 devices, and a resume after rank 0 is killed.

The session engine's heavy hitters (``<hashtable>_hh``) equal the JAX
CLI's; the reach engine's estimates at close (``<hashtable>_reach``)
agree within 1 (the HLL estimate's last float32 place, ROADMAP), and
the planes each CLI ships at close (``jax.reach.ship.dir``, read by the
port's replica) are bit-identical.

The resume: rank 0 tails a topic that holds half of a journal, with
``jax.sink.exactly_once`` and a checkpoint at every flush.  Once a
checkpoint holds events it is killed (SIGKILL): the other rank is gone
within 10 s.  The rest of the journal lands, the same command runs again
and resumes, and its windows equal an uninterrupted (unsharded) run's and
the oracle's.  Helpers are ``tests/test_torch_cli_ranks.py``'s.
"""

import os
import signal
import subprocess
import time

import numpy as np
import pytest

from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import read_seen_counts
from streambench_tpu_torch.io.resp import RespClient
from tests.test_torch_cli_ranks import (
    PORT_CLI,
    REPO,
    alive,
    await_line,
    children,
    cli_argv,
    cli_env,
    make_journal,
    rows,
    run_cli,
    sketch_at_2,
    stop,
    stores,
    write_conf,
)
from tests.test_torch_sharded_reach import _ship_planes

TOPIC = default_config().kafka_topic


@pytest.mark.parametrize("engine", ["session", "reach"])
def test_sketch_engine_at_2_ranks_as_the_jax_cli(tmp_path, engine):
    with sketch_at_2(tmp_path, engine) as (lines, stats, got, want):
        assert stats["windows_written"] == 0
        table = f"t1_{'hh' if engine == 'session' else 'reach'}"
        g, w = got.hgetall(table), want.hgetall(table)
        assert g and set(g) == set(w)
        if engine == "session":
            assert g == w
        else:
            assert any(ln.startswith("reach: pubsub=") for ln in lines)
            assert stats["reach"]["served"] == 0
            assert max(abs(int(g[k]) - int(w[k])) for k in w) <= 1
            assert stats["reach"]["ship"]["ships"] > 0
            for a, b in zip(_ship_planes(str(tmp_path / "ship_port")),
                            _ship_planes(str(tmp_path / "ship_jax"))):
                assert np.array_equal(np.asarray(a), np.asarray(b))


def test_resume_after_rank0_is_killed_equals_an_uninterrupted_run(
        tmp_path):
    wd = str(tmp_path)
    campaigns = make_journal(wd, 20_000, seed=23, broker="full")
    lines = list(FileBroker(os.path.join(wd, "full")).read_all(TOPIC))
    live = FileBroker(os.path.join(wd, "live"))
    live.create_topic(TOPIC)
    with live.writer(TOPIC) as w:
        w.append_many(lines[:10_000])
    ckpt = os.path.join(wd, "ckpt")
    with stores(2, campaigns) as (mine, ref):
        conf = write_conf(tmp_path / "conf.yaml", mine, [2],
                          **{"jax.sink.exactly_once": True,
                             "jax.checkpoint.interval.ms": 0})
        argv = cli_argv(PORT_CLI, conf, wd, "--device", "cpu",
                        "--brokerDir", os.path.join(wd, "live"),
                        "--checkpointDir", ckpt, "--idleTimeout", "4")
        out = os.path.join(wd, "first.out")
        with open(out, "w") as f:
            first = subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT,
                                     env=cli_env(), cwd=REPO)
        try:
            await_line(out, "engine up:", first)
            followers = children(first.pid)
            assert len(followers) == 1
            deadline = time.monotonic() + 60
            while True:
                snap = Checkpointer(ckpt).load()
                if snap is not None and snap.meta["events_processed"]:
                    break
                assert time.monotonic() < deadline, open(out).read()[-3000:]
                time.sleep(0.05)
            first.send_signal(signal.SIGKILL)
            killed = time.monotonic()
            while any(alive(p) for p in followers):
                assert time.monotonic() - killed < 10, "a rank outlived rank 0"
                time.sleep(0.05)
        finally:
            stop(first)
        assert first.returncode == -signal.SIGKILL
        with live.writer(TOPIC) as w:
            w.append_many(lines[10_000:])
        second, stats = run_cli(PORT_CLI, conf, wd, "--device", "cpu",
                                "--brokerDir", os.path.join(wd, "live"),
                                "--checkpointDir", ckpt, "--idleTimeout", "4")
        assert any(ln.startswith("resumed from checkpoint:")
                   for ln in second)
        assert 0 < stats["events"] < 20_000
        assert [f["exit_code"] for f in stats["followers"]] == [0]

        # the uninterrupted run: the unsharded engine over the journal
        cfg = default_config()
        eng = AdAnalyticsEngine(cfg, gen.load_ad_mapping_file(
            os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE)), campaigns=campaigns,
            redis=RespClient("127.0.0.1", ref), device="cpu")
        StreamRunner(eng, live.reader(TOPIC)).run_catchup()
        eng.close()
        got = rows(read_seen_counts(RespClient("127.0.0.1", mine)))
        assert got == rows(read_seen_counts(RespClient("127.0.0.1", ref)))
        correct, differ, missing = gen.check_correct(
            RespClient("127.0.0.1", mine), wd, log=lambda s: None)
        assert differ == 0 and missing == 0 and correct > 0
