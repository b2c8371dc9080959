"""The port's multi-process engine, with real process separation: gloo
ranks on the CPU (one per mesh device), one shared RESP server, each rank
consuming its own topic partition and flushing only the campaign shard
it owns -- then the generator's oracle over the combined Redis state.

As ``tests/test_distributed.py`` runs the JAX package's: there two
processes of four virtual devices each, here 2 and 4 ranks of one
device each, both on a mesh with a campaign axis of 2.  Each rank has
its own ``communicate(timeout=...)``.
"""

import json
import os
import random
import socket
import subprocess
import sys
import time

import pytest

from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    seed_ad_mapping,
    seed_campaigns,
)
from streambench_tpu_torch.io.resp import RespClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.resp import RespClient
from streambench_tpu_torch.parallel import (
    DistributedWindowEngine, global_mesh, init_distributed,
    run_distributed_catchup)

pid = int(sys.argv[1]); n = int(sys.argv[2])
workdir = sys.argv[3]; coord = sys.argv[4]; redis_port = int(sys.argv[5])

ctx = init_distributed(coord, n, pid, device="cpu", timeout_s=120)
assert ctx.num_processes == n and ctx.is_coordinator == (pid == 0)
mesh = global_mesh(campaign=2, device="cpu")
cfg = default_config(jax_batch_size=256)
mapping = gen.load_ad_mapping_file(
    os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE))
campaigns, _ = gen.load_ids(workdir)
base = int(open(os.path.join(workdir, "base_time.txt")).read())
r = RespClient("127.0.0.1", redis_port)
eng = DistributedWindowEngine(cfg, mapping, mesh, base_time_ms=base,
                              campaigns=campaigns, redis=r, device="cpu")
reader = FileBroker(os.path.join(workdir, "broker")).reader(
    cfg.kafka_topic, pid)
stats = run_distributed_catchup(eng, reader, flush_every=4)
# one more lockstep step through the per-step path (a span vote, a fold
# of no events on every rank)
eng.process_lines([])
eng.close()
print(json.dumps(dict(pid=pid, events=eng.events_processed,
                      dropped=eng.dropped, mesh=mesh.size,
                      shape=[mesh.shape["data"], mesh.shape["campaign"]],
                      windows_written=eng.windows_written,
                      steps=stats["steps"], votes=stats["votes"],
                      vote_s=stats["vote_s"])),
      flush=True)
# leave together: a rank that exits with its groups alive can abort
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_distributed_engine_oracle(tmp_path, nproc):
    wd = str(tmp_path)
    cfg = default_config(jax_batch_size=256)
    broker = FileBroker(os.path.join(wd, "broker"))
    # no Redis seeding here; the ranks write, the oracle reads
    gen.do_setup(None, cfg, broker=broker, events_num=6000,
                 rng=random.Random(13), workdir=wd, partitions=nproc)
    # shared rebase origin, derived from the dataset's first event as the
    # encoder's own rebase does, but agreed across ranks up front
    first = json.loads(next(iter(broker.read_all(cfg.kafka_topic))))
    t0 = int(first["event_time"])
    base = t0 - (t0 % 10_000) - 60_000
    with open(os.path.join(wd, "base_time.txt"), "w") as f:
        f.write(str(base))

    redis_port = free_port()
    coord_port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    server = subprocess.Popen(
        [sys.executable, "-m", "streambench_tpu_torch.io.fakeredis",
         "--host", "127.0.0.1", "--port", str(redis_port)],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    workers = []
    try:
        for _ in range(200):
            try:
                RespClient("127.0.0.1", redis_port).ping()
                break
            except OSError:
                time.sleep(0.05)
        # the join side-table and the campaigns index (what -n/-s writes
        # to a live Redis); the oracle walks SMEMBERS campaigns
        rc = RespClient("127.0.0.1", redis_port)
        campaigns, _ = gen.load_ids(wd)
        seed_campaigns(rc, campaigns)
        seed_ad_mapping(rc, gen.load_ad_mapping_file(
            os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE)))

        script = WORKER.format(repo=REPO)
        for pid in range(nproc):
            workers.append(subprocess.Popen(
                [sys.executable, "-c", script, str(pid), str(nproc), wd,
                 f"127.0.0.1:{coord_port}", str(redis_port)],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = []
        for w in workers:
            out, err = w.communicate(timeout=180)
            assert w.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
        assert all(o["mesh"] == nproc for o in outs)
        assert all(o["shape"] == [nproc // 2, 2] for o in outs)
        assert sum(o["events"] for o in outs) == 6000
        assert all(o["dropped"] == 0 for o in outs)
        # the batched vote fires once per ROUND, not per step
        assert all(o["votes"] <= o["steps"] // 2 + 2 for o in outs), outs
        assert all(o["steps"] == outs[0]["steps"] for o in outs), outs
        # one owner rank per campaign shard (2 shards here), spread over
        # the replicas rather than all landing on rank 0
        writers = sum(1 for o in outs if o["windows_written"] > 0)
        assert writers == 2, outs

        r = RespClient("127.0.0.1", redis_port)
        correct, differ, missing = gen.check_correct(r, wd,
                                                     log=lambda s: None)
        assert differ == 0 and missing == 0 and correct > 0
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.communicate()
        server.kill()
        server.communicate()
