"""The port's sharded fold and engine against the JAX package's, on the CPU.

The same numpy inputs (``tests/test_sharded.py``'s ``rand_batches``:
C = 96, W = 16, B = 64) go through JAX ``sharded_step`` and its scans on
the virtual 8-device CPU mesh, and through the port's fold on gloo ranks:
the mesh (1, 1) in this process, (4, 1), (2, 2) and (1, 4) as four
spawned ranks, one spawn per mesh running every case and writing its
shards to ``.npz`` files.  The concatenated shards, the ring, the
watermark and ``dropped`` must be bit-identical to JAX's and to the
port's unsharded ``wc.step``.

Then the engine end to end at (2, 2): rank 0 drives
``ShardedWindowEngine`` under ``StreamRunner.run_catchup`` and writes
through the port's RESP fake Redis server, the other ranks ``follow()``.
Run A patches the drain thresholds low, so every drain is a per-shard
dirty-row drain; run B keeps them (whole-shard drains), resumes from a
snapshot of the port's UNSHARDED engine (``_put_state`` re-pads and
slices it) and checkpoints as it goes (the shards gathered to rank 0).
Each spawned rank has its own ``communicate(timeout=...)``.
"""

import json
import os
import random
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu.ops import windowcount as jwc
from streambench_tpu.parallel import ShardedWindowEngine as JaxSharded
from streambench_tpu.parallel import build_mesh as jax_build_mesh
from streambench_tpu.parallel import sharded as jsh
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    read_seen_counts,
    seed_campaigns,
    write_window,
)
from streambench_tpu_torch.io.resp import RespClient
from streambench_tpu_torch.ops import windowcount as wc
from streambench_tpu_torch.parallel import sharded as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

C, W, B, K = 96, 16, 64, 6     # tests/test_sharded.py's shapes
B_ODD = 63                     # a B no data axis of these meshes divides
MESHES = [(1, 1), (4, 1), (2, 2), (1, 4)]
CASES = ["step", "step_packed", "scan_hoisted", "scan_packed_hoisted",
         "scan_perbatch", "scan_packed_perbatch", "odd_step", "odd_scan",
         "stats"]
RANK_TIMEOUT_S = 180

# One rank's program: every case on one mesh, each rank's state saved to
# <outdir>/<case>_r<rank>.npz.  Run as a script by each spawned rank, and
# exec'd in this process for the (1, 1) mesh.
RANK_PROGRAM = r'''
import json, os, sys
import numpy as np
import torch

def run_cases(mesh, inp, outdir):
    from streambench_tpu_torch.parallel import sharded as S
    jt = torch.from_numpy(inp["join"])
    C, W, B_ODD = int(inp["C"]), int(inp["W"]), int(inp["B_ODD"])
    cols = [inp[k] for k in ("ad", "et", "tm", "va")]
    words, tm = inp["words"], inp["tm"]
    K = cols[0].shape[0]
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))

    def save(case, st, **extra):
        np.savez(os.path.join(outdir, f"{case}_r{mesh.rank}.npz"),
                 counts=st.counts.numpy(), ids=st.window_ids.numpy(),
                 wm=int(st.watermark), dropped=int(st.dropped),
                 **{k: v.numpy() for k, v in extra.items()})

    def init():
        return S.sharded_init_state(C, W, mesh)

    st = init()
    for k in range(K):
        st = S.sharded_step(mesh, st, jt, *(T(c[k]) for c in cols))
    save("step", st)
    st = init()
    for k in range(K):
        st = S.sharded_step_packed(mesh, st, jt, T(words[k]), T(tm[k]))
    save("step_packed", st)
    for hoist, arm in ((True, "hoisted"), (False, "perbatch")):
        save(f"scan_{arm}", S.sharded_scan(mesh, init(), jt,
                                           *(T(c) for c in cols),
                                           hoist=hoist))
        save(f"scan_packed_{arm}", S.sharded_scan_packed(
            mesh, init(), jt, T(words), T(tm), hoist=hoist))
    pad = S.data_axis_pad(B_ODD, mesh)
    odd = S.pad_data_cols(pad, *(T(c[:, :B_ODD]) for c in cols))
    st = init()
    for k in range(K):
        st = S.sharded_step(mesh, st, jt, *(c[k] for c in odd))
    save("odd_step", st)
    save("odd_scan", S.sharded_scan(mesh, init(), jt, *odd))
    st, wanted, routed = S.sharded_scan(mesh, init(), jt,
                                        *(T(c) for c in cols), stats=True)
    save("stats", st, wanted=wanted, routed=routed)

def run_engine(mesh, spec):
    """The engine end to end on one mesh: runs A and B (module doc)."""
    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.config import default_config
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.engine import StreamRunner
    from streambench_tpu_torch.io.journal import FileBroker
    from streambench_tpu_torch.io.resp import RespClient
    from streambench_tpu_torch.parallel import ShardedWindowEngine

    wd = spec["workdir"]
    cfg = default_config(jax_batch_size=512, jax_window_slots=16)
    mapping = gen.load_ad_mapping_file(
        os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE))
    campaigns, _ = gen.load_ids(wd)
    out = {}
    for run in ("A", "B"):
        if run == "A":
            # every drain a per-shard dirty-row drain
            ShardedWindowEngine.COMPACT_DRAIN_MIN_CELLS = 1
        else:
            del ShardedWindowEngine.COMPACT_DRAIN_MIN_CELLS
        redis = (RespClient("127.0.0.1", spec["ports"][run])
                 if mesh.rank == 0 else None)
        eng = ShardedWindowEngine(cfg, mapping, mesh, campaigns=campaigns,
                                  redis=redis, device="cpu")
        if mesh.rank != 0:
            eng.follow()
            eng.close()
            continue
        ckpt = (Checkpointer(spec["checkpoint_dir"]) if run == "B"
                else None)
        reader = FileBroker(os.path.join(wd, "broker")).reader(
            cfg.kafka_topic)
        runner = StreamRunner(eng, reader, checkpointer=ckpt)
        resumed = runner.resume() if run == "B" else False
        st = runner.run_catchup()
        eng.close()
        out[run] = {"events": eng.events_processed, "dropped": eng.dropped,
                    "resumed": resumed, "drains": dict(eng.drain_stats),
                    "run_events": st.events}
    if mesh.rank == 0:
        print(json.dumps(out), flush=True)

if __name__ == "__main__":
    sys.path.insert(0, sys.argv[1])
    torch.set_num_threads(1)
    from streambench_tpu_torch.parallel import build_mesh
    mode, outdir = sys.argv[2], sys.argv[3]
    d, c = int(sys.argv[4]), int(sys.argv[5])
    mesh = build_mesh(d, c, device="cpu", timeout_s=120)
    if mode == "cases":
        run_cases(mesh, dict(np.load(os.path.join(outdir, "inputs.npz"))),
                  outdir)
    else:
        run_engine(mesh, json.load(open(os.path.join(outdir, "spec.json"))))
    # leave together: a rank that exits with its groups alive can abort
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
'''


def _rank_program() -> dict:
    ns = {"__name__": "rank_program"}
    exec(compile(RANK_PROGRAM, "rank_program", "exec"), ns)
    return ns


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(mode: str, outdir: str, shape: tuple) -> list[str]:
    """Run RANK_PROGRAM on ``d * c`` gloo ranks; their stdouts."""
    d, c = shape
    n = d * c
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=REPO,
                   STREAMBENCH_COORDINATOR=coord,
                   STREAMBENCH_NUM_PROCESSES=str(n),
                   STREAMBENCH_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_PROGRAM, REPO, mode, outdir,
             str(d), str(c)], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def rand_batches(rng, n_batches, B, n_ads, span_ms=200_000):
    """``tests/test_sharded.py:26-41``."""
    out = []
    t = 70_000
    for _ in range(n_batches):
        ad = rng.integers(0, n_ads, B).astype(np.int32)
        et = rng.integers(0, 3, B).astype(np.int32)
        tm = (t + np.sort(rng.integers(0, span_ms // n_batches, B))
              ).astype(np.int32)
        valid = (rng.random(B) < 0.95)
        t += span_ms // n_batches
        out.append((ad, et, tm, valid))
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(7)
    n_ads = C * 3
    join = np.concatenate([rng.integers(0, C, n_ads), [-1]]).astype(np.int32)
    bs = rand_batches(rng, K, B, n_ads)
    # a late tail: the last batch's first rows behind the lateness bound,
    # so the drop accounting has work to do
    bs[-1][2][:8] = 5_000
    bs[-1][1][:8] = 0
    bs[-1][3][:8] = True
    inp = {"join": join, "C": C, "W": W, "B_ODD": B_ODD,
           **{k: np.stack([b[i] for b in bs])
              for i, k in enumerate(("ad", "et", "tm", "va"))}}
    inp["words"] = np.stack([wc.pack_columns(a, e, v) for a, e, v in
                             zip(inp["ad"], inp["et"], inp["va"])])
    return inp


def _jax_case(shape, case, inp) -> dict:
    """The JAX package's result of ``case`` on a ``shape`` mesh."""
    d, c = shape
    mesh = jax_build_mesh(data=d, campaign=c, devices=jax.devices()[:d * c])
    jt = inp["join"]
    cols = [inp[k] for k in ("ad", "et", "tm", "va")]
    words, tm = inp["words"], inp["tm"]
    st = jsh.sharded_init_state(C, W, mesh)
    args = (st.counts, st.window_ids, st.watermark, st.dropped, jt)
    extra = {}
    if case == "step":
        for k in range(K):
            st = jsh.sharded_step(mesh, st, jt, *(x[k] for x in cols))
        out = tuple(st)
    elif case == "step_packed":
        fn = jsh._build_step_packed(mesh, 10_000, 60_000, 0)
        out = args[:4]
        for k in range(K):
            out = fn(*out, jt, words[k], tm[k])
    elif case.startswith("scan"):
        hoist = case.endswith("hoisted")
        if "packed" in case:
            fn = jsh._build_scan_packed(mesh, 10_000, 60_000, 0, hoist)
            out = fn(*args, words, tm)
        else:
            out = jsh._build_scan(mesh, 10_000, 60_000, 0, hoist)(*args,
                                                                  *cols)
    elif case.startswith("odd"):
        pad = jsh.data_axis_pad(B_ODD, mesh)
        odd = jsh.pad_data_cols(pad, *(x[:, :B_ODD] for x in cols))
        if case == "odd_step":
            for k in range(K):
                st = jsh.sharded_step(mesh, st, jt, *(x[k] for x in odd))
            out = tuple(st)
        else:
            out = jsh._build_scan(mesh, 10_000, 60_000, 0)(*args, *odd)
    else:
        out = jsh._build_scan(mesh, 10_000, 60_000, 0, True, True)(*args,
                                                                   *cols)
        extra = {"wanted": np.asarray(out[4]), "routed": np.asarray(out[5])}
    counts, ids, wm, dropped = (np.asarray(x) for x in out[:4])
    return {"counts": counts, "ids": ids, "wm": int(wm),
            "dropped": int(dropped), **extra}


def _unsharded(case, inp) -> dict:
    """The port's single-device ``wc.step`` over the case's batches."""
    jt = torch.from_numpy(inp["join"])
    n = B_ODD if case.startswith("odd") else B
    st = wc.init_state(C, W)
    for k in range(K):
        st = wc.step(st, jt, *(torch.from_numpy(
            np.ascontiguousarray(inp[c][k, :n]))
            for c in ("ad", "et", "tm", "va")))
    return {"counts": st.counts.numpy(), "ids": st.window_ids.numpy(),
            "wm": int(st.watermark), "dropped": int(st.dropped)}


@pytest.fixture(scope="module")
def port_results(inputs, tmp_path_factory):
    """``shape -> case -> result`` of the port, one run per mesh, on
    first use: the data row 0 shards concatenated; replicas and the
    replicated scalars checked equal on every rank."""
    cache = {}

    def get(shape):
        if shape in cache:
            return cache[shape]
        outdir = str(tmp_path_factory.mktemp("mesh_%dx%d" % shape))
        np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
        if shape == (1, 1):
            ns = _rank_program()
            from streambench_tpu_torch.parallel import build_mesh
            try:
                ns["run_cases"](build_mesh(1, 1, device="cpu"), inputs,
                                outdir)
            finally:
                dist.destroy_process_group()
        else:
            spawn_ranks("cases", outdir, shape)
        d, c = shape
        grid = np.arange(d * c).reshape(d, c)
        res = {}
        for case in CASES:
            per = [dict(np.load(os.path.join(outdir, f"{case}_r{r}.npz")))
                   for r in range(d * c)]
            for r in range(d * c):
                twin = per[grid[0, r % c]]
                for key in per[r]:
                    assert np.array_equal(per[r][key], twin[key]
                                          if key == "counts"
                                          else per[0][key]), (case, r, key)
            res[case] = {
                "counts": np.concatenate([per[r]["counts"]
                                          for r in grid[0]]),
                "ids": per[0]["ids"], "wm": int(per[0]["wm"]),
                "dropped": int(per[0]["dropped"]),
                **{k: per[0][k] for k in ("wanted", "routed")
                   if k in per[0]}}
        cache[shape] = res
        return res

    return get


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_sharded_fold_bit_identical_to_jax_and_unsharded(
        port_results, inputs, shape, case):
    got = port_results(shape)[case]
    want = _jax_case(shape, case, inputs)
    flat = _unsharded(case, inputs)
    for key in ("counts", "ids", "wm", "dropped"):
        assert np.array_equal(got[key], want[key]), key
        assert np.array_equal(got[key], flat[key]), key
    if case == "stats":
        assert np.array_equal(got["wanted"], want["wanted"])
        assert np.array_equal(got["routed"], want["routed"])
        # the routed rows are the counted ones: they reconcile with drops
        assert int(got["routed"].sum()) == int(got["counts"].sum())
    if case == "scan_hoisted":
        assert want["dropped"] > 0     # the late tail exercised drops


def test_mesh_pads_the_campaign_axis_and_checks_the_world():
    from streambench_tpu_torch.parallel import build_mesh, mesh_from_config

    try:
        mesh = build_mesh(1, 1, device="cpu")
        assert mesh.shape == {"data": 1, "campaign": 1}
        assert (mesh.data_index, mesh.campaign_index) == (0, 0)
        assert S.sharded_init_state(100, 16, mesh).counts.shape == (100, 16)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            build_mesh(2, 1, device="cpu")
        with pytest.raises(ValueError, match="campaign axis"):
            build_mesh(1, 0, device="cpu")
        cfg = default_config(jax_mesh_shape=(1, 1))
        assert mesh_from_config(cfg, device="cpu").shape["campaign"] == 1
    finally:
        dist.destroy_process_group()


def test_engine_defaults_to_cuda_and_matches_its_mesh(monkeypatch):
    from streambench_tpu_torch.parallel import (
        ShardedWindowEngine,
        build_mesh,
    )

    cfg = default_config()
    mapping = {f"ad{i}": f"c{i % 4}" for i in range(16)}
    try:
        mesh = build_mesh(1, 1, device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ShardedWindowEngine(cfg, mapping, mesh)
        eng = ShardedWindowEngine(cfg, mapping, mesh, device="cpu")
        assert eng.method == "scatter" and eng._data_pad == 0
    finally:
        dist.destroy_process_group()


def test_put_state_from_an_unsharded_snapshot_in_process():
    """(1, 1): a snapshot of the unsharded engine restores into the
    sharded one and continues bit-identically."""
    from streambench_tpu_torch.parallel import (
        ShardedWindowEngine,
        build_mesh,
    )

    cfg = default_config(jax_batch_size=64, jax_window_slots=16)
    mapping = {f"ad{i}": f"c{i % 7}" for i in range(40)}
    lines = [json.dumps({"user_id": "u", "page_id": "p",
                         "ad_id": f"ad{i % 40}", "ad_type": "banner",
                         "event_type": ("view", "click")[i % 3 == 0],
                         "event_time": str(1_700_000_000_000 + 37 * i),
                         "ip_address": "1.2.3.4"}).encode()
             for i in range(400)]
    flat = AdAnalyticsEngine(cfg, mapping, device="cpu")
    flat.process_chunk(lines[:200])
    snap = flat.snapshot(0)
    try:
        eng = ShardedWindowEngine(cfg, mapping, build_mesh(1, 1, "cpu"),
                                  device="cpu")
        eng.restore(snap)
        for e in (flat, eng):
            e.process_chunk(lines[200:])
        a, b = flat.snapshot(1), eng.snapshot(1)
        assert np.array_equal(a.counts, b.counts)
        assert np.array_equal(a.window_ids, b.window_ids)
        assert (a.watermark, a.dropped) == (b.watermark, b.dropped)
        assert a.pending == b.pending
    finally:
        dist.destroy_process_group()


def _resp_server(port: int) -> subprocess.Popen:
    proc = subprocess.Popen(
        [sys.executable, "-m", "streambench_tpu_torch.io.fakeredis",
         "--host", "127.0.0.1", "--port", str(port)],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    for _ in range(200):
        try:
            RespClient("127.0.0.1", port).ping()
            return proc
        except OSError:
            time.sleep(0.05)
    proc.kill()
    raise AssertionError("the RESP server did not start")


def test_engine_end_to_end_at_2x2_against_jax_and_the_oracle(tmp_path):
    wd = str(tmp_path)
    cfg = default_config(jax_batch_size=512, jax_window_slots=16)
    broker = FileBroker(os.path.join(wd, "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=20_000,
                 rng=random.Random(5), workdir=wd)
    mapping = gen.load_ad_mapping_file(os.path.join(wd,
                                                    gen.AD_TO_CAMPAIGN_FILE))
    campaigns, _ = gen.load_ids(wd)

    # the JAX package's sharded engine on its (2, 2) mesh
    jcfg = jax_default_config(jax_batch_size=512, jax_window_slots=16)
    jr = jax_as_redis(JaxStore())
    jax_seed(jr, campaigns)
    jeng = JaxSharded(jcfg, mapping, jax_build_mesh(
        data=2, campaign=2, devices=jax.devices()[:4]), campaigns=campaigns,
        redis=jr)
    JaxRunner(jeng, JaxBroker(os.path.join(wd, "broker")).reader(
        jcfg.kafka_topic)).run_catchup()
    jeng.close()
    want = jax_seen(jr)

    ports = {"A": free_port(), "B": free_port()}
    servers = [_resp_server(p) for p in ports.values()]
    try:
        clients = {k: RespClient("127.0.0.1", p) for k, p in ports.items()}
        for r in clients.values():
            seed_campaigns(r, campaigns)
        # run B resumes from the unsharded engine's snapshot at 8,000
        # events, written to its store before the sharded engine starts
        ckpt = str(tmp_path / "ckpt")
        flat = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns,
                                 redis=clients["B"], device="cpu")
        StreamRunner(flat, broker.reader(cfg.kafka_topic),
                     checkpointer=Checkpointer(ckpt)).run_catchup(
                         max_events=8_000)
        flat.drain_writes()
        assert Checkpointer(ckpt).load() is not None
        with open(os.path.join(wd, "spec.json"), "w") as f:
            json.dump({"workdir": wd, "ports": ports,
                       "checkpoint_dir": ckpt}, f)
        outs = spawn_ranks("engine", wd, (2, 2))
        stats = json.loads(outs[0].strip().splitlines()[-1])
        a, b = stats["A"], stats["B"]
        assert a["events"] == 20_000 and a["dropped"] == 0
        assert a["drains"]["rows_host"] > 0 and a["drains"]["dense"] == 0
        assert b["resumed"] and b["events"] == 20_000 and b["dropped"] == 0
        assert 0 < b["run_events"] < 20_000
        assert b["drains"]["dense"] > 0 and b["drains"]["rows_host"] == 0
        for run, r in clients.items():
            assert read_seen_counts(r) == want, run
            logs = []
            correct, differ, missing = gen.check_correct(
                r, wd, log=logs.append)
            assert differ == 0 and missing == 0, (run, logs[:5])
            assert correct >= 20
    finally:
        for s in servers:
            s.kill()
            s.communicate()


def _cli_rows(module, wd, port, extra=()):
    """One CLI catchup of ``wd``'s journal into the RESP store on
    ``port``: its stdout lines and every window's ``seen_count``."""
    conf = os.path.join(wd, f"conf_{port}.yaml")
    with open(conf, "w") as f:
        f.write(f'redis.host: "127.0.0.1"\nredis.port: {port}\n'
                "jax.obs.shard: true\n")
    proc = subprocess.run(
        [sys.executable, "-m", module, "--confPath", conf, "--workdir", wd,
         "--catchup", "--sharded", *extra], capture_output=True, text=True,
        timeout=240, env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return (proc.stdout.strip().splitlines(),
            read_seen_counts(RespClient("127.0.0.1", port)))


def test_cli_sharded_on_cpu_matches_the_jax_cli(tmp_path):
    """``--sharded`` (one rank, gloo) against the JAX CLI's ``--sharded``
    on one generated journal: the same windows, oracle-exact, and the
    skew of the one shard in the stats line (``jax.obs.shard``)."""
    wd = str(tmp_path)
    cfg = default_config()
    gen.do_setup(None, cfg, broker=FileBroker(os.path.join(wd, "broker")),
                 events_num=10_000, rng=random.Random(21), workdir=wd)
    campaigns, _ = gen.load_ids(wd)
    ports = [free_port(), free_port()]
    servers = [_resp_server(p) for p in ports]
    try:
        for p in ports:
            seed_campaigns(RespClient("127.0.0.1", p), campaigns)
        lines, got = _cli_rows("streambench_tpu_torch.engine", wd, ports[0],
                               ["--device", "cpu"])
        _, want = _cli_rows("streambench_tpu.engine", wd, ports[1])
        assert any("engine up:" in ln and "mesh=1x1 backend=gloo" in ln
                   for ln in lines)
        stats = json.loads(lines[-1])
        assert stats["events"] == 10_000 and stats["dropped"] == 0
        assert stats["kernel_launches"]["count_cells"] == 0   # CPU
        skew = stats["shard_skew"]
        assert skew["shards"] == 1 and skew["dropped"] == [0]
        assert skew["rows"] == skew["wanted"] and skew["rows"][0] > 0
        assert got == want and got
        correct, differ, missing = gen.check_correct(
            RespClient("127.0.0.1", ports[0]), wd, log=lambda s: None)
        assert differ == 0 and missing == 0 and correct > 0
    finally:
        for s in servers:
            s.kill()
            s.communicate()


def test_cli_sharded_without_cuda_raises(tmp_path):
    """The default device is the card: without one, ``--sharded`` fails
    (rc != 0) instead of carrying on on the CPU."""
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\n')
    gen.do_setup(None, default_config(),
                 broker=FileBroker(str(tmp_path / "broker")),
                 events_num=100, rng=random.Random(3),
                 workdir=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: False; "
         "from streambench_tpu_torch.engine.__main__ import main; "
         "sys.exit(main(sys.argv[1:]))", "--confPath", str(conf),
         "--workdir", str(tmp_path), "--catchup", "--sharded"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


# chip_smoke.py phase 17, rehearsed on the CPU at a small size
def test_chip_smoke_phase17_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 17 through the smoke's own code on a (1, 1) gloo mesh, held
    to an unsharded CPU run that stands in for phase 6 (its oracle, the
    store's digest against the journal's exact windows, equal to the
    full read-back's; its record taken by ``_config5_record``, the
    store's digest equal to the journal's views): config #5's keys at 1,000 campaigns and 60,000
    events, the row drains' threshold lowered so both engines take them.
    Each sharded store's whole-store digest must be the unsharded one's;
    a store holding one extra window must fail the phase.  The card runs
    it at 1e6 campaigns and 1,000,000 events."""
    import chip_smoke

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        return str(path)

    monkeypatch.setattr(chip_smoke, "_workdir", workdir)
    monkeypatch.setattr(AdAnalyticsEngine, "COMPACT_DRAIN_MIN_CELLS", 1 << 12)
    data = chip_smoke.Config5Data(60_000, keys=dict(
        chip_smoke.CONFIG5, **{"jax.num.campaigns": 1_000}))
    try:
        cfg = data.config()
        r = data.store()
        eng = AdAnalyticsEngine(cfg, data.mapping, campaigns=data.campaigns,
                                redis=r, device="cpu")
        t0 = time.perf_counter()
        StreamRunner(eng, data.broker.reader(cfg.kafka_topic)).run_catchup()
        eng.close()
        run_s = time.perf_counter() - t0
        assert eng.drain_stats.get("rows_host")
        full = chip_smoke._oracle(r, data.workdir, cfg.jax_time_divisor_ms)
        # phase 6's oracle: the store's digest against the journal's
        oracle, expected = chip_smoke._digest_oracle(
            r, data.workdir, cfg.jax_time_divisor_ms)
        assert oracle["windows_checked"] == full["windows_checked"]
        record, windows = chip_smoke._config5_record(data, r, expected)
        assert record["store_digest"]["seen"] == record["views"] > 0
        assert record["store_digest"] == oracle["oracle_digest"]
        assert 0 < len(windows) < record["store_digest"]["windows"]
        unsharded = dict(record, events_per_s=60_000 / run_s,
                         events_per_s_with_close=60_000 / run_s)
        out = chip_smoke.phase_sharded(data, windows, unsharded,
                                       device="cpu")
        assert out["backend"] == "gloo"
        for run in ("plain", "obs_shard"):
            assert out[run]["events"] == 60_000 and out[run]["dropped"] == 0
            assert out[run]["store_digest"] == record["store_digest"]
        assert out["plain"]["windows_equal_phase6_sampled"] == min(
            chip_smoke.STORE_SAMPLE, len(windows))
        assert out["obs_shard"]["shard_skew"]["rows"] == [record["views"]]
        # (d): the engine CLI over 2 gloo ranks, its store phase 6's
        ranks = out["multi_rank"]
        assert ranks["multi_rank"] == "ran: 2 ranks"
        assert "ranks=2" in ranks["engine_up"]
        assert ranks["events"] == 60_000 and ranks["dropped"] == 0
        assert ranks["store_digest"] == record["store_digest"]
        assert ranks["follower_exit_codes"] == [0]
        assert ranks["count_cells_launches_by_rank"] == [0, 0]     # CPU
        # ... and the card's arm on a host with fewer cards than ranks
        # (none here): refused by name, no rank started
        refused = chip_smoke._RanksCli(data, "cuda").finish(
            record["store_digest"])
        assert refused["multi_rank"] == "refused: 2 ranks, 0 cards"
        assert refused["exit_code"] == 2

        # one extra window in each sharded store: the digest catches it
        fresh = data.store

        def store_with_an_extra_window():
            s = fresh()
            write_window(s, data.campaigns[0], 10**12, 1, time_updated=1)
            return s

        monkeypatch.setattr(data, "store", store_with_an_extra_window)
        with pytest.raises(AssertionError, match="are not phase 6's"):
            chip_smoke.phase_sharded(data, windows, unsharded, device="cpu")
        # ... and phase 6's oracle fails once the checked store holds one
        write_window(r, data.campaigns[0], 10**12, 1, time_updated=1)
        with pytest.raises(AssertionError, match="oracle: the store's"):
            chip_smoke._digest_oracle(r, data.workdir,
                                      cfg.jax_time_divisor_ms)
    finally:
        data.remove()
