"""The port's sharded HLL fold and engine against the JAX package's, on the CPU.

The same numpy inputs (``tests/test_sharded_sketches.py``'s
``rand_batches``: C = 96 campaigns, W = 16 slots, R = 32 registers,
B = 64 rows, K = 3 batches) go through JAX's ``parallel/sketches.py``
(``sharded_hll_step`` and the built step and scan programs) on the
virtual 8-device CPU mesh, and through the port's ``hll_fold_step`` /
``hll_fold_scan`` on gloo ranks: the mesh (1, 1) in this process, (4, 1),
(2, 2) and (1, 4) as four spawned ranks, one spawn per mesh running every
case and writing its shards to ``.npz`` files.  The concatenated register
shards, the ring, the watermark and ``dropped`` must be bit-identical to
JAX's and to the port's unsharded ``hll.step``.

Then the engine end to end at (2, 2): rank 0 drives ``ShardedHLLEngine``
under ``StreamRunner.run_catchup`` into the port's RESP fake Redis, the
other ranks ``follow()``.  Run A starts fresh with ``jax.obs.shard``; run
B resumes from a snapshot of the port's UNSHARDED engine and checkpoints
as it goes; its last snapshot restores into the unsharded engine, whose
state must equal an unsharded run's.  Rows must equal JAX's sharded
engine's within 1 (an estimate is a float32 sum truncated to an integer)
and stay near the exact distinct-user golden.  Each spawned rank has its
own ``communicate(timeout=...)``.

This module also holds the spawn helpers the sliding and session
modules share.
"""

import json
import os
import random
import subprocess
import sys

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
from streambench_tpu.parallel import ShardedHLLEngine as JaxShardedHLL
from streambench_tpu.parallel import build_mesh as jax_build_mesh
from streambench_tpu.parallel import sketches as jsk
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import StreamRunner
from streambench_tpu_torch.engine.sketches import HLLDistinctEngine
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    read_seen_counts,
    seed_campaigns,
)
from streambench_tpu_torch.io.resp import RespClient
from streambench_tpu_torch.ops import hll
from tests.test_torch_sharded import _resp_server, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

C, W, R, B, K = 96, 16, 32, 64, 3
B_ODD = 63                     # a B no data axis of these meshes divides
MESHES = [(1, 1), (4, 1), (2, 2), (1, 4)]
CASES = ["step", "step_packed", "scan_hoisted", "scan_perbatch",
         "scan_packed_hoisted", "scan_packed_perbatch", "odd_step", "stats"]
RANK_TIMEOUT_S = 180

# The main block every rank program of these modules ends with: join the
# gloo mesh, run the cases or the engine, leave together.
RANK_MAIN = r'''
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

RANK_PROGRAM = r'''
import json, os, sys
import numpy as np
import torch

def run_cases(mesh, inp, outdir):
    from streambench_tpu_torch.ops import hll
    from streambench_tpu_torch.ops import windowcount as wc
    from streambench_tpu_torch.parallel import sharded as S
    from streambench_tpu_torch.parallel import sketches as SK
    jt = torch.from_numpy(inp["join"])
    C, W, R, B_ODD = (int(inp[k]) for k in ("C", "W", "R", "B_ODD"))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    axes = S.mesh_axes(mesh, C)
    cols = [inp[k] for k in ("ad", "user", "et", "tm", "va")]
    words = np.stack([wc.pack_columns(a, e, v) for a, e, v in
                      zip(inp["ad"], inp["et"], inp["va"])])
    packed = [words, inp["user"], inp["tm"]]
    K = cols[0].shape[0]
    local = lambda xs: [S.data_slice(mesh, T(x)) for x in xs]

    def save(case, out):
        st = out[:4]
        np.savez(os.path.join(outdir, f"{case}_r{mesh.rank}.npz"),
                 registers=st[0].numpy(), ids=st[1].numpy(), wm=int(st[2]),
                 dropped=int(st[3]),
                 **{k: v.numpy() for k, v in zip(("wanted", "routed"),
                                                 out[4:])})

    init = lambda: SK.sharded_hll_init(C, W, mesh, num_registers=R)
    st = init()
    for k in range(K):      # the global-column entry point
        st = SK.sharded_hll_step(mesh, st, jt, *(T(x[k]) for x in cols))
    save("step", st)
    st = init()
    for k in range(K):
        st = hll.HLLState(*SK.hll_fold_step(
            st, jt, local([x[k] for x in packed]), axes, packed=True))
    save("step_packed", st)
    for hoist, arm in ((True, "hoisted"), (False, "perbatch")):
        save(f"scan_{arm}", SK.hll_fold_scan(init(), jt, local(cols), axes,
                                             packed=False, hoist=hoist))
        save(f"scan_packed_{arm}", SK.hll_fold_scan(
            init(), jt, local(packed), axes, packed=True, hoist=hoist))
    pad = S.data_axis_pad(B_ODD, mesh)
    odd = S.pad_data_cols(pad, *(T(c[:, :B_ODD]) for c in cols))
    st = init()
    for k in range(K):
        st = hll.HLLState(*SK.hll_fold_step(
            st, jt, [S.data_slice(mesh, c[k]) for c in odd], axes,
            packed=False))
    save("odd_step", st)
    save("stats", SK.hll_fold_scan(init(), jt, local(cols), axes,
                                   packed=False, stats=True))
    if mesh.size == 4 and mesh.shape["data"] == 2:
        # the engine's collective report at (2, 2), on a real engine
        from streambench_tpu_torch.config import default_config
        from streambench_tpu_torch.parallel import ShardedHLLEngine
        mapping = {f"ad{i}": f"c{i % 7}" for i in range(40)}
        for fmt in ("packed", "unpacked"):
            eng = ShardedHLLEngine(default_config(jax_batch_size=64),
                                   mapping, mesh, device="cpu")
            eng._pack_ok = fmt == "packed"
            rep = (eng.collective_report(k=3) if mesh.rank == 0
                   else eng.follow())
            if mesh.rank == 0:
                eng.close()
                with open(os.path.join(outdir, f"report_{fmt}.json"),
                          "w") as f:
                    json.dump(rep, f)

def run_engine(mesh, spec):
    """The engine end to end on one mesh: runs A and B (module doc)."""
    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.config import default_config
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.engine import StreamRunner
    from streambench_tpu_torch.io.journal import FileBroker
    from streambench_tpu_torch.io.resp import RespClient
    from streambench_tpu_torch.obs import MetricsRegistry, ShardSkew
    from streambench_tpu_torch.parallel import ShardedHLLEngine

    wd = spec["workdir"]
    cfg = default_config(jax_batch_size=spec["batch"],
                         jax_window_slots=spec["slots"])
    mapping = gen.load_ad_mapping_file(
        os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE))
    campaigns, _ = gen.load_ids(wd)
    out = {}
    for run in ("A", "B"):
        redis = (RespClient("127.0.0.1", spec["ports"][run])
                 if mesh.rank == 0 else None)
        eng = ShardedHLLEngine(cfg, mapping, mesh, campaigns=campaigns,
                               redis=redis, device="cpu")
        if mesh.rank != 0:
            eng.follow()
            eng.close()
            continue
        skew = None
        if run == "A":
            skew = ShardSkew(MetricsRegistry(), n_shards=2)
            eng.attach_obs(MetricsRegistry(), shard=skew)
        ckpt = (Checkpointer(spec["checkpoint_dir"]) if run == "B"
                else None)
        reader = FileBroker(os.path.join(wd, "broker")).reader(
            cfg.kafka_topic)
        runner = StreamRunner(eng, reader, checkpointer=ckpt)
        resumed = runner.resume() if run == "B" else False
        st = runner.run_catchup()
        eng.close()
        out[run] = {"events": eng.events_processed, "dropped": eng.dropped,
                    "resumed": resumed, "run_events": st.events,
                    "skew": skew.summary() if skew else None}
    if mesh.rank == 0:
        print(json.dumps(out), flush=True)
''' + RANK_MAIN


def run_in_process(program: str, mode: str, outdir: str, inputs: dict):
    """A rank program's ``run_cases`` on the (1, 1) mesh in this process."""
    ns = {"__name__": "rank_program"}
    exec(compile(program, "rank_program", "exec"), ns)
    from streambench_tpu_torch.parallel import build_mesh
    try:
        ns["run_cases"](build_mesh(1, 1, device="cpu"), inputs, outdir)
    finally:
        dist.destroy_process_group()


def spawn(program: str, mode: str, outdir: str, shape: tuple) -> list[str]:
    """Run ``program`` on ``d * c`` gloo ranks; their stdouts."""
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
            [sys.executable, "-c", program, REPO, mode, outdir, str(d),
             str(c)], env=env, cwd=REPO, stdout=subprocess.PIPE,
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


def load_ranks(outdir: str, shape: tuple, case: str, sharded: tuple,
               axis: str = "campaign") -> dict:
    """One case's per-rank ``.npz`` results as the whole state: the
    ``sharded`` keys concatenated in shard order (the campaign shards of
    data row 0, or every rank with ``axis="world"``), replicas and the
    replicated values checked equal on every rank."""
    d, c = shape
    grid = np.arange(d * c).reshape(d, c)
    per = [dict(np.load(os.path.join(outdir, f"{case}_r{r}.npz")))
           for r in range(d * c)]
    for r in range(d * c):
        for key in per[r]:
            if key in sharded and axis == "world":
                continue
            twin = per[grid[0, r % c]] if key in sharded else per[0]
            assert np.array_equal(per[r][key], twin[key]), (case, r, key)
    owners = grid[0] if axis == "campaign" else grid.reshape(-1)
    return {k: (np.concatenate([per[r][k] for r in owners])
                if k in sharded else per[0][k]) for k in per[0]}


def port_results_fixture(program, inputs, tmp_path_factory, cases,
                         sharded, axis="campaign"):
    """``shape -> case -> result`` of the port, one run per mesh, on first
    use."""
    cache = {}

    def get(shape):
        if shape not in cache:
            outdir = str(tmp_path_factory.mktemp("mesh_%dx%d" % shape))
            np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
            if shape == (1, 1):
                run_in_process(program, "cases", outdir, inputs)
            else:
                spawn(program, "cases", outdir, shape)
            cache[shape] = ({case: load_ranks(outdir, shape, case, sharded,
                                              axis) for case in cases},
                            outdir)
        return cache[shape]
    return get


def rand_batches(rng, n_batches, B, n_ads, n_users, span_ms=200_000):
    """``tests/test_sharded_sketches.py:39-51``."""
    out = []
    t = 70_000
    for _ in range(n_batches):
        ad = rng.integers(0, n_ads, B).astype(np.int32)
        user = rng.integers(0, n_users, B).astype(np.int32)
        et = rng.integers(0, 3, B).astype(np.int32)
        tm = (t + np.sort(rng.integers(0, span_ms // n_batches, B))
              ).astype(np.int32)
        valid = rng.random(B) < 0.95
        t += span_ms // n_batches
        out.append((ad, user, et, tm, valid))
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    n_ads = C * 3
    join = np.concatenate([rng.integers(0, C, n_ads), [-1]]).astype(np.int32)
    bs = rand_batches(rng, K, B, n_ads + 1, 500)
    # a late tail: the last batch's first rows behind the lateness bound
    bs[-1][3][:8] = 1_000
    bs[-1][2][:8] = 0
    bs[-1][4][:8] = True
    return {"join": join, "C": C, "W": W, "R": R, "B_ODD": B_ODD,
            **{k: np.stack([b[i] for b in bs])
               for i, k in enumerate(("ad", "user", "et", "tm", "va"))}}


@pytest.fixture(scope="module")
def port_results(inputs, tmp_path_factory):
    return port_results_fixture(RANK_PROGRAM, inputs, tmp_path_factory,
                                CASES, ("registers",))


def _jax_case(shape, case, inp) -> dict:
    """The JAX package's result of ``case`` on a ``shape`` mesh."""
    d, c = shape
    mesh = jax_build_mesh(data=d, campaign=c, devices=jax.devices()[:d * c])
    jt = inp["join"]
    cols = [inp[k] for k in ("ad", "user", "et", "tm", "va")]
    words = np.stack([jwc.pack_columns(a, e, v) for a, e, v in
                      zip(inp["ad"], inp["et"], inp["va"])])
    packed = (words, inp["user"], inp["tm"])
    st = jsk.sharded_hll_init(C, W, mesh, num_registers=R)
    args = tuple(st)
    extra = {}
    if case == "step":
        for k in range(K):
            st = jsk.sharded_hll_step(mesh, st, jt, *(x[k] for x in cols))
        out = tuple(st)
    elif case == "step_packed":
        fn = jsk._build_hll_step_packed(mesh, 10_000, 60_000, 0)
        out = args
        for k in range(K):
            out = fn(*out, jt, *(x[k] for x in packed))
    elif case.startswith("scan"):
        hoist = case.endswith("hoisted")
        if "packed" in case:
            fn = jsk._build_hll_scan_packed(mesh, 10_000, 60_000, 0, hoist)
            out = fn(*args, jt, *packed)
        else:
            out = jsk._build_hll_scan(mesh, 10_000, 60_000, 0, hoist)(
                *args, jt, *cols)
    elif case == "odd_step":
        from streambench_tpu.parallel.sharded import (
            data_axis_pad,
            pad_data_cols,
        )
        odd = pad_data_cols(data_axis_pad(B_ODD, mesh),
                            *(x[:, :B_ODD] for x in cols))
        for k in range(K):
            st = jsk.sharded_hll_step(mesh, st, jt, *(x[k] for x in odd))
        out = tuple(st)
    else:
        out = jsk._build_hll_scan(mesh, 10_000, 60_000, 0, True, True)(
            *args, jt, *cols)
        extra = {"wanted": np.asarray(out[4]), "routed": np.asarray(out[5])}
    regs, ids, wm, dropped = (np.asarray(x) for x in out[:4])
    return {"registers": regs, "ids": ids, "wm": int(wm),
            "dropped": int(dropped), **extra}


def _unsharded(case, inp) -> dict:
    """The port's single-device ``hll.step`` over the case's batches."""
    jt = torch.from_numpy(inp["join"])
    n = B_ODD if case.startswith("odd") else B
    st = hll.init_state(C, W, num_registers=R)
    for k in range(K):
        st = hll.step(st, jt, *(torch.from_numpy(
            np.ascontiguousarray(inp[c][k, :n]))
            for c in ("ad", "user", "et", "tm", "va")))
    return {"registers": st.registers.numpy(), "ids": st.window_ids.numpy(),
            "wm": int(st.watermark), "dropped": int(st.dropped)}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_sharded_hll_fold_bit_identical_to_jax_and_unsharded(
        port_results, inputs, shape, case):
    got = port_results(shape)[0][case]
    want = _jax_case(shape, case, inputs)
    flat = _unsharded(case, inputs)
    for key in ("registers", "ids", "wm", "dropped"):
        assert np.array_equal(got[key], want[key]), key
        assert np.array_equal(got[key], flat[key]), key
    assert int(got["registers"].max()) > 0
    if case == "stats":
        assert np.array_equal(got["wanted"], want["wanted"])
        assert np.array_equal(got["routed"], want["routed"])
    if case == "scan_hoisted":
        assert want["dropped"] > 0     # the late tail exercised drops


def test_collective_report_against_the_hand_counts(port_results):
    """At (2, 2), one dispatch of the engine: the packed step gathers its
    three columns over the data group and sums the counted rows once; the
    unpacked one gathers five; the hoisted scan the same a dispatch, none
    inside its loop."""
    outdir = port_results((2, 2))[1]
    for fmt, cols in (("packed", 3), ("unpacked", 5)):
        with open(os.path.join(outdir, f"report_{fmt}.json")) as f:
            rep = json.load(f)
        assert rep["packed"] == (fmt == "packed")
        for kernel in ("step", "scan"):
            per = rep[kernel]["per_dispatch"]
            assert per["by_kind"] == {"all-gather": cols, "all-reduce": 1}
            assert rep[kernel]["per_loop_iteration"]["ops"] == 0
        # each gathered column: [K, B] int32 on the data group's 2 ranks
        assert rep["scan"]["per_dispatch"]["column_bytes"] == cols * 3 * 64 * 4
        assert rep["step"]["per_dispatch"]["bytes"] == cols * 64 * 4 + 4


# ----------------------------------------------------------------------
# the engine end to end

def _golden_distinct(wd: str) -> dict:
    """Exact distinct users per (campaign, 10 s window) over the views."""
    mapping = gen.load_ad_mapping_file(os.path.join(wd,
                                                    gen.AD_TO_CAMPAIGN_FILE))
    seen: dict = {}
    with open(os.path.join(wd, gen.KAFKA_JSON_FILE)) as f:
        for line in f:
            e = json.loads(line)
            if e["event_type"] != "view":
                continue
            key = (mapping[e["ad_id"]], int(e["event_time"]) // 10_000
                   * 10_000)
            seen.setdefault(key, set()).add(e["user_id"])
    return {k: len(v) for k, v in seen.items()}


def _rows(seen: dict) -> dict:
    return {(c, w): n for c in seen for w, n in seen[c].items()}


def test_engine_end_to_end_at_2x2_against_jax_and_the_golden(tmp_path):
    wd = str(tmp_path)
    cfg = default_config(jax_batch_size=512, jax_window_slots=16)
    broker = FileBroker(os.path.join(wd, "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=12_000,
                 rng=random.Random(5), workdir=wd)
    mapping = gen.load_ad_mapping_file(os.path.join(wd,
                                                    gen.AD_TO_CAMPAIGN_FILE))
    campaigns, _ = gen.load_ids(wd)

    jcfg = jax_default_config(jax_batch_size=512, jax_window_slots=16)
    jr = jax_as_redis(JaxStore())
    jax_seed(jr, campaigns)
    jeng = JaxShardedHLL(jcfg, mapping, jax_build_mesh(
        data=2, campaign=2, devices=jax.devices()[:4]), campaigns=campaigns,
        redis=jr)
    JaxRunner(jeng, JaxBroker(os.path.join(wd, "broker")).reader(
        jcfg.kafka_topic)).run_catchup()
    jeng.close()
    want = _rows(jax_seen(jr))

    ports = {"A": free_port(), "B": free_port()}
    servers = [_resp_server(p) for p in ports.values()]
    try:
        clients = {k: RespClient("127.0.0.1", p) for k, p in ports.items()}
        for r in clients.values():
            seed_campaigns(r, campaigns)
        # run B resumes from the unsharded engine's snapshot at 4,000
        # events, written to its store before the sharded engine starts
        ckpt = str(tmp_path / "ckpt")
        flat = HLLDistinctEngine(cfg, mapping, campaigns=campaigns,
                                 redis=clients["B"], device="cpu")
        StreamRunner(flat, broker.reader(cfg.kafka_topic),
                     checkpointer=Checkpointer(ckpt)).run_catchup(
                         max_events=4_000)
        flat.drain_writes()
        with open(os.path.join(wd, "spec.json"), "w") as f:
            json.dump({"workdir": wd, "ports": ports, "batch": 512,
                       "slots": 16, "checkpoint_dir": ckpt}, f)
        outs = spawn(RANK_PROGRAM, "engine", wd, (2, 2))
        stats = json.loads(outs[0].strip().splitlines()[-1])
        a, b = stats["A"], stats["B"]
        assert a["events"] == 12_000 and a["dropped"] == 0
        assert b["resumed"] and b["events"] == 12_000 and b["dropped"] == 0
        assert 0 < b["run_events"] < 12_000
        # the shard-skew arm: every wanted row routed to one of 2 shards
        assert a["skew"]["shards"] == 2 and a["skew"]["dropped"] == [0, 0]
        golden = _golden_distinct(wd)
        for run, r in clients.items():
            got = _rows(read_seen_counts(r))
            assert set(got) == set(want) == set(golden), run
            assert max(abs(got[k] - want[k]) for k in want) <= 1, run
            err = np.mean([abs(got[k] - n) / n for k, n in golden.items()])
            assert err < 0.1, run
    finally:
        for s in servers:
            s.kill()
            s.communicate()

    # the sharded engine's last snapshot restores into the unsharded
    # engine: the same state as an unsharded run over the whole journal
    snap = Checkpointer(ckpt).load()
    assert snap.meta["events_processed"] == 12_000
    back = HLLDistinctEngine(cfg, mapping, campaigns=campaigns, device="cpu")
    back.restore(snap)
    ref = HLLDistinctEngine(cfg, mapping, campaigns=campaigns, device="cpu")
    StreamRunner(ref, broker.reader(cfg.kafka_topic)).run_catchup()
    for x, y in zip(back.state, ref.state):
        assert torch.equal(x, y)


def _cli(module, wd, port, engine, extra=()):
    """One ``--sharded --engine`` CLI catchup of ``wd``'s journal into the
    RESP store on ``port``: its stdout lines."""
    conf = os.path.join(wd, f"conf_{port}.yaml")
    with open(conf, "w") as f:
        f.write(f'redis.host: "127.0.0.1"\nredis.port: {port}\n'
                "jax.obs.shard: true\njax.window.slots: 128\n")
    proc = subprocess.run(
        [sys.executable, "-m", module, "--confPath", conf, "--workdir", wd,
         "--catchup", "--sharded", "--engine", engine, *extra],
        capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


def cli_against_jax(tmp_path, engine: str) -> tuple:
    """``--sharded --engine ENGINE`` of both CLIs over one generated
    journal, each into its own RESP store: (port stdout, port store, JAX
    store)."""
    wd = str(tmp_path)
    gen.do_setup(None, default_config(),
                 broker=FileBroker(os.path.join(wd, "broker")),
                 events_num=8_000, rng=random.Random(21), workdir=wd)
    campaigns, _ = gen.load_ids(wd)
    ports = [free_port(), free_port()]
    servers = [_resp_server(p) for p in ports]
    try:
        for p in ports:
            seed_campaigns(RespClient("127.0.0.1", p), campaigns)
        lines = _cli("streambench_tpu_torch.engine", wd, ports[0], engine,
                     ["--device", "cpu"])
        _cli("streambench_tpu.engine", wd, ports[1], engine)
        return (lines, RespClient("127.0.0.1", ports[0]),
                RespClient("127.0.0.1", ports[1]), servers)
    except BaseException:
        for s in servers:
            s.kill()
            s.communicate()
        raise


def test_cli_sharded_hll_on_cpu_matches_the_jax_cli(tmp_path):
    lines, got, want, servers = cli_against_jax(tmp_path, "hll")
    try:
        assert any("engine up:" in ln and "engine=hll" in ln
                   and "mesh=1x1 backend=gloo" in ln for ln in lines)
        stats = json.loads(lines[-1])
        assert stats["events"] == 8_000 and stats["dropped"] == 0
        assert stats["shard_skew"]["shards"] == 1
        g, w = _rows(read_seen_counts(got)), _rows(read_seen_counts(want))
        assert set(g) == set(w) and g
        assert max(abs(g[k] - w[k]) for k in w) <= 1
    finally:
        for s in servers:
            s.kill()
            s.communicate()


@pytest.mark.parametrize("engine", ["hll", "sliding", "session"])
def test_cli_sharded_sketch_without_cuda_raises(tmp_path, engine):
    """The default device is the card: without one, ``--sharded --engine``
    fails (rc != 0) instead of carrying on on the CPU."""
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
         "--workdir", str(tmp_path), "--catchup", "--sharded", "--engine",
         engine], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_harness_sharded_hll_with_obs_shard_on_cpu(tmp_path):
    """``SHARDED=1 ENGINE=hll OBS_SHARD=1 TORCH_TEST`` on the CPU: the
    engine comes up on the (1, 1) gloo mesh, writes window rows and
    reports the shard's skew; every event the load emitted is folded."""
    from tests.test_torch_harness import run_harness

    wd = str(tmp_path / "run")
    env = {"WORKDIR": wd, "REDIS_PORT": str(free_port()), "LOAD": "400",
           "TEST_TIME": "6", "STOP_STATS_GRACE": "2", "TOPIC": "ad-events",
           "DEVICE": "cpu", "ENGINE": "hll", "SHARDED": "1",
           "OBS_SHARD": "1"}
    try:
        proc = run_harness(["TORCH_TEST"], env, timeout=240)
    finally:
        run_harness(["STOP_ALL"], env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    log = open(os.path.join(wd, "logs", "engine.log")).read()
    assert "engine=hll" in log and "mesh=1x1 backend=gloo" in log
    stats = json.loads(log.strip().splitlines()[-1])
    emitted = int(open(os.path.join(wd, "logs", "load.log")).read()
                  .split("emitted ")[-1].split()[0])
    assert stats["events"] == emitted > 0 and stats["dropped"] == 0
    assert stats["shard_skew"]["shards"] == 1
    assert "TORCH_TEST evidence:" in proc.stdout + proc.stderr


# chip_smoke.py phase 18, rehearsed on the CPU at a small size
def test_chip_smoke_phase18_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 18 through the smoke's own code on a (1, 1) gloo mesh: the
    sharded HLL (plain and with ``jax.obs.shard``), sliced sliding,
    fixed and SALSA session engines over phases 15's and 16's journals
    (150,000 events; 20,000 of 2,000 users and the tail, a 64-cell
    sketch), each held to its phase's result, and the two-stage refusal;
    the card runs it at 1,000,000 and 3,000,000 events."""
    import chip_smoke

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        return str(path)

    monkeypatch.setattr(chip_smoke, "_workdir", workdir)
    _, sk = chip_smoke.phase_sketches(150_000, device="cpu", keep=True)
    _, ses = chip_smoke.phase_session(20_000, 2_000, device="cpu",
                                      two_stage_events=5_000, cms_width=64,
                                      keep=True)
    out = chip_smoke.phase_sharded_sketches(sk, ses, device="cpu")
    assert out["backend"] == "gloo"
    assert out["hll"]["windows_equal_phase15"] > 1_000
    assert out["hll_obs_shard"]["shard_skew"]["rows"] == [sk["views"]]
    assert out["sliced"]["quantile_max_rel_err_phase15"] <= 2.0 ** -5
    assert out["sliced"]["windows_equal_phase15_sampled"] > 1_000
    assert out["fixed"]["equal_arrays_phase16"] == 11
    assert out["salsa"]["equal_arrays_phase16"] == 13
    assert out["fixed"]["expired"] == out["fixed"]["expired_want"] > 0
    assert "stages=2" in out["two_stage_refused"]
    # the hoisted scan's hand counts, on the engines the phase ran
    assert out["fixed"]["collectives"]["scan"]["per_dispatch"][
        "by_kind"] == {"all-gather": 2, "all-reduce": 2}
    assert out["sliced"]["collectives"]["step"]["per_dispatch"][
        "by_kind"] == {"all-gather": 4, "all-reduce": 1}
    # both journals removed
    assert not os.path.exists(str(tmp_path / "smoke_sketch"))
    assert not os.path.exists(str(tmp_path / "smoke_session"))
