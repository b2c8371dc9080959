"""The port's sharded reach engine against the JAX package's, on the CPU.

The same numpy inputs (``tests/test_sharded_reach.py``'s: C = 10
campaigns, k = 32 slots, R = 32 registers, B = 64 rows, 3 batches, a join
miss and negative ad indices among the rows) go through JAX's
``parallel/reach.py`` step, scan and query programs on the virtual
8-device CPU mesh, and through the port's ``reach_fold_step`` /
``reach_fold_scan`` / ``reach_query`` on gloo ranks: the mesh (1, 1) in
this process, (1, 2) as two spawned ranks, (2, 2) and (1, 4) as four
(10 campaigns pad to 12 on four shards).  The gathered planes must be
bit-identical to JAX's and to the port's unsharded ``minhash.step``; the
query's ``agree`` and floats bit-identical to the unsharded
``batch_query``'s, all-False rows included, ``agree`` bit-identical to
JAX's and the floats within rtol 1e-6 (the port's ``hll.estimate`` may
differ from JAX's in the last place); each query dispatch records
exactly two collectives.

The same spawn then runs the engine over one generated journal: rank 0
drives ``ShardedReachEngine`` under ``StreamRunner.run_catchup`` with a
query server (the sharded evaluator installed by ``attach_reach``)
answering a storm while the journal folds, every answer held to one of
the pushed generations; then the snapshot round trip, the
single-device -> sharded upgrade, and a query that comes in while the
engine closes (refused, not hung).  Planes against the port's unsharded
engine and JAX's ``ShardedReachEngine`` on the same mesh shape.  Last,
the CLI (``--sharded --engine reach``) against the unsharded CLI and
``SHARDED=1 ENGINE=reach`` under ``TORCH_TEST``.  Each spawned rank has
its own ``communicate(timeout=...)``.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.ops import windowcount as jwc
from streambench_tpu.parallel import build_mesh as jax_build_mesh
from streambench_tpu.parallel import reach as jreach
from streambench_tpu.parallel.sharded import data_axis_pad as jax_data_pad
from streambench_tpu.parallel.sharded import pad_data_cols as jax_pad_cols
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import StreamRunner
from streambench_tpu_torch.engine.sketches import ReachSketchEngine
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.ops import minhash
from streambench_tpu_torch.reach import query as rq
from tests.test_torch_engine import REPO, TOPIC
from tests.test_torch_harness import free_port, run_harness
from tests.test_torch_reach_engine import reach_journal
from tests.test_torch_sharded_hll import load_ranks, run_in_process, spawn

torch.set_num_threads(1)

C, K_SLOTS, R, B, NB, Q = 10, 32, 32, 64, 3, 16
B_ODD = 63                     # a B no data axis of these meshes divides
MESHES = [(1, 1), (1, 2), (2, 2), (1, 4)]
CASES = ["step", "scan", "scan_packed", "odd_step"]
EVENTS, BATCH = 4_000, 249     # 249 rows pad on a data axis of 2
STORM = 200

RANK_PROGRAM = r'''
import json, os, pickle, sys, threading, time
import numpy as np
import torch

STORM_THREADS = 4

def run_cases(mesh, inp, outdir):
    from streambench_tpu_torch.config import default_config
    from streambench_tpu_torch.ops import minhash
    from streambench_tpu_torch.ops import windowcount as wc
    from streambench_tpu_torch.parallel import reach as PR
    from streambench_tpu_torch.parallel import sharded as S
    jt = torch.from_numpy(inp["join"])
    C, K, R, B_ODD = (int(inp[k]) for k in ("C", "K", "R", "B_ODD"))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    axes = S.mesh_axes(mesh, C)
    cols = [inp[k] for k in ("ad", "user", "et", "tm", "va")]
    # the wire word has no sign: a negative ad index ships wrapped, as
    # the gather reads it
    words = np.stack([wc.pack_columns(a % len(inp["join"]), e, v)
                      for a, e, v in zip(inp["ad"], inp["et"], inp["va"])])
    packed = [words, inp["user"], inp["tm"]]
    NB = cols[0].shape[0]
    local = lambda xs: [S.data_slice(mesh, T(x)) for x in xs]
    init = lambda: PR.sharded_reach_init(C, K, R, mesh)

    def save(case, st):
        np.savez(os.path.join(outdir, f"{case}_r{mesh.rank}.npz"),
                 mins=minhash.mins_numpy(st.mins),
                 registers=st.registers.numpy(), wm=int(st.watermark),
                 dropped=int(st.dropped))

    st = init()
    for k in range(NB):
        st = PR.reach_fold_step(st, jt, local([x[k] for x in cols]), axes,
                                packed=False)
    save("step", st)
    save("scan", PR.reach_fold_scan(init(), jt, local(cols), axes,
                                    packed=False))
    save("scan_packed", PR.reach_fold_scan(init(), jt, local(packed), axes,
                                           packed=True))
    pad = S.data_axis_pad(B_ODD, mesh)
    odd = S.pad_data_cols(pad, *(T(c[:, :B_ODD]) for c in cols))
    st = init()
    for k in range(NB):
        st = PR.reach_fold_step(st, jt, [S.data_slice(mesh, c[k])
                                         for c in odd], axes, packed=False)
    save("odd_step", st)

    # the query next to the shards on the scanned planes: this rank's
    # columns of the mask padded to the sharded width
    st = PR.reach_fold_scan(init(), jt, local(cols), axes, packed=False)
    cl = st.mins.shape[0]
    mask = np.pad(inp["mask"], ((0, 0), (0, cl * mesh.shape["campaign"]
                                         - C)))
    from streambench_tpu_torch.parallel import collectives
    rec = collectives.Recorder()
    out = PR.reach_query(st.mins, st.registers,
                         T(mask[:, axes.c0:axes.c0 + cl]), T(inp["overlap"]),
                         axes, recorder=rec)
    np.savez(os.path.join(outdir, f"query_r{mesh.rank}.npz"),
             **{k: v.numpy() for k, v in zip(
                 ("est", "union", "jacc", "agree"), out)},
             ops=len(rec.ops))

    # the engine's collective report
    from streambench_tpu_torch.parallel import ShardedReachEngine
    mapping = {f"ad{i}": f"c{i % 7}" for i in range(40)}
    eng = ShardedReachEngine(default_config(jax_batch_size=64), mapping,
                             mesh, k=K, registers=R, device="cpu")
    rep = (eng.collective_report(k=3, query_batch=16) if mesh.rank == 0
           else eng.follow())
    if mesh.rank == 0:
        eng.close()
        with open(os.path.join(outdir, "report.json"), "w") as f:
            json.dump(rep, f)
    spec = os.path.join(outdir, "spec.json")
    if os.path.exists(spec):
        run_engine(mesh, json.load(open(spec)), outdir)

def run_engine(mesh, spec, outdir):
    """The engine end to end on one mesh (module doc)."""
    from streambench_tpu_torch.config import default_config
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.engine import StreamRunner
    from streambench_tpu_torch.engine.sketches import ReachSketchEngine
    from streambench_tpu_torch.io.journal import FileBroker
    from streambench_tpu_torch.parallel import ShardedReachEngine
    from streambench_tpu_torch.reach.serve import ReachQueryServer

    wd, K, R = spec["workdir"], spec["k"], spec["registers"]
    cfg = default_config(kafka_topic=spec["topic"],
                         jax_batch_size=spec["batch"],
                         jax_scan_batches=4, jax_flush_interval_ms=0)
    mapping = gen.load_ad_mapping_file(
        os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE))
    campaigns = spec["campaigns"]
    make = lambda: ShardedReachEngine(cfg, mapping, mesh,
                                      campaigns=campaigns, k=K,
                                      registers=R, device="cpu")
    reader = lambda: FileBroker(os.path.join(wd, "broker")).reader(
        spec["topic"])
    engines = [make() for _ in range(4)]
    if mesh.rank != 0:
        for eng in engines:
            eng.follow()
            eng.close()
        return
    eng, up, back, late = engines
    # A: the catchup with a query storm on the server's thread; every
    # push's whole planes are recorded beside it
    pushed = []
    push = eng._push_planes
    def recording_push():
        out = push()
        p = eng.planes()
        pushed.append((p["mins"], p["registers"]))
        return out
    eng._push_planes = recording_push
    srv = ReachQueryServer(campaigns, depth=4096, batch=8)
    eng.attach_reach(srv)
    rng = np.random.default_rng(7)
    sets = [sorted(rng.choice(len(campaigns), size=int(rng.integers(1, 4)),
                              replace=False).tolist())
            for _ in range(spec["storm"])]
    answers = {}
    lock = threading.Lock()
    def reply(d):
        with lock:
            answers[d["id"]] = d
    def storm(first):
        for i in range(first, len(sets), STORM_THREADS):
            srv.submit([campaigns[j] for j in sets[i]],
                       "overlap" if i % 2 else "union", reply, query_id=i)
            time.sleep(0.002)
    # more submitting threads than the rank's cores, and a short switch
    # interval, while the host loop folds, pushes and commands
    threads = [threading.Thread(target=storm, args=(t,))
               for t in range(STORM_THREADS)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        stats = StreamRunner(eng, reader()).run_catchup()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    deadline = time.monotonic() + 60
    while len(answers) < len(sets) and time.monotonic() < deadline:
        time.sleep(0.01)
    srv.close()
    host = eng.host_state()
    masks = np.zeros((len(sets), len(campaigns)), bool)
    for i, s in enumerate(sets):
        masks[i, s] = True
    overlap = np.arange(len(sets)) % 2 == 1
    est, union, jacc, agree = eng.batch_query(masks, overlap)
    snap = eng.snapshot(offset=11)
    eng.close()
    # B: the single-device -> sharded upgrade, and the round trip
    flat = ReachSketchEngine(cfg, mapping, campaigns=campaigns, k=K,
                             registers=R, device="cpu")
    StreamRunner(flat, reader()).run_catchup()
    up.restore(flat.snapshot(offset=12))
    up_host = up.host_state()
    up_epoch = up.reach_epoch
    up.close()
    back.restore(snap)
    back_host = back.host_state()
    back.close()
    down = ReachSketchEngine(cfg, mapping, campaigns=campaigns, k=K,
                             registers=R, device="cpu")
    down.restore(snap)
    down_planes = down.planes()
    # C: the engine closes with its server still up, and a query comes in
    # just after the close sent its other ranks stop: it must wait for
    # the close and be refused, not command ranks that no longer follow
    srv = ReachQueryServer(campaigns, batch=8)
    late.attach_reach(srv)
    late_answers = []
    command = late._command
    def command_then_query(name, *args, **kw):
        out = command(name, *args, **kw)
        if name == "stop":
            srv.submit([campaigns[0]], "union", late_answers.append,
                       query_id=0)
            time.sleep(0.5)         # the server's thread meets the lock
        return out
    late._command = command_then_query
    t0 = time.monotonic()
    late.close()
    while not late_answers and time.monotonic() < t0 + 60:
        time.sleep(0.01)
    late_seconds = time.monotonic() - t0
    srv.close()
    with open(os.path.join(outdir, "engine.pkl"), "wb") as f:
        pickle.dump({
            "events": stats.events, "planes": (host.mins, host.registers),
            "watermark": host.watermark, "pushed": pushed,
            "answers": answers, "sets": sets, "masks": masks,
            "overlap": overlap,
            "batch_query": (est, union, jacc, agree),
            "snap_epoch": int(snap.meta["reach_epoch"]),
            "flat_planes": (flat.planes()["mins"],
                            flat.planes()["registers"]),
            "flat_epoch": flat.reach_epoch,
            "up": (up_host.mins, up_host.registers), "up_epoch": up_epoch,
            "back": (back_host.mins, back_host.registers),
            "down": (down_planes["mins"], down_planes["registers"]),
            "late": (late_answers, late_seconds),
        }, f)
''' + r'''
if __name__ == "__main__":
    sys.path.insert(0, sys.argv[1])
    torch.set_num_threads(1)
    from streambench_tpu_torch.parallel import build_mesh
    outdir = sys.argv[3]
    d, c = int(sys.argv[4]), int(sys.argv[5])
    mesh = build_mesh(d, c, device="cpu", timeout_s=120)
    run_cases(mesh, dict(np.load(os.path.join(outdir, "inputs.npz"))),
              outdir)
    # leave together: a rank that exits with its groups alive can abort
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
'''


def make_join(n_ads=14):
    """``tests/test_sharded_reach.py:36-41``: several ads a campaign and
    a join miss (-1) in the last slot."""
    rng = np.random.default_rng(3)
    return np.concatenate([rng.integers(0, C, n_ads - 1),
                           [-1]]).astype(np.int32)


def rand_batches(rng, n_batches, B, join):
    """``tests/test_sharded_reach.py:44-56``."""
    out = []
    t = 70_000
    for _ in range(n_batches):
        out.append((
            rng.integers(0, len(join), B).astype(np.int32),
            rng.integers(0, 4000, B).astype(np.int32),
            rng.integers(0, 3, B).astype(np.int32),
            (t + rng.integers(0, 5_000, B)).astype(np.int32),
            rng.random(B) < 0.9,
        ))
        t += 5_000
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(17)
    join = make_join()
    bs = rand_batches(rng, NB, B, join)
    # negative ad indices: JAX's gather wraps them into the table
    bs[0][0][:4] = [-1, -2, -3, -14]
    bs[0][2][:4] = 0
    bs[0][4][:4] = True
    mask = rng.random((Q, C)) < 0.3
    mask[0] = False                     # an all-False row
    mask[1] = True                      # every campaign
    mask[2] = False
    mask[2, join[0]] = True             # one campaign alone
    return {"join": join, "C": C, "K": K_SLOTS, "R": R, "B_ODD": B_ODD,
            "mask": mask, "overlap": np.arange(Q) % 2 == 1,
            **{k: np.stack([b[i] for b in bs])
               for i, k in enumerate(("ad", "user", "et", "tm", "va"))}}


@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("sharded_reach"))
    campaigns = reach_journal(wd, EVENTS, 2, seed=29, users=1_500)
    return wd, campaigns


@pytest.fixture(scope="module")
def port_results(inputs, journal, tmp_path_factory):
    """``shape -> (case -> result, outdir)``, one run per mesh on first
    use: the cases, the report and the engine."""
    cache = {}

    def get(shape):
        if shape not in cache:
            outdir = str(tmp_path_factory.mktemp("mesh_%dx%d" % shape))
            np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
            wd, campaigns = journal
            with open(os.path.join(outdir, "spec.json"), "w") as f:
                json.dump({"workdir": wd, "campaigns": campaigns,
                           "topic": TOPIC, "batch": BATCH, "k": K_SLOTS,
                           "registers": R, "storm": STORM}, f)
            if shape == (1, 1):
                run_in_process(RANK_PROGRAM, "cases", outdir, inputs)
            else:
                spawn(RANK_PROGRAM, "cases", outdir, shape)
            results = {case: load_ranks(outdir, shape, case,
                                        ("mins", "registers"))
                       for case in CASES}
            results["query"] = load_ranks(outdir, shape, "query", ())
            cache[shape] = (results, outdir)
        return cache[shape]
    return get


def _jax_mesh(shape):
    d, c = shape
    return jax_build_mesh(data=d, campaign=c, devices=jax.devices()[:d * c])


def _jax_case(shape, case, inp) -> dict:
    """The JAX package's planes of ``case`` on a ``shape`` mesh."""
    mesh = _jax_mesh(shape)
    jt = inp["join"]
    cols = [inp[k] for k in ("ad", "user", "et", "tm", "va")]
    st = jreach.sharded_reach_init(C, K_SLOTS, R, mesh)
    args = (st.mins, st.registers, st.watermark)
    if case == "step":
        fn = jreach._build_reach_step(mesh)
        for k in range(NB):
            args = fn(*args, jt, *(x[k] for x in cols))
    elif case == "scan":
        args = jreach._build_reach_scan(mesh)(*args, jt, *cols)
    elif case == "scan_packed":
        words = np.stack([jwc.pack_columns(a % len(jt), e, v)
                          for a, e, v in zip(inp["ad"], inp["et"],
                                             inp["va"])])
        args = jreach._build_reach_scan(mesh, packed=True)(
            *args, jt, words, inp["user"], inp["tm"])
    else:
        fn = jreach._build_reach_step(mesh)
        odd = jax_pad_cols(jax_data_pad(B_ODD, mesh),
                           *(x[:, :B_ODD] for x in cols))
        for k in range(NB):
            args = fn(*args, jt, *(x[k] for x in odd))
    mins, regs, wm = (np.asarray(x) for x in args)
    return {"mins": mins, "registers": regs, "wm": int(wm)}


def _unsharded(case, inp) -> dict:
    """The port's single-device ``minhash.step`` over the case's rows."""
    jt = torch.from_numpy(inp["join"])
    n = B_ODD if case == "odd_step" else B
    st = minhash.init_state(C, K_SLOTS, R)
    for k in range(NB):
        st = minhash.step(st, jt, *(torch.from_numpy(
            np.ascontiguousarray(inp[c][k, :n]))
            for c in ("ad", "user", "et", "tm", "va")))
    return {"mins": minhash.mins_numpy(st.mins),
            "registers": st.registers.numpy(), "wm": int(st.watermark),
            "state": st}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_sharded_reach_fold_bit_identical_to_jax_and_unsharded(
        port_results, inputs, shape, case):
    got = port_results(shape)[0][case]
    want = _jax_case(shape, case, inputs)
    flat = _unsharded(case, inputs)
    # pad rows stay untouched: EMPTY signatures, zero registers
    assert (got["mins"][C:] == np.uint32(minhash.EMPTY)).all()
    assert (got["registers"][C:] == 0).all()
    for key in ("mins", "registers"):
        assert np.array_equal(got[key], want[key]), key
        assert np.array_equal(got[key][:C], flat[key]), key
    assert got["wm"] == want["wm"] == flat["wm"]
    assert got["dropped"] == 0
    assert (got["mins"][:C] != np.uint32(minhash.EMPTY)).any()


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_query_next_to_the_shards_bit_identical(port_results, inputs,
                                                shape):
    """The query on the scanned planes: replicated on every rank, equal to
    the unsharded ``batch_query`` (all four outputs) and to JAX's sharded
    query, the all-False row answering 0; two collectives."""
    got = port_results(shape)[0]["query"]
    assert int(got["ops"]) == 2
    flat = _unsharded("scan", inputs)["state"]
    want = [x.numpy() for x in rq.batch_query(
        flat.mins, flat.registers, inputs["mask"], inputs["overlap"])]
    for key, w in zip(("est", "union", "jacc", "agree"), want):
        assert np.array_equal(got[key], w), key
    mesh = _jax_mesh(shape)
    js = _jax_case(shape, "scan", inputs)
    c_pad = js["mins"].shape[0]
    jmask = np.pad(inputs["mask"], ((0, 0), (0, c_pad - C)))
    jout = [np.asarray(x) for x in jreach._build_reach_query(mesh)(
        js["mins"], js["registers"], jmask, inputs["overlap"])]
    # agree exact; the floats through the port's hll.estimate, which may
    # differ from JAX's in the last place
    assert np.array_equal(got["agree"], jout[3])
    for key, w in zip(("est", "union", "jacc"), jout):
        np.testing.assert_allclose(got[key], w, rtol=1e-6, err_msg=key)
    assert got["agree"][0] == 0 and got["union"][0] == 0.0
    # one campaign alone agrees with itself in every slot it filled
    assert got["agree"][2] == int((minhash.mins_numpy(flat.mins)[
        inputs["join"][0]] != minhash.EMPTY).sum()) > 0


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_each_query_dispatch_records_two_collectives(port_results, shape):
    """The engine's report: one MIN of ``[Q, k]`` and one MAX of ``[Q, k +
    R]``, int64, on the campaign group; the fold's step gathers its five
    columns, the hoisted scan its stacks once, nothing in the loop."""
    with open(os.path.join(port_results(shape)[1], "report.json")) as f:
        rep = json.load(f)
    per = rep["query"]["per_dispatch"]
    assert per["ops"] == 2 and per["by_kind"] == {"all-reduce": 2}
    assert per["bytes"] == 16 * K_SLOTS * 8 + 16 * (K_SLOTS + R) * 8
    assert rep["query_batch"] == 16
    cols = 3 if rep["packed"] else 5
    assert rep["step"]["per_dispatch"]["by_kind"] == {"all-gather": 5}
    assert rep["scan"]["per_dispatch"]["by_kind"] == {"all-gather": cols}
    assert rep["scan"]["per_loop_iteration"]["ops"] == 0


@pytest.fixture(scope="module")
def flat_engine(journal):
    """The port's unsharded engine over the journal."""
    wd, campaigns = journal
    cfg = default_config(kafka_topic=TOPIC, jax_batch_size=BATCH)
    mapping = gen.load_ad_mapping_file(
        os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE))
    eng = ReachSketchEngine(cfg, mapping, campaigns=campaigns, k=K_SLOTS,
                            registers=R, device="cpu")
    StreamRunner(eng, FileBroker(os.path.join(wd, "broker")).reader(
        TOPIC)).run_catchup()
    return eng


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_engine_serves_a_storm_while_folding(port_results, journal,
                                             flat_engine, shape):
    """The catchup's planes equal the unsharded engine's and JAX's sharded
    engine's on the same mesh shape; every storm answer equals the
    unsharded evaluation on one of the pushed generations (no answer
    mixes shards of two pushes); the direct ``batch_query`` equals the
    unsharded one bit for bit."""
    with open(os.path.join(port_results(shape)[1], "engine.pkl"),
              "rb") as f:
        out = pickle.load(f)
    wd, campaigns = journal
    assert out["events"] == EVENTS
    fp = flat_engine.planes()
    assert np.array_equal(out["planes"][0], fp["mins"])
    assert np.array_equal(out["planes"][1], fp["registers"])
    assert out["watermark"] == int(flat_engine.state.watermark)

    jcfg = jax_default_config(kafka_topic=TOPIC, jax_batch_size=BATCH)
    mapping = gen.load_ad_mapping_file(
        os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE))
    jeng = jreach.ShardedReachEngine(jcfg, mapping, _jax_mesh(shape),
                                     campaigns=campaigns, k=K_SLOTS,
                                     registers=R)
    JaxRunner(jeng, JaxBroker(os.path.join(wd, "broker")).reader(
        TOPIC)).run_catchup()
    jh = jeng.host_state()
    assert np.array_equal(out["planes"][0], jh.mins)
    assert np.array_equal(out["planes"][1], jh.registers)

    masks, overlap = out["masks"], out["overlap"]
    want = [x.numpy() for x in rq.batch_query(
        flat_engine.state.mins, flat_engine.state.registers, masks,
        overlap)]
    for got, w in zip(out["batch_query"], want):
        assert np.array_equal(got, w)
    jwant = [np.asarray(x) for x in jeng.batch_query(masks, overlap)]
    assert np.array_equal(out["batch_query"][3], jwant[3])
    for got, w in zip(out["batch_query"][:3], jwant):
        np.testing.assert_allclose(got, w, rtol=1e-6)

    # the storm: answered in full, each by one pushed generation
    answers = out["answers"]
    assert len(answers) == STORM and len(out["pushed"]) >= 3
    by_gen = [[round(float(e), 2) for e in rq.batch_query(
        minhash.mins_tensor(m), torch.from_numpy(r), masks, overlap)[0]]
        for m, r in out["pushed"]]
    for i in range(STORM):
        assert "estimate" in answers[i], answers[i]
        assert any(answers[i]["estimate"] == g[i] for g in by_gen), i
    # later answers saw later planes: the final push is the whole journal
    assert by_gen[-1] == [round(float(e), 2) for e in want[0]]


@pytest.mark.parametrize("shape", MESHES[1:], ids=lambda s: "%dx%d" % s)
def test_query_during_close_is_refused_not_hung(port_results, shape):
    """A query the server commands while a multi-rank engine closes waits
    for the close and is refused with the closed-engine error; it does
    not reach ranks that stopped following (a hang until the group's
    timeout)."""
    with open(os.path.join(port_results(shape)[1], "engine.pkl"),
              "rb") as f:
        answers, seconds = pickle.load(f)["late"]
    assert len(answers) == 1, answers
    assert "engine is closed" in answers[0].get("error", ""), answers[0]
    assert seconds < 30, seconds


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_snapshot_round_trip_and_upgrade(port_results, flat_engine, shape):
    """A single-device snapshot restores into the sharded engine with the
    epoch bumped past it; a sharded snapshot restores into a sharded
    engine and into the unsharded one, the planes unchanged."""
    with open(os.path.join(port_results(shape)[1], "engine.pkl"),
              "rb") as f:
        out = pickle.load(f)
    fp = flat_engine.planes()
    for key in ("flat_planes", "up", "back", "down"):
        assert np.array_equal(out[key][0], fp["mins"]), key
        assert np.array_equal(out[key][1], fp["registers"]), key
    assert out["up_epoch"] == out["flat_epoch"] + 1
    assert out["snap_epoch"] == 0


# ----------------------------------------------------------------------
def _conf(path, **keys):
    lines = ['redis.host: ":inprocess:"', f'kafka.topic: "{TOPIC}"',
             'redis.hashtable: "sr_test"']
    lines += [f"{k}: {json.dumps(v)}" for k, v in keys.items()]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _ship_planes(ship_dir):
    """The planes a ship directory's log folds to (a replica's view)."""
    from streambench_tpu_torch.reach.replica import ReachReplica

    rep = ReachReplica(os.path.join(ship_dir, "dimensions.log"),
                       poll_ms=20_000, max_staleness_ms=10**9, device="cpu")
    try:
        assert rep.poll_once()
        st = rep.server._state
        return (minhash.mins_numpy(st[0]), st[1].numpy(),
                list(rep.server.campaigns))
    finally:
        rep.close()


def test_cli_sharded_reach_answers_as_the_unsharded_cli(journal, tmp_path):
    """``--sharded --engine reach --device cpu --catchup`` with a ship
    log (and ``jax.obs.query``, ``.fleet`` and ``.shard``): the mesh line,
    the stats line's serving block, and the shipped planes equal the
    unsharded CLI's."""
    wd, _ = journal
    got = {}
    for sharded in (True, False):
        ship = str(tmp_path / f"ship_{sharded}")
        # the sharded run with the query, fleet and shard obs keys on
        obs = ({"jax.obs.query": True, "jax.obs.fleet": True,
                "jax.obs.shard": True, "jax.metrics.interval.ms": 200}
               if sharded else {})
        conf = _conf(tmp_path / f"conf_{sharded}.yaml",
                     **{"jax.reach.ship.dir": ship, "jax.reach.k": K_SLOTS},
                     **obs)
        proc = subprocess.run(
            [sys.executable, "-m", "streambench_tpu_torch.engine",
             "--confPath", conf, "--workdir", wd, "--catchup", "--device",
             "cpu", "--engine", "reach"] + (["--sharded"] if sharded
                                            else []),
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines = proc.stdout.strip().splitlines()
        assert any("engine up:" in ln and "engine=reach" in ln
                   and ("mesh=1x1 backend=gloo" in ln) == sharded
                   for ln in lines)
        stats = json.loads(lines[-1])
        assert stats["events"] == EVENTS and "reach" in stats
        if sharded:
            assert any(ln.startswith("reach: pubsub=")
                       and "query_obs=on" in ln for ln in lines)
            assert os.path.exists(os.path.join(wd, "metrics.jsonl"))
        got[sharded] = _ship_planes(ship)
    for a, b in zip(got[True], got[False]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_harness_torch_test_with_sharded_reach_on_cpu(tmp_path):
    """``SHARDED=1 ENGINE=reach TORCH_TEST``: the engine comes up on the
    (1, 1) gloo mesh and folds every event the load emitted."""
    wd = str(tmp_path / "run")
    env = {"WORKDIR": wd, "REDIS_PORT": str(free_port()), "LOAD": "400",
           "TEST_TIME": "6", "STOP_STATS_GRACE": "2", "TOPIC": "ad-events",
           "DEVICE": "cpu", "ENGINE": "reach", "SHARDED": "1"}
    try:
        proc = run_harness(["TORCH_TEST"], env, timeout=240)
    finally:
        run_harness(["STOP_ALL"], env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TORCH_TEST evidence:" in proc.stdout + proc.stderr
    log = open(os.path.join(wd, "logs", "engine.log")).read()
    assert "engine=reach" in log and "mesh=1x1 backend=gloo" in log
    stats = json.loads(log.strip().splitlines()[-1])
    emitted = int(open(os.path.join(wd, "logs", "load.log")).read()
                  .split("emitted ")[-1].split()[0])
    assert stats["events"] == emitted > 0 and stats["dropped"] == 0
    assert "reach" in stats
