"""The port's sharded session + count-min fold and engine against the JAX
package's, on the CPU.

The same numpy inputs (``tests/test_sharded_sketches.py``'s session
cases, widened: U = 256 users of capacity, 320 users in the stream so
the capacity drops have work, B = 96 rows, 6 batches 40 s apart, gap
15 s, lateness 20 s, a ``[4, 256]`` sketch and a 256-key ring) go through
JAX's ``_build_session_step`` / ``_build_session_scan`` / ``_build_session_flush``
and their SALSA forms on the virtual 8-device CPU mesh, and through the
port's ``session_fold_step`` / ``session_fold_scan`` / ``session_fold_flush``
on gloo ranks: (1, 1) in this process, (4, 1), (2, 2) and (1, 4) as four
spawned ranks.  The user-sharded session arrays (every rank's slice, in
rank order), the watermark, ``dropped``, the sketch (fixed table or the
SALSA plane and its merge bits), the ring, the counters and the latency
histogram must be bit-identical to JAX's and to the port's unsharded
fold (``session.step`` + the sketch's update + ``cms.update_topk`` a
closed set).  The closed rows arrive shard-major at (2, 2) and (1, 4):
the sketch's sums and the SALSA homomorphism, and the ring's ordering by
(estimate, key), make that order invisible.

Then the engine end to end at (2, 2), fixed and SALSA: the ring, sketch
and counters equal to the unsharded engine's, the heavy hitters to JAX's
sharded engine's, the clicks to the journal's exact count, a resume from
the unsharded engine's snapshot and a restore of the sharded one's into
the unsharded engine; both refusals; the collective counts against the
reference's hand counts; the CLI against the JAX CLI.
"""

import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.engine.sketches import LAT_BINS
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.parallel import ShardedSessionCMSEngine as JaxSess
from streambench_tpu.parallel import build_mesh as jax_build_mesh
from streambench_tpu.parallel import sketches as jsk
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import StreamRunner, sketches
from streambench_tpu_torch.engine.sketches import _hist_rows
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.ops import cms, salsa, session
from tests.test_torch_sharded_hll import (
    RANK_MAIN,
    cli_against_jax,
    port_results_fixture,
    spawn,
)

torch.set_num_threads(1)

U, M, B, NB, D, WD = 256, 256, 96, 6, 4, 256
GAP, LATE, NOW = 15_000, 20_000, 600_000
MESHES = [(1, 1), (4, 1), (2, 2), (1, 4)]
CASES = [f"{arm}_{fam}" for fam in ("fixed", "salsa")
         for arm in ("step", "scan_hoisted", "scan_perbatch", "flush")]
CLOCK_MS = 1_700_000_400_000
USERS = ("lt", "ss", "ck")

RANK_PROGRAM = r'''
import json, os, sys
import numpy as np
import torch

def carry0(U, D, WD, M, fam, device="cpu", users=None):
    from streambench_tpu_torch.ops import salsa
    n = users or U
    i32 = dict(dtype=torch.int32)
    sk = (tuple(salsa.init_state(D, WD)) if fam == "salsa"
          else (torch.zeros((D, WD), **i32), torch.zeros((), **i32)))
    return (torch.full((n,), -1, **i32), torch.zeros(n, **i32),
            torch.zeros(n, **i32), torch.zeros((), **i32),
            torch.zeros((), **i32), *sk, torch.full((M,), -1, **i32),
            torch.full((M,), -1, **i32), torch.zeros((), **i32),
            torch.zeros((), **i32), torch.zeros(481, **i32))

def run_cases(mesh, inp, outdir):
    from streambench_tpu_torch.parallel import collectives
    from streambench_tpu_torch.parallel import sharded as S
    from streambench_tpu_torch.parallel import sketches as SK
    U, M, D, WD, GAP, LATE, NOW = (int(inp[k]) for k in
                                   ("U", "M", "D", "WD", "GAP", "LATE",
                                    "NOW"))
    axes = S.mesh_axes(mesh, 1)
    cols = [torch.from_numpy(inp[k]) for k in ("user", "et", "tm", "va")]
    NB = cols[0].shape[0]
    kw = dict(gap_ms=GAP, lateness_ms=LATE, user_capacity=U)
    Ul = U // mesh.size

    def save(case, out):
        names = ["lt", "ss", "ck", "wm", "dr"] + [
            f"sk{i}" for i in range(len(out) - 10)] + [
            "tkk", "tke", "cn", "cl", "hist"]
        np.savez(os.path.join(outdir, f"{case}_r{mesh.rank}.npz"),
                 **{n: x.numpy() for n, x in zip(names, out)})

    for fam in ("fixed", "salsa"):
        sp = fam == "salsa"
        init = lambda: carry0(U, D, WD, M, fam, users=Ul)
        out = init()
        for k in range(NB):
            out = SK.session_fold_step(out, NOW, [c[k] for c in cols], axes,
                                       salsa_plane=sp, **kw)
        save(f"step_{fam}", out)
        fkw = dict(kw)
        fkw.pop("user_capacity")
        out = SK.session_fold_flush(out, NOW + 60_000, axes, salsa_plane=sp,
                                    force=False, **fkw)
        out = SK.session_fold_flush(out, NOW, axes, salsa_plane=sp,
                                    force=True, **fkw)
        save(f"flush_{fam}", out)
        for hoist, arm in ((True, "hoisted"), (False, "perbatch")):
            out = init()
            for lo in range(0, NB, 3):
                out = SK.session_fold_scan(out, NOW, [c[lo:lo + 3]
                                                      for c in cols], axes,
                                           salsa_plane=sp, hoist=hoist, **kw)
            save(f"scan_{arm}_{fam}", out)
        if mesh.size == 4 and mesh.shape["data"] == 2:
            # the per-batch arm's collectives: the engine never dispatches
            # it, so its count comes from a recorder here
            rep = collectives.report_for(
                lambda rec: SK.session_fold_scan(
                    init(), NOW, [c[:3] for c in cols], axes,
                    salsa_plane=sp, hoist=False, recorder=rec, **kw),
                scan_len=3)
            with open(os.path.join(outdir, f"perbatch_{fam}.json"),
                      "w") as f:
                json.dump(rep, f)
    if mesh.size == 4 and mesh.shape["data"] == 2:
        from streambench_tpu_torch.config import default_config
        from streambench_tpu_torch.parallel import ShardedSessionCMSEngine
        mapping = {f"ad{i}": f"c{i % 7}" for i in range(40)}
        cfg = default_config(jax_batch_size=64)
        try:
            ShardedSessionCMSEngine(cfg, mapping, mesh, device="cpu",
                                    user_capacity=1022)
            refused = None
        except ValueError as e:
            refused = str(e)
        reps = {"refused": refused}
        for mode in ("fixed", "salsa"):
            eng = ShardedSessionCMSEngine(cfg, mapping, mesh, device="cpu",
                                          user_capacity=1024, cms_mode=mode)
            if mesh.rank != 0:
                eng.follow()
                continue
            reps[mode] = eng.collective_report(k=3)
            eng.close()
        if mesh.rank == 0:
            with open(os.path.join(outdir, "reports.json"), "w") as f:
                json.dump(reps, f)

def run_engine(mesh, spec):
    """Run A fresh, run B resumed from the unsharded engine's snapshot,
    no wall-clock drain (the catchup's last one only), under the injected
    clock: each run's session arrays at the catchup's end, its sketch,
    ring and counters after close."""
    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.config import default_config
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.engine import StreamRunner, sketches
    from streambench_tpu_torch.io.journal import FileBroker
    from streambench_tpu_torch.parallel import ShardedSessionCMSEngine

    sketches.now_ms = lambda: spec["clock"]
    wd = spec["workdir"]
    cfg = default_config(jax_batch_size=spec["batch"])
    mapping = gen.load_ad_mapping_file(
        os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE))
    campaigns, _ = gen.load_ids(wd)
    out = {}
    for run in ("A", "B"):
        eng = ShardedSessionCMSEngine(cfg, mapping, mesh,
                                      campaigns=campaigns, device="cpu",
                                      user_capacity=spec["capacity"],
                                      gap_ms=spec["gap"],
                                      cms_mode=spec["mode"])
        if mesh.rank != 0:
            eng.follow()
            eng.close()
            continue
        ckpt = (Checkpointer(spec["checkpoint_dir"]) if run == "B"
                else None)
        reader = FileBroker(os.path.join(wd, "broker")).reader(
            cfg.kafka_topic)
        runner = StreamRunner(eng, reader, checkpointer=ckpt,
                              flush_interval_ms=10**9)
        resumed = runner.resume() if run == "B" else False
        st = runner.run_catchup()
        whole = eng._command("gather_state")     # before close's flush
        eng.close()
        out[run] = {"events": eng.events_processed, "dropped": eng.dropped,
                    "resumed": resumed, "run_events": st.events,
                    "closed": eng.sessions_closed,
                    "clicks": eng.session_clicks,
                    "hh": eng.heavy_hitters(),
                    "state": [t.tolist() for t in whole[:3]],
                    "sketch": [np.asarray(t).tolist() for t in eng.cms],
                    "ring": [t.tolist() for t in eng.topk],
                    "hist": eng.lat_hist.tolist()}
    if mesh.rank == 0:
        print(json.dumps(out), flush=True)
''' + RANK_MAIN


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    t = 70_000
    bs = []
    for _ in range(NB):
        user = rng.integers(0, U + 64, B).astype(np.int32)
        et = rng.integers(0, 3, B).astype(np.int32)
        tm = (t + np.sort(rng.integers(0, 40_000, B))).astype(np.int32)
        valid = rng.random(B) < 0.9
        t += 40_000
        bs.append((user, et, tm, valid))
    # a late row in the last batch: behind the lateness bound
    bs[-1][2][0] = 1_000
    bs[-1][3][0] = True
    return {"U": U, "M": M, "D": D, "WD": WD, "GAP": GAP, "LATE": LATE,
            "NOW": NOW, **{k: np.stack([b[i] for b in bs])
                           for i, k in enumerate(("user", "et", "tm",
                                                  "va"))}}


@pytest.fixture(scope="module")
def port_results(inputs, tmp_path_factory):
    return port_results_fixture(RANK_PROGRAM, inputs, tmp_path_factory,
                                CASES, USERS, axis="world")


def _jax_carry(fam):
    import jax.numpy as jnp

    from streambench_tpu.ops import salsa as jsalsa

    sk = (tuple(jsalsa.init_state(depth=D, width=WD)) if fam == "salsa"
          else (jnp.zeros((D, WD), jnp.int32), jnp.int32(0)))
    return (jnp.full((U,), -1, jnp.int32), jnp.zeros((U,), jnp.int32),
            jnp.zeros((U,), jnp.int32), jnp.int32(0), jnp.int32(0), *sk,
            jnp.full((M,), -1, jnp.int32), jnp.full((M,), -1, jnp.int32),
            jnp.int32(0), jnp.int32(0), jnp.zeros((LAT_BINS,), jnp.int32))


def _names(n: int) -> list:
    return (["lt", "ss", "ck", "wm", "dr"] + [f"sk{i}" for i in range(n - 10)]
            + ["tkk", "tke", "cn", "cl", "hist"])


def _jax_case(shape, case, inp) -> dict:
    """The JAX package's result of ``case`` on a ``shape`` mesh."""
    import jax.numpy as jnp

    d, c = shape
    mesh = jax_build_mesh(data=d, campaign=c, devices=jax.devices()[:d * c])
    fam = case.rsplit("_", 1)[1]
    sp = fam == "salsa"
    cols = [inp[k] for k in ("user", "et", "tm", "va")]
    now = jnp.int32(NOW)
    carry = _jax_carry(fam)
    if case.startswith(("step", "flush")):
        fn = (jsk._build_session_step_salsa if sp
              else jsk._build_session_step)(mesh, GAP, LATE, U)
        for k in range(NB):
            carry = fn(*carry, now, *(x[k] for x in cols))
        if case.startswith("flush"):
            flush = (jsk._build_session_flush_salsa if sp
                     else jsk._build_session_flush)
            carry = flush(mesh, GAP, LATE, False)(*carry,
                                                  jnp.int32(NOW + 60_000))
            carry = flush(mesh, GAP, LATE, True)(*carry, now)
    else:
        hoist = "hoisted" in case
        fn = (jsk._build_session_scan_salsa(mesh, GAP, LATE, U) if sp
              else jsk._build_session_scan(mesh, GAP, LATE, U, hoist))
        for lo in range(0, NB, 3):
            carry = fn(*carry, now, *(x[lo:lo + 3] for x in cols))
    return {n: np.asarray(x) for n, x in zip(_names(len(carry)), carry)}


def _unsharded(case, inp) -> dict:
    """The port's single-device fold: ``session.step``, then for each
    closed set the sketch's update, ``cms.update_topk``, the counters and
    the batch's latency bin; the flush case drains then closes."""
    fam = case.rsplit("_", 1)[1]
    st = session.init_state(U)
    sk = (salsa.init_state(depth=D, width=WD) if fam == "salsa"
          else cms.init_state(depth=D, width=WD))
    tk = cms.init_topk(M)
    hist = torch.zeros(LAT_BINS, dtype=torch.int32)
    cn = cl = 0
    cols = [torch.from_numpy(inp[k]) for k in ("user", "et", "tm", "va")]

    def absorb(sk, tk, closed):
        sk = cms.sk_update(sk, closed.user, closed.clicks, closed.valid)
        tk = cms.update_topk(sk, tk, closed.user, closed.valid)
        return sk, tk, int(closed.valid.sum()), int(
            torch.where(closed.valid, closed.clicks, 0).sum())

    for k in range(NB):
        u, e, t, v = (c[k] for c in cols)
        st, c_in, c_carry = session.step(st, u, e, t, v, gap_ms=GAP,
                                         lateness_ms=LATE)
        det = sketches._det_lat(NOW, t, v)
        for closed in (c_in, c_carry):
            sk, tk, n, c = absorb(sk, tk, closed)
            cn, cl = cn + n, cl + c
            hist = sketches._hist_scalar(hist, det, closed.valid)
    if case.startswith("flush"):
        st, expired = session.flush(st, gap_ms=GAP, lateness_ms=LATE)
        sk, tk, n, c = absorb(sk, tk, expired)
        cn, cl = cn + n, cl + c
        hist = _hist_rows(hist, torch.clamp(
            (NOW + 60_000) - (expired.end + GAP + LATE), min=0),
            expired.valid)
        st, final = session.flush(st, gap_ms=GAP, lateness_ms=LATE,
                                  force=True)
        sk, tk, n, c = absorb(sk, tk, final)
        cn, cl = cn + n, cl + c
    out = (*st, *sk, *tk, torch.tensor(cn, dtype=torch.int32),
           torch.tensor(cl, dtype=torch.int32), hist)
    return {n: np.asarray(x) for n, x in zip(_names(len(out)), out)}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_sharded_session_fold_bit_identical_to_jax_and_unsharded(
        port_results, inputs, shape, case):
    got = port_results(shape)[0][case]
    want = _jax_case(shape, case, inputs)
    flat = _unsharded(case, inputs)
    assert set(got) == set(want) == set(flat)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
        assert np.array_equal(got[key], flat[key]), key
    assert int(got["cn"]) > 0 and int(got["dr"]) > 0
    assert (got["tkk"] >= 0).sum() > 0 and got["hist"].sum() > 0
    if not case.startswith("flush"):
        # every closure of a batch lands in that batch's latency bin
        assert got["hist"].sum() == got["cn"]


def test_collective_report_against_the_hand_counts(port_results):
    """At (2, 2): the fixed step issues, per closed set, the delta and
    total sums, five gathers of the closed rows and the two counter sums
    (18 a batch); the hoisted scan 4 a dispatch (the delta stack, the
    counters, the users and the valid mask), none in its loop, against
    the per-batch arm's K * 18.  SALSA: 6 gathers a batch, 3 a hoisted
    dispatch.  And a capacity the mesh does not divide is refused."""
    outdir = port_results((2, 2))[1]
    with open(os.path.join(outdir, "reports.json")) as f:
        reps = json.load(f)
    assert "not divisible by mesh size 4" in reps["refused"]
    fixed, sal = reps["fixed"], reps["salsa"]
    assert fixed["step"]["per_dispatch"]["by_kind"] == {"all-reduce": 8,
                                                        "all-gather": 10}
    assert fixed["scan"]["per_dispatch"]["by_kind"] == {"all-gather": 2,
                                                        "all-reduce": 2}
    assert sal["step"]["per_dispatch"]["by_kind"] == {"all-gather": 6}
    assert sal["scan"]["per_dispatch"]["by_kind"] == {"all-gather": 3}
    for rep in (fixed, sal):
        assert rep["scan"]["per_loop_iteration"]["ops"] == 0
    # the scan's [K, 2, D, Wd] delta stack (the engine's [4, 2048] plane)
    assert fixed["scan"]["per_dispatch"]["bytes"] >= 3 * 2 * 4 * 2048 * 4
    for fam, per_batch in (("fixed", 18), ("salsa", 6)):
        with open(os.path.join(outdir, f"perbatch_{fam}.json")) as f:
            rep = json.load(f)
        assert rep["per_dispatch"]["ops"] == 3 * per_batch
        assert rep["per_loop_iteration"]["ops"] == per_batch


def test_two_stage_is_refused():
    from streambench_tpu_torch.parallel import (
        ShardedSessionCMSEngine,
        build_mesh,
    )

    try:
        mesh = build_mesh(1, 1, device="cpu")
        with pytest.raises(ValueError, match="stages=2"):
            ShardedSessionCMSEngine(default_config(jax_cms_stages=2),
                                    {"a": "c"}, mesh, campaigns=["c"],
                                    user_capacity=1 << 10, device="cpu")
    finally:
        torch.distributed.destroy_process_group()


# ----------------------------------------------------------------------
# the engine end to end

def _session_journal(wd: str) -> list:
    cfg = default_config(jax_batch_size=256)
    gen.do_setup(None, cfg, broker=FileBroker(os.path.join(wd, "broker")),
                 events_num=8_000, rng=random.Random(6), workdir=wd)
    return gen.load_ids(wd)[0]


def _exact_clicks(wd: str) -> int:
    with open(os.path.join(wd, gen.KAFKA_JSON_FILE)) as f:
        return sum(1 for line in f if '"event_type": "click"' in line)


@pytest.mark.parametrize("mode", ["fixed", "salsa"])
def test_engine_end_to_end_at_2x2_against_jax_and_unsharded(
        tmp_path, monkeypatch, mode):
    wd = str(tmp_path)
    campaigns = _session_journal(wd)
    mapping = gen.load_ad_mapping_file(os.path.join(wd,
                                                    gen.AD_TO_CAMPAIGN_FILE))
    monkeypatch.setattr(sketches, "now_ms", lambda: CLOCK_MS)
    cap, gap = 1 << 10, 5_000
    cfg = default_config(jax_batch_size=256)
    broker = FileBroker(os.path.join(wd, "broker"))

    def flat_engine():
        return sketches.SessionCMSEngine(
            cfg, mapping, campaigns=campaigns, device="cpu",
            user_capacity=cap, gap_ms=gap, cms_mode=mode)

    # the unsharded engine over the whole journal, and its snapshot half
    # way for run B
    ref = flat_engine()
    StreamRunner(ref, broker.reader(cfg.kafka_topic),
                 flush_interval_ms=10**9).run_catchup()
    want_state = [t.tolist() for t in ref.state[:3]]
    ref.close()
    ckpt = str(tmp_path / "ckpt")
    half = flat_engine()
    StreamRunner(half, broker.reader(cfg.kafka_topic),
                 checkpointer=Checkpointer(ckpt),
                 flush_interval_ms=10**9).run_catchup(max_events=4_000)

    jcfg = jax_default_config(jax_batch_size=256, jax_cms_mode=mode)
    jeng = JaxSess(jcfg, mapping, jax_build_mesh(
        data=2, campaign=2, devices=jax.devices()[:4]), campaigns=campaigns,
        redis=jax_as_redis(JaxStore()), user_capacity=cap, gap_ms=gap)
    JaxRunner(jeng, JaxBroker(os.path.join(wd, "broker")).reader(
        jcfg.kafka_topic)).run_catchup()
    jeng.close()

    with open(os.path.join(wd, "spec.json"), "w") as f:
        json.dump({"workdir": wd, "batch": 256, "capacity": cap, "gap": gap,
                   "mode": mode, "checkpoint_dir": ckpt,
                   "clock": CLOCK_MS}, f)
    outs = spawn(RANK_PROGRAM, "engine", wd, (2, 2))
    stats = json.loads(outs[0].strip().splitlines()[-1])
    for run in ("A", "B"):
        s = stats[run]
        assert s["events"] == 8_000 and s["dropped"] == ref.dropped, run
        assert s["state"] == want_state, run
        assert s["sketch"] == [np.asarray(t).tolist() for t in ref.cms], run
        assert s["ring"] == [t.tolist() for t in ref.topk], run
        assert s["hist"] == ref.lat_hist.tolist(), run
        assert (s["closed"], s["clicks"]) == (ref.sessions_closed,
                                             ref.session_clicks), run
        assert s["clicks"] == _exact_clicks(wd) > 0
        assert [tuple(x) for x in s["hh"]] == ref.heavy_hitters()
        assert sorted(map(tuple, s["hh"])) == sorted(jeng.heavy_hitters())
    assert stats["B"]["resumed"] and 0 < stats["B"]["run_events"] < 8_000

    # the sharded engine's last snapshot (the catchup's end, before
    # close) restores into the unsharded engine: the unsharded run's
    # state there, and closing it gives the same heavy hitters
    back = flat_engine()
    back.restore(Checkpointer(ckpt).load())
    assert back.events_processed == 8_000
    assert [t.tolist() for t in back.state[:3]] == want_state
    back.close()
    assert back.heavy_hitters() == ref.heavy_hitters()


def test_cli_sharded_session_on_cpu_matches_the_jax_cli(tmp_path):
    lines, got, want, servers = cli_against_jax(tmp_path, "session")
    try:
        assert any("engine up:" in ln and "engine=session" in ln
                   and "mesh=1x1 backend=gloo" in ln for ln in lines)
        stats = json.loads(lines[-1])
        assert stats["events"] == 8_000 and stats["dropped"] == 0
        assert stats["windows_written"] == 0
        hh = got.hgetall("t1_hh")
        assert hh and hh == want.hgetall("t1_hh")
    finally:
        for s in servers:
            s.kill()
            s.communicate()
