"""The port's sharded sliding + t-digest fold and engine against the JAX
package's, on the CPU.

The same numpy inputs (``tests/test_sharded_sketches.py``'s sliding
cases: C = 96 campaigns, W = 128 slots, B = 64 rows, K = 3 batches,
16 centroids, a fixed ``now_rel``) go through JAX's
``_build_sliding_step`` / ``_build_sliding_scan`` on the virtual 8-device
CPU mesh and through the port's ``sliding_fold_step`` /
``sliding_fold_scan`` on gloo ranks: (1, 1) in this process, (4, 1),
(2, 2) and (1, 4) as four spawned ranks.  Sliced (K1 on each shard's
``[Cl*S, W]`` view) and unsliced, per-batch and hoisted, unpacked and
packed (JAX has no sharded packed sliding program: the packed arms are
held against its unpacked result on the same rows).

Tolerances, the reference's own (``tests/test_sharded_sketches.py:444``):
the counts, ring, watermark, ``dropped`` and digest weights (sums of unit
floats) exact; the digest means within ``rtol=1e-5, atol=1e-3``, the
float-add reordering inside a centroid that a shard-local fold may bring.
The same against the port's unsharded fold.

Then the engine end to end at (2, 2) under one injected host clock:
window rows equal to JAX's sharded engine's and to the sliding golden
(each view in its 10 windows), quantiles within one histogram bin of
JAX's, run B resumed from the unsharded engine's snapshot and its last
snapshot restored into the unsharded engine.
"""

import json
import os
import random

import jax
import numpy as np
import pytest
import torch

import streambench_tpu.engine.sketches as jax_sketches
from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu.parallel import ShardedSlidingTDigestEngine as JaxSl
from streambench_tpu.parallel import build_mesh as jax_build_mesh
from streambench_tpu.parallel import sketches as jsk
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import StreamRunner, sketches
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    read_seen_counts,
    seed_campaigns,
)
from streambench_tpu_torch.io.resp import RespClient
from streambench_tpu_torch.ops import sliding, tdigest
from streambench_tpu_torch.ops import windowcount as wc
from tests.test_torch_sharded import _resp_server, free_port
from tests.test_torch_sharded_hll import (
    RANK_MAIN,
    cli_against_jax,
    port_results_fixture,
    rand_batches,
    spawn,
)

torch.set_num_threads(1)

C, W, B, K, TD, S = 96, 128, 64, 3, 16, 10
NOW = 400_000
MESHES = [(1, 1), (4, 1), (2, 2), (1, 4)]
CASES = [f"{arm}_{form}" for form in ("sliced", "unsliced")
         for arm in ("step", "scan_hoisted", "scan_perbatch",
                     "scan_packed_hoisted")]
CLOCK_MS = 1_700_000_400_000
MEANS_TOL = dict(rtol=1e-5, atol=1e-3)

RANK_PROGRAM = r'''
import json, os, sys
import numpy as np
import torch

def run_cases(mesh, inp, outdir):
    from streambench_tpu_torch.ops import sliding, tdigest
    from streambench_tpu_torch.ops import windowcount as wc
    from streambench_tpu_torch.parallel import sharded as S
    from streambench_tpu_torch.parallel import sketches as SK
    jt = torch.from_numpy(inp["join"])
    C, W, TD, NOW = (int(inp[k]) for k in ("C", "W", "TD", "NOW"))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    axes = S.mesh_axes(mesh, C)
    cl = C // mesh.shape["campaign"]
    cols = [inp[k] for k in ("ad", "et", "tm", "va")]
    words = np.stack([wc.pack_columns(a, e, v) for a, e, v in
                      zip(inp["ad"], inp["et"], inp["va"])])
    packed = [words, inp["tm"]]
    K = cols[0].shape[0]
    local = lambda xs: [S.data_slice(mesh, T(x)) for x in xs]
    kw = dict(size_ms=10_000, slide_ms=1_000, lateness_ms=60_000)

    def save(case, out):
        names = ("counts", "ids", "wm", "dropped", "means", "weights")
        np.savez(os.path.join(outdir, f"{case}_r{mesh.rank}.npz"),
                 **{n: np.asarray(x) for n, x in zip(names, out)})

    for form in ("sliced", "unsliced"):
        sliced = form == "sliced"

        def init():
            st = (sliding.init_sliced(cl, W, 10) if sliced
                  else wc.init_state(cl, W))
            dg = tdigest.init_state(cl, compression=TD)
            return st, dg.means, dg.weights

        st, means, weights = init()
        for k in range(K):
            out = SK.sliding_fold_step(st, means, weights, jt, NOW,
                                       local([x[k] for x in cols]), axes,
                                       packed=False, sliced=sliced, **kw)
            st, means, weights = type(st)(*out[:4]), out[4], out[5]
        save(f"step_{form}", out)
        for name, xs, pk, hoist in (
                ("scan_hoisted", cols, False, True),
                ("scan_perbatch", cols, False, False),
                ("scan_packed_hoisted", packed, True, True)):
            save(f"{name}_{form}", SK.sliding_fold_scan(
                *init(), jt, NOW, local(xs), axes, packed=pk,
                sliced=sliced, hoist=hoist, **kw))
    if mesh.size == 4 and mesh.shape["data"] == 2:
        from streambench_tpu_torch.config import default_config
        from streambench_tpu_torch.parallel import (
            ShardedSlidingTDigestEngine,
        )
        mapping = {f"ad{i}": f"c{i % 7}" for i in range(40)}
        reps = {}
        for sliced in ("on", "off"):
            eng = ShardedSlidingTDigestEngine(
                default_config(jax_batch_size=64, jax_window_slots=128),
                mapping, mesh, device="cpu", sliced=sliced)
            eng._pack_ok = False
            if mesh.rank != 0:
                eng.follow()
                continue
            reps[sliced] = eng.collective_report(k=4)
            eng.close()
        if mesh.rank == 0:
            with open(os.path.join(outdir, "reports.json"), "w") as f:
                json.dump(reps, f)

def run_engine(mesh, spec):
    """Run A fresh, run B resumed from the unsharded engine's snapshot
    (module doc), under the injected clock."""
    from streambench_tpu_torch.checkpoint import Checkpointer
    from streambench_tpu_torch.config import default_config
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.engine import StreamRunner, sketches
    from streambench_tpu_torch.io.journal import FileBroker
    from streambench_tpu_torch.io.resp import RespClient
    from streambench_tpu_torch.parallel import ShardedSlidingTDigestEngine

    sketches.now_ms = lambda: spec["clock"]
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
        eng = ShardedSlidingTDigestEngine(cfg, mapping, mesh,
                                          campaigns=campaigns, redis=redis,
                                          device="cpu", sliced=spec["sliced"])
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
        q = eng.quantiles()
        weights = eng._whole()[1].weights.sum(1)
        eng.close()
        out[run] = {"events": eng.events_processed, "dropped": eng.dropped,
                    "resumed": resumed, "run_events": st.events,
                    "sliced": eng.sliced, "quantiles": q.tolist(),
                    "weights": weights.tolist()}
    if mesh.rank == 0:
        print(json.dumps(out), flush=True)
''' + RANK_MAIN


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(17)
    n_ads = C * 3
    join = np.concatenate([rng.integers(0, C, n_ads), [-1]]).astype(np.int32)
    bs = rand_batches(rng, K, B, n_ads + 1, 500, span_ms=60_000)
    # a late tail: the last batch's first rows behind the lateness bound
    bs[-1][3][:8] = 1_000
    bs[-1][2][:8] = 0
    bs[-1][4][:8] = True
    return {"join": join, "C": C, "W": W, "TD": TD, "NOW": NOW,
            **{k: np.stack([b[i] for b in bs])
               for i, k in zip((0, 2, 3, 4), ("ad", "et", "tm", "va"))}}


@pytest.fixture(scope="module")
def port_results(inputs, tmp_path_factory):
    return port_results_fixture(RANK_PROGRAM, inputs, tmp_path_factory,
                                CASES, ("counts", "means", "weights"))


def _jax_case(shape, case, inp) -> dict:
    """The JAX package's result of ``case`` on a ``shape`` mesh."""
    import jax.numpy as jnp

    d, c = shape
    mesh = jax_build_mesh(data=d, campaign=c, devices=jax.devices()[:d * c])
    sliced = case.endswith("_sliced")
    jt = jnp.asarray(inp["join"])
    cols = [jnp.asarray(inp[k]) for k in ("ad", "et", "tm", "va")]
    counts = (jnp.zeros((C, S, W), jnp.int32) if sliced
              else jnp.zeros((C, W), jnp.int32))
    carry = (counts, jnp.full((W,), -1, jnp.int32), jnp.int32(0),
             jnp.int32(0), jnp.zeros((C, TD), jnp.float32),
             jnp.zeros((C, TD), jnp.float32))
    now = jnp.int32(NOW)
    if case.startswith("step"):
        fn = jsk._build_sliding_step(mesh, 10_000, 1_000, 60_000, 0, sliced)
        for k in range(K):
            carry = fn(*carry, jt, now, *(x[k] for x in cols))
    else:
        hoist = "perbatch" not in case
        fn = jsk._build_sliding_scan(mesh, 10_000, 1_000, 60_000, 0, hoist,
                                     sliced)
        carry = fn(*carry, jt, now, *cols)
    names = ("counts", "ids", "wm", "dropped", "means", "weights")
    return {n: np.asarray(x) for n, x in zip(names, carry)}


def _unsharded(case, inp) -> dict:
    """The port's single-device fold over the case's batches: the step
    arms ``sliding.step[_sliced]`` + ``tdigest.update``, the scan arms
    the single-device engine's scan program."""
    sliced = case.endswith("_sliced")
    jt = torch.from_numpy(inp["join"])
    cols = [torch.from_numpy(inp[k]) for k in ("ad", "et", "tm", "va")]
    st = sliding.init_sliced(C, W, S) if sliced else wc.init_state(C, W)
    dg = tdigest.init_state(C, compression=TD)
    kw = dict(size_ms=10_000, slide_ms=1_000, lateness_ms=60_000)
    if case.startswith("step"):
        for k in range(K):
            st, dg = sketches._sliding_tdigest_step(
                st, dg, jt, NOW, *(x[k] for x in cols), sliced=sliced, **kw)
    else:
        fn = (sketches._sliding_tdigest_scan_sliced if sliced
              else sketches._sliding_tdigest_scan)
        st, dg = fn(st, dg, jt, NOW, *cols, **kw)
    return {"counts": st.counts.numpy(), "ids": st.window_ids.numpy(),
            "wm": np.asarray(int(st.watermark)),
            "dropped": np.asarray(int(st.dropped)),
            "means": dg.means.numpy(), "weights": dg.weights.numpy()}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_sharded_sliding_fold_against_jax_and_unsharded(
        port_results, inputs, shape, case):
    got = port_results(shape)[0][case]
    for want in (_jax_case(shape, case, inputs), _unsharded(case, inputs)):
        for key in ("counts", "ids", "wm", "dropped", "weights"):
            assert np.array_equal(got[key], want[key]), key
        np.testing.assert_allclose(got["means"], want["means"], **MEANS_TOL)
    assert got["counts"].sum() > 0 and got["weights"].sum() > 0
    assert int(got["dropped"]) > 0     # the late tail lost memberships


def test_collective_report_against_the_hand_counts(port_results):
    """At (2, 2): ONE scalar sum for all S memberships a batch beside the
    four gathered columns; the hoisted scan the same a dispatch, nothing
    inside its loop; the same for both folds."""
    outdir = port_results((2, 2))[1]
    with open(os.path.join(outdir, "reports.json")) as f:
        reps = json.load(f)
    for sliced in ("on", "off"):
        rep = reps[sliced]
        for kernel in ("step", "scan"):
            assert rep[kernel]["per_dispatch"]["by_kind"] == {
                "all-gather": 4, "all-reduce": 1}
            assert rep[kernel]["per_loop_iteration"]["ops"] == 0
        assert rep["scan"]["per_dispatch"]["bytes"] == 4 * 4 * 64 * 4 + 4


def _golden_sliding(wd: str) -> dict:
    """Each view counted in the 10 sliding windows covering it."""
    mapping = gen.load_ad_mapping_file(os.path.join(wd,
                                                    gen.AD_TO_CAMPAIGN_FILE))
    out: dict = {}
    with open(os.path.join(wd, gen.KAFKA_JSON_FILE)) as f:
        for line in f:
            e = json.loads(line)
            if e["event_type"] != "view":
                continue
            t = int(e["event_time"])
            for k in range(S):
                key = (mapping[e["ad_id"]], (t // 1000 - k) * 1000)
                out[key] = out.get(key, 0) + 1
    return out


def _rows(seen: dict) -> dict:
    return {(c, w): n for c in seen for w, n in seen[c].items()}


@pytest.mark.parametrize("sliced", ["on", "off"])
def test_engine_end_to_end_at_2x2_against_jax_and_the_golden(
        tmp_path, monkeypatch, sliced):
    wd = str(tmp_path)
    cfg = default_config(jax_batch_size=512, jax_window_slots=128)
    broker = FileBroker(os.path.join(wd, "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=8_000,
                 rng=random.Random(9), workdir=wd)
    mapping = gen.load_ad_mapping_file(os.path.join(wd,
                                                    gen.AD_TO_CAMPAIGN_FILE))
    campaigns, _ = gen.load_ids(wd)
    monkeypatch.setattr(jax_sketches, "now_ms", lambda: CLOCK_MS)
    monkeypatch.setattr(sketches, "now_ms", lambda: CLOCK_MS)

    jcfg = jax_default_config(jax_batch_size=512, jax_window_slots=128)
    jr = jax_as_redis(JaxStore())
    jax_seed(jr, campaigns)
    jeng = JaxSl(jcfg, mapping, jax_build_mesh(
        data=2, campaign=2, devices=jax.devices()[:4]), campaigns=campaigns,
        redis=jr, sliced=sliced)
    JaxRunner(jeng, JaxBroker(os.path.join(wd, "broker")).reader(
        jcfg.kafka_topic)).run_catchup()
    jq = jeng.quantiles()
    jeng.close()
    want = _rows(jax_seen(jr))
    assert want == _golden_sliding(wd)

    ports = {"A": free_port(), "B": free_port()}
    servers = [_resp_server(p) for p in ports.values()]
    ckpt = str(tmp_path / "ckpt")
    try:
        clients = {k: RespClient("127.0.0.1", p) for k, p in ports.items()}
        for r in clients.values():
            seed_campaigns(r, campaigns)
        flat = sketches.SlidingTDigestEngine(
            cfg, mapping, campaigns=campaigns, redis=clients["B"],
            device="cpu", sliced=sliced)
        StreamRunner(flat, broker.reader(cfg.kafka_topic),
                     checkpointer=Checkpointer(ckpt)).run_catchup(
                         max_events=3_000)
        flat.drain_writes()
        with open(os.path.join(wd, "spec.json"), "w") as f:
            json.dump({"workdir": wd, "ports": ports, "batch": 512,
                       "slots": 128, "checkpoint_dir": ckpt,
                       "clock": CLOCK_MS, "sliced": sliced}, f)
        outs = spawn(RANK_PROGRAM, "engine", wd, (2, 2))
        stats = json.loads(outs[0].strip().splitlines()[-1])
        for run, r in clients.items():
            s = stats[run]
            assert s["events"] == 8_000 and s["dropped"] == 0, run
            assert s["sliced"] == (sliced == "on")
            assert _rows(read_seen_counts(r)) == want, run
            q = np.asarray(s["quantiles"])
            assert q.shape == jq.shape
            err = np.abs(q - jq) / np.maximum(np.abs(jq), 1e-3)
            assert err.max() <= 2.0 ** -5, run
        assert stats["B"]["resumed"] and 0 < stats["B"]["run_events"] < 8_000
        # every view sampled once, in its campaign's digest
        assert sum(stats["A"]["weights"]) == sum(
            1 for _ in open(os.path.join(wd, gen.KAFKA_JSON_FILE))
            if '"view"' in _)
    finally:
        for s in servers:
            s.kill()
            s.communicate()

    snap = Checkpointer(ckpt).load()
    back = sketches.SlidingTDigestEngine(cfg, mapping, campaigns=campaigns,
                                         device="cpu", sliced=sliced)
    back.restore(snap)
    assert back.digest.means.shape[0] == len(campaigns)
    assert float(back.digest.weights.sum()) == sum(stats["B"]["weights"])


def test_cli_sharded_sliding_on_cpu_matches_the_jax_cli(tmp_path):
    lines, got, want, servers = cli_against_jax(tmp_path, "sliding")
    try:
        assert any("engine up:" in ln and "engine=sliding" in ln
                   and "mesh=1x1 backend=gloo" in ln for ln in lines)
        stats = json.loads(lines[-1])
        assert stats["events"] == 8_000 and stats["dropped"] == 0
        g, w = _rows(read_seen_counts(got)), _rows(read_seen_counts(want))
        assert g == w and g
        # the quantile table at close: 3 fields a campaign, no padding
        assert len(got.hgetall("t1_quantiles")) == len(
            want.hgetall("t1_quantiles")) > 0
    finally:
        for s in servers:
            s.kill()
            s.communicate()
