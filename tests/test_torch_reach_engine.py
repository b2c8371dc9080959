"""The port's reach engine (``ReachSketchEngine``, ``--engine reach``)
against the JAX package's, end to end on the CPU.

One generated journal (a universe of 3,000 devices) goes through
``streambench_tpu``'s ``ReachSketchEngine`` + ``StreamRunner`` and through
the port's on ``device="cpu"``: the signature and register planes must be
bit-identical, and equal to the oracle's planes over the journal's exact
id sets; the ``<hashtable>_reach`` rows (rounded float32 estimates) within
1 of each other.  Also: snapshots restored across the two packages both
ways with the epoch bumped past both lineages, the delta shipper's
dirty-row records folding to the engine's planes, the engine CLI with a
ship directory tailed by an in-process replica, ``ENGINE=reach`` under
``TORCH_TEST``, and the constructor's device rule.
"""

import json
import os
import random
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streambench_tpu.engine.sketches as jax_sketches
from streambench_tpu.checkpoint import Checkpointer as JaxCheckpointer
from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.fakeredis import make_store as jax_make_store
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.reach import query as jax_rq
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.dimensions.pubsub import PubSubClient
from streambench_tpu_torch.dimensions.store import DurableDimensionStore
from streambench_tpu_torch.engine import StreamRunner
from streambench_tpu_torch.engine import sketches
from streambench_tpu_torch.io.fakeredis import make_store
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import as_redis
from streambench_tpu_torch.ops import minhash
from streambench_tpu_torch.reach import oracle as ro
from streambench_tpu_torch.reach.deltaship import ChainTailer, DeltaShipper
from streambench_tpu_torch.reach.replica import ReachReplica
from streambench_tpu_torch.utils.ids import make_ids
from tests.test_torch_engine import REPO, TOPIC
from tests.test_torch_harness import free_port, run_harness

torch.set_num_threads(1)

K, R = 64, 256
TABLE = "reach_test"


def reach_journal(workdir, n, spacing_ms, seed, users=3_000):
    """Ids, ad->campaign map, the broker topic and ``kafka-json.txt``
    for ``n`` generator events over ``users`` devices (the stock setup
    pins 100)."""
    rng = random.Random(seed)
    campaigns = make_ids(20, rng)
    ads = make_ids(200, rng)
    gen.write_ids(campaigns, ads, workdir)
    gen.write_ad_mapping_file(campaigns, ads, workdir)
    src = gen.EventSource(ads=ads, user_ids=make_ids(users, rng),
                          page_ids=make_ids(10, rng), rng=rng)
    blob = "".join(src.event_at(1_700_000_000_000 + spacing_ms * i) + "\n"
                   for i in range(n)).encode()
    with open(os.path.join(workdir, gen.KAFKA_JSON_FILE), "wb") as f:
        f.write(blob)
    with FileBroker(os.path.join(workdir, "broker")).writer(
            TOPIC, append=False) as w:
        w.append_bytes(blob)
    return campaigns


@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("reach"))
    campaigns = reach_journal(wd, 12_000, 2, seed=41)
    mapping = gen.load_ad_mapping_file(
        os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE))
    return wd, campaigns, mapping


def make(side, wd, campaigns, mapping, redis=None, **cfg_kw):
    cfg_kw = {"kafka_topic": TOPIC, "redis_hashtable": TABLE, **cfg_kw}
    if side == "jax":
        return jax_sketches.ReachSketchEngine(
            jax_default_config(**cfg_kw), mapping, campaigns=campaigns,
            redis=redis, k=K, registers=R)
    return sketches.ReachSketchEngine(
        default_config(**cfg_kw), mapping, campaigns=campaigns,
        redis=redis, k=K, registers=R, device="cpu")


def parts(side, wd):
    jax = side == "jax"
    r = jax_as_redis(jax_make_store()) if jax else as_redis(make_store())
    broker = (JaxBroker if jax else FileBroker)(os.path.join(wd, "broker"))
    return (r, broker, JaxCheckpointer if jax else Checkpointer,
            JaxRunner if jax else StreamRunner)


def run_side(side, wd, campaigns, mapping, runner_kw=None, **cfg_kw):
    r, broker, _, runner_cls = parts(side, wd)
    eng = make(side, wd, campaigns, mapping, redis=r, **cfg_kw)
    stats = runner_cls(eng, broker.reader(TOPIC),
                       **(runner_kw or {})).run_catchup()
    eng.close()
    return eng, stats, r


def numpy_planes(eng):
    if isinstance(eng, sketches.ReachSketchEngine):
        p = eng.planes()
        return p["mins"], p["registers"]
    return np.asarray(eng.state.mins), np.asarray(eng.state.registers)


def reach_rows(r):
    return {k: int(v) for k, v in r.hgetall(f"{TABLE}_reach").items()}


def oracle_planes(wd, campaigns, mapping):
    with open(os.path.join(wd, gen.KAFKA_JSON_FILE), "rb") as f:
        sets = ro.campaign_user_sets(f, mapping, campaigns)
    return ro.expected_state(sets, campaigns, K, R)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("cfg_kw", [
    {"jax_batch_size": 512},
    {"jax_batch_size": 512, "jax_scan_batches": 1},
    {"jax_batch_size": 1024, "jax_ingest_pipeline": "on"}],
    ids=["packed_scan", "per_batch", "pipelined"])
def test_catchup_planes_equal_jax_and_the_oracle(journal, cfg_kw):
    wd, campaigns, mapping = journal
    port, pst, pr = run_side("port", wd, campaigns, mapping, **cfg_kw)
    ref, jst, jr = run_side("jax", wd, campaigns, mapping, **cfg_kw)
    assert pst.events == jst.events == 12_000
    pm, preg = numpy_planes(port)
    jm, jreg = numpy_planes(ref)
    assert pm.dtype == np.uint32 and preg.dtype == np.int32
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(preg, jreg)
    em, er = oracle_planes(wd, campaigns, mapping)
    np.testing.assert_array_equal(pm, em)
    np.testing.assert_array_equal(preg, er)
    assert int(port.state.watermark) == int(ref.state.watermark)
    assert port.dropped == ref.dropped == 0
    assert pst.windows_written == jst.windows_written == 0
    got, want = reach_rows(pr), reach_rows(jr)
    assert set(got) == set(want) and len(got) == len(campaigns)
    assert all(abs(got[k] - want[k]) <= 1 for k in want)
    # the rows are the rounded estimates of the planes
    est = port.estimates()
    for name, e in zip(port.encoder.campaigns, est):
        assert got[name] == int(round(float(e)))


@pytest.mark.parametrize("first,second", [("jax", "port"),
                                          ("port", "jax")],
                         ids=["jax_to_port", "port_to_jax"])
def test_snapshots_restore_across_packages_with_the_epoch_bumped(
        journal, tmp_path, first, second):
    """A snapshot one package wrote halfway finishes in the other: the
    planes equal an uninterrupted run's, and the restored engine's epoch
    is strictly above the snapshot's."""
    wd, campaigns, mapping = journal
    full, _, _ = run_side("port", wd, campaigns, mapping,
                          jax_batch_size=512)
    want = numpy_planes(full)
    ckdir = str(tmp_path / f"ck_{first}")
    r1, broker1, ck1, run1 = parts(first, wd)
    a = make(first, wd, campaigns, mapping, redis=r1,
             jax_batch_size=512)
    a.reach_epoch = 3                  # a lineage already restored
    run1(a, broker1.reader(TOPIC), checkpointer=ck1(ckdir),
         checkpoint_interval_ms=0).run_catchup(max_events=6_000)
    r2, broker2, ck2, run2 = parts(second, wd)
    b = make(second, wd, campaigns, mapping, redis=r2,
             jax_batch_size=512)
    runner = run2(b, broker2.reader(TOPIC), checkpointer=ck2(ckdir),
                  checkpoint_interval_ms=0)
    assert runner.resume()
    assert b.events_processed == a.events_processed
    assert b.reach_epoch == 4
    runner.run_catchup()
    b.close()
    got = numpy_planes(b)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_restore_refuses_other_geometry_and_family(journal):
    wd, campaigns, mapping = journal
    eng = make("port", wd, campaigns, mapping)
    snap = eng.snapshot(offset=0)
    assert snap.extra["mh_mins"].dtype == np.uint32
    assert snap.extra["hll_plane"].dtype == np.int32
    other = sketches.ReachSketchEngine(
        default_config(), mapping, campaigns=campaigns, k=K * 2,
        registers=R, device="cpu")
    with pytest.raises(ValueError, match="reach_k"):
        other.restore(snap)
    hll = sketches.HLLDistinctEngine(default_config(), mapping,
                                     campaigns=campaigns, device="cpu")
    with pytest.raises(ValueError, match="engine family"):
        hll.restore(snap)


def test_delta_shipper_records_fold_to_the_engines_planes(journal,
                                                          tmp_path):
    """The engine's host dirty mask (from the shipped host columns, the
    packed word included) names every row a fold touched: the chain of
    delta records folds to the engine's planes at every ship, as the
    JAX engine's does."""
    wd, campaigns, mapping = journal
    logs = {}
    for side in ("port", "jax"):
        from streambench_tpu.dimensions.store import (
            DurableDimensionStore as JaxStore,
        )
        from streambench_tpu.reach.deltaship import (
            DeltaShipper as JaxDeltaShipper,
        )

        d = str(tmp_path / side)
        store = (DurableDimensionStore if side == "port" else JaxStore)(d)
        ship_cls = DeltaShipper if side == "port" else JaxDeltaShipper
        r, broker, _, runner_cls = parts(side, wd)
        eng = make(side, wd, campaigns, mapping, redis=r,
                   jax_batch_size=256, jax_scan_batches=4)
        # a base every 1,000 ships, a cutover only past every row dirty
        ship = ship_cls(store, list(eng.encoder.campaigns), interval_ms=1,
                        base_every=1000, cutover_frac=1.01)
        eng.attach_shipper(ship)
        tail = ChainTailer(store.path)
        reader = broker.reader(TOPIC)
        views = 0
        while True:
            lines = reader.poll(1_000)
            if not lines:
                break
            eng.process_chunk(lines)
            time.sleep(0.002)
            eng.flush()
            view = tail.poll()
            if view is not None:
                views += 1
                m, rg = numpy_planes(eng)
                np.testing.assert_array_equal(view["mins"], m)
                np.testing.assert_array_equal(view["registers"], rg)
        assert views >= 10 and ship.deltas >= 10
        assert tail.stats()["gaps"] == 0
        logs[side] = numpy_planes(eng)
        eng.close()
        store.close()
    np.testing.assert_array_equal(logs["port"][0], logs["jax"][0])
    np.testing.assert_array_equal(logs["port"][1], logs["jax"][1])


def test_reach_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sketches.ReachSketchEngine(default_config(), {"ad": "camp"})
    eng = sketches.ReachSketchEngine(default_config(), {"ad": "camp"},
                                     device="cpu")
    assert eng.device.type == "cpu" and eng.state.mins.device.type == "cpu"
    assert eng.k == default_config().jax_reach_k


def test_warmup_leaves_the_planes_empty(journal):
    wd, campaigns, mapping = journal
    eng = make("port", wd, campaigns, mapping)
    eng.warmup()
    m, rg = numpy_planes(eng)
    assert (m == np.uint32(minhash.EMPTY)).all() and (rg == 0).all()
    assert eng.events_processed == 0


# ----------------------------------------------------------------------
def _conf(path, **keys):
    lines = ['redis.host: ":inprocess:"', f'kafka.topic: "{TOPIC}"',
             f'redis.hashtable: "{TABLE}"']
    lines += [f"{k}: {json.dumps(v)}" for k, v in keys.items()]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_cli_reach_with_a_ship_dir_and_a_replica(journal, tmp_path):
    """``--engine reach --device cpu --catchup`` with
    ``jax.reach.ship.dir`` and delta shipping: the stats line carries the
    serving and shipping blocks; a replica tailing the ship directory
    answers with ``agree`` equal to the oracle over the journal."""
    wd, campaigns, mapping = journal
    ship_dir = str(tmp_path / "ship")
    conf = _conf(tmp_path / "conf.yaml",
                 **{"jax.reach.ship.dir": ship_dir,
                    "jax.reach.ship.delta": "on", "jax.reach.k": K,
                    "jax.reach.slo.p99.ms": 1000})
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.engine",
         "--confPath", conf, "--workdir", wd, "--catchup",
         "--device", "cpu", "--engine", "reach"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert any(ln.startswith("reach: pubsub=") and f"k={K}" in ln
               and "/delta" in ln for ln in lines)
    assert any("engine up:" in ln and "engine=reach" in ln for ln in lines)
    stats = json.loads(lines[-1])
    assert stats["events"] == 12_000 and stats["windows_written"] == 0
    assert stats["reach"]["ship"]["mode"] == "delta"
    assert stats["slo"]["objectives"] == {"reach_p99_ms": 1000}
    assert stats["kernel_launches"]["count_cells"] == 0
    rep = ReachReplica(ship_dir + "/dimensions.log", poll_ms=20_000,
                       max_staleness_ms=10**9, device="cpu")
    rep.pubsub.start()
    try:
        assert rep.poll_once()
        names = list(rep.server.campaigns)
        assert sorted(names) == sorted(campaigns)
        em, er = oracle_planes(wd, names, mapping)
        rng = np.random.default_rng(5)
        c = PubSubClient(*rep.address, timeout_s=30)
        masks = np.zeros((16, len(names)), bool)
        for i in range(16):
            sel = rng.choice(len(names), size=int(rng.integers(1, 4)),
                             replace=False)
            masks[i, sel] = True
            c.request({"type": "reach", "op": "overlap", "id": i,
                       "campaigns": [names[j] for j in sel]})
        answers = {}
        for _ in range(16):
            d = c.recv()["data"]
            answers[d["id"]] = d
        c.close()
        agree = ro.query_oracle_np(em, er, masks)
        for i in range(16):
            assert answers[i]["jaccard"] == pytest.approx(
                round(agree[i] / K, 5), abs=1e-5)
        # the replica's planes are the oracle's
        np.testing.assert_array_equal(
            minhash.mins_numpy(rep.server._state[0]), em)
        want = np.asarray(jax_rq.batch_query(
            jnp.asarray(em), jnp.asarray(er), jnp.asarray(masks),
            jnp.ones(16, bool))[3])
        np.testing.assert_array_equal(agree, want)
    finally:
        rep.close()


def test_harness_torch_test_with_engine_reach_on_cpu(tmp_path):
    """``TORCH_TEST`` with ``ENGINE=reach``: no window rows, so the
    composite's evidence is the engine's final stats line."""
    wd = str(tmp_path / "run")
    env = {"WORKDIR": wd, "REDIS_PORT": str(free_port()), "LOAD": "400",
           "TEST_TIME": "6", "STOP_STATS_GRACE": "2", "TOPIC": "ad-events",
           "DEVICE": "cpu", "ENGINE": "reach"}
    try:
        proc = run_harness(["TORCH_TEST"], env, timeout=240)
    finally:
        run_harness(["STOP_ALL"], env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout + proc.stderr
    assert "TORCH_TEST evidence:" in out and '"events"' in out
    engine_log = open(os.path.join(wd, "logs", "engine.log")).read()
    assert "engine=reach" in engine_log and "reach: pubsub=" in engine_log
    stats = json.loads(engine_log.strip().splitlines()[-1])
    load_log = open(os.path.join(wd, "logs", "load.log")).read()
    emitted = int(load_log.split("emitted ")[-1].split()[0])
    assert stats["events"] == emitted > 0 and stats["dropped"] == 0
    assert "reach" in stats


def test_harness_still_refuses_sharded_reach(tmp_path):
    """Sharded reach runs (``tests/test_torch_sharded_reach.py``); the
    micro-batch mode has no form of it (count windows fold exact counts
    or HLL registers on one device), so SETUP refuses it by name."""
    env = {"WORKDIR": str(tmp_path / "run"), "DEVICE": "cpu",
           "ENGINE": "reach", "SHARDED": "1", "MICROBATCH": "1"}
    proc = run_harness(["SETUP"], env)
    assert proc.returncode != 0
    out = proc.stdout + proc.stderr
    assert ("MICROBATCH=1 has no count-window form of ENGINE=reach with "
            "SHARDED=1" in out)
    assert not os.path.exists(str(tmp_path / "run" / "localConf.yaml"))


# chip_smoke.py phase 19, rehearsed on the CPU at a small size
def test_chip_smoke_phase19_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 19 through the smoke's own code: the catchup, its resume and
    profile, the 512 queries, the storm and the shed rung, serving while
    folding a second journal (each answer held to the pushed states),
    and the engine CLI beside a replica process, shipping deltas for a
    tail over five campaigns, at 40,000 events over 10,000 devices (the
    second journal 20,000 over 5,000) on the CPU; the card runs the
    large rung."""
    import chip_smoke

    def workdir(name):
        path = tmp_path / name
        path.mkdir()
        return str(path)

    monkeypatch.setattr(chip_smoke, "_workdir", workdir)
    monkeypatch.setattr(chip_smoke, "REACH_LIVE_EVENTS", 20_000)
    monkeypatch.setattr(chip_smoke, "REACH_LIVE_USERS", 5_000)
    out = chip_smoke.phase_reach(device="cpu", events=40_000,
                                 users=10_000)
    assert out["catchup"]["planes_equal_oracle"]
    assert out["catchup"]["kernel_launches"] == {
        "count_cells": 0, "decode_rows": 0, "cms_rows": 0}
    assert out["resume"]["epoch"] == 1
    assert out["queries"]["dispatches"] == 2
    assert out["queries"]["agree_equal_oracle"]
    assert out["queries"]["batch_query_device_ms"] == "not measured"
    assert out["storm"]["served"] == 1_200 and out["storm"]["shed"] == 0
    assert out["storm"]["dispatches"] <= 5
    assert out["shed"]["shed"] > 0
    assert out["shed"]["shed"] + out["shed"]["served"] == out["shed"]["sent"]
    live = out["live"]
    assert live["answers"] == 400 and live["bad"] == 0
    # every answer is a pushed state's; after the last push, the oracle's
    assert live["answers_of_a_pushed_state"] == live["served"] > 0
    assert live["pushes_recorded"] == live["pushes"] + 1
    assert live["final_queries_equal_oracle"]
    cli = out["cli"]
    assert cli["agree_equal_oracle"]
    assert cli["reach_rows_equal"]
    assert cli["replica"]["device"] == "cpu"
    # the tail's chunks shipped as deltas and the replica folded them
    assert cli["events"] == 40_000 + chip_smoke.REACH_TAIL_EVENTS
    assert cli["ship"]["deltas"] > 0 and cli["ship"]["cutovers"] > 0
    assert cli["replica"]["tailer"]["deltas_folded"] > 0
