"""The port's hyper-extended HLL ladder (``ops/hllx.py``, ``HLLXEngine``,
``--engine hllx``) against the JAX package's, on the CPU.

The same numpy batches (``tests/test_hllx.py``'s generator, plus rows
with negative ad indices, invalid rows, a join miss and a user whose hash
gives ``w = 2^25 - 1`` at p = 7, the reference's float32 rank fault) go
through ``streambench_tpu.ops.hllx`` and the port's ops: registers and
totals bit-identical for the step, the scan and the packed scan; rung 0
equal to the port's HLL plane; replay idempotent; the merge's shard-order
invariance and geometry error; ``moments`` within rtol 1e-6 (the port's
``hll.estimate`` may differ from JAX's in the last place); a legacy int32
plane folding as the reference's does.  Then the engine against JAX's
``HLLXEngine`` over one generated journal (registers, totals, the
``<hashtable>_hllx`` rows), snapshots across the two packages both ways,
and the CLI against the JAX CLI with the obs keys on.
"""

import json
import os
import random
import subprocess
import sys

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
from streambench_tpu.ops import hllx as jax_hllx
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import StreamRunner
from streambench_tpu_torch.engine import sketches
from streambench_tpu_torch.io.fakeredis import make_store
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import as_redis
from streambench_tpu_torch.ops import hll, hllx
from streambench_tpu_torch.ops import windowcount as wc
from tests.test_torch_engine import REPO, TOPIC

torch.set_num_threads(1)

C, G, R = 5, 8, 128
JOIN = np.array([0, 0, 1, 2, 3, 4, -1], np.int32)
TABLE = "hllx_test"

_U32 = 0xFFFFFFFF


def _unxorshift(y: int, s: int) -> int:
    x = y
    for _ in range(32 // s + 1):
        x = y ^ (x >> s)
    return x & _U32


def splitmix32_inverse(h: int) -> int:
    """The uint32 whose ``splitmix32`` is ``h`` (each step is a bijection:
    an xorshift or a product with an odd constant)."""
    x = _unxorshift(h, 15)
    x = (x * pow(0x735A2D97, -1, 2**32)) & _U32
    x = _unxorshift(x, 15)
    x = (x * pow(0x21F0AAAD, -1, 2**32)) & _U32
    x = _unxorshift(x, 16)
    return (x - 0x9E3779B9) & _U32


#: a user whose rung-0 hash is ``(2^25 - 1) << 7 | 5``: at R = 128 (p = 7)
#: ``w = 2^25 - 1``, which the reference's float32 frexp reads as rank 0
FAULT_USER = int(np.array([splitmix32_inverse(((2**25 - 1) << 7) | 5)],
                          np.uint32).view(np.int32)[0])


def rand_batch(rng, B=256, ads=6, users=300):
    """``tests/test_hllx.py:20-28``, with the edge rows on top: negative
    ad indices (the gather wraps them), an ad past the table (clamped),
    the join miss and the rank-fault user, each a valid view."""
    t0 = int(rng.integers(0, 10**6))
    b = dict(
        ad_idx=rng.integers(0, ads, B).astype(np.int32),
        user_idx=rng.integers(0, users, B).astype(np.int32),
        event_type=rng.integers(0, 3, B).astype(np.int32),
        event_time=(t0 + 10 * np.arange(B)).astype(np.int32),
        valid=rng.random(B) > 0.15,
    )
    edge = [(-1, 7), (-2, 8), (-7, 9), (6, 10), (9, 11), (1, FAULT_USER)]
    for i, (ad, user) in enumerate(edge):
        b["ad_idx"][i], b["user_idx"][i] = ad, user
        b["event_type"][i], b["valid"][i] = 0, True
    return b


COLS = ("ad_idx", "user_idx", "event_type", "event_time", "valid")


def fold_jax(state, batches, join=JOIN):
    for b in batches:
        state = jax_hllx.step(state, jnp.asarray(join),
                              *(jnp.asarray(b[c]) for c in COLS))
    return state


def fold_port(state, batches, join=JOIN):
    for b in batches:
        state = hllx.step(state, torch.from_numpy(join),
                          *(torch.from_numpy(b[c]) for c in COLS))
    return state


def assert_same(port, jax):
    np.testing.assert_array_equal(port.registers.numpy(),
                                  np.asarray(jax.registers))
    np.testing.assert_array_equal(port.totals.numpy(),
                                  np.asarray(jax.totals))
    assert int(port.watermark) == int(jax.watermark)
    assert int(port.dropped) == int(jax.dropped) == 0


def test_fault_user_hashes_to_the_rank_fault():
    h = hll.splitmix32(torch.tensor([FAULT_USER]))
    assert int(h[0]) >> 7 == 2**25 - 1
    assert int(hll._rank(h, 7)[0]) == 0


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_step_bit_identical_to_jax(seed):
    rng = np.random.default_rng(seed)
    batches = [rand_batch(rng, B=128) for _ in range(4)]
    port = fold_port(hllx.init_state(C, G, R), batches)
    assert_same(port, fold_jax(jax_hllx.init_state(C, G, R), batches))
    assert port.registers.dtype == torch.uint8
    # the fault user folds into campaign 0 (ad 1) with rank 0, as JAX's
    one = fold_port(hllx.init_state(C, G, R), [
        {k: v[5:6] for k, v in batches[0].items()}])
    assert int(one.registers[0, 0].max()) == 0
    assert int(one.totals[0]) == 1


def test_scan_and_packed_scan_bit_identical_to_jax():
    rng = np.random.default_rng(6)
    batches = [rand_batch(rng, B=128) for _ in range(4)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in COLS}
    # the wire word carries no sign: an ad index ships as the gather
    # reads it (a negative one wrapped, one past the table clamped)
    def as_read(ad):
        return np.clip(np.where(ad < 0, ad + len(JOIN), ad), 0,
                       len(JOIN) - 1)
    packed = np.stack([wc.pack_columns(as_read(b["ad_idx"]),
                                       b["event_type"], b["valid"])
                       for b in batches])
    seq = fold_port(hllx.init_state(C, G, R), batches)
    jseq = fold_jax(jax_hllx.init_state(C, G, R), batches)
    scan = hllx.scan_steps(hllx.init_state(C, G, R), torch.from_numpy(JOIN),
                           *(torch.from_numpy(stacked[c]) for c in COLS))
    jscan = jax_hllx.scan_steps(jax_hllx.init_state(C, G, R),
                                jnp.asarray(JOIN),
                                *(jnp.asarray(stacked[c]) for c in COLS))
    pscan = hllx.scan_steps_packed(
        hllx.init_state(C, G, R), torch.from_numpy(JOIN),
        torch.from_numpy(packed), torch.from_numpy(stacked["user_idx"]),
        torch.from_numpy(stacked["event_time"]))
    jpscan = jax_hllx.scan_steps_packed(
        jax_hllx.init_state(C, G, R), jnp.asarray(JOIN),
        jnp.asarray(packed), jnp.asarray(stacked["user_idx"]),
        jnp.asarray(stacked["event_time"]))
    for port, jax in ((seq, jseq), (scan, jscan), (pscan, jpscan),
                      (scan, jseq), (pscan, jseq)):
        assert_same(port, jax)


def test_rung0_equals_the_port_hll_plane():
    """The distinct rung hashes the bare user mix: its registers equal the
    port's HLL fold (one window slot) over the same rows."""
    rng = np.random.default_rng(5)
    batches = [rand_batch(rng) for _ in range(4)]
    for b in batches:            # one window, no lateness drops
        b["event_time"] = np.full_like(b["event_time"], 5_000)
    st = fold_port(hllx.init_state(C, G, R), batches)
    plain = hll.init_state(C, 1, num_registers=R)
    for b in batches:
        plain = hll.step(plain, torch.from_numpy(JOIN),
                         *(torch.from_numpy(b[c]) for c in COLS))
    assert int(plain.dropped) == 0
    assert torch.equal(st.registers[:, 0, :], plain.registers[:, 0, :])


def test_replay_is_idempotent_for_the_registers():
    rng = np.random.default_rng(7)
    batches = [rand_batch(rng) for _ in range(3)]
    once = fold_port(hllx.init_state(C, G, R), batches)
    regs, totals = once.registers.clone(), once.totals.clone()
    twice = fold_port(once, batches)
    assert torch.equal(twice.registers, regs)
    assert torch.equal(twice.totals, 2 * totals)   # F1 counts a replay


@pytest.mark.parametrize("seed", [11, 12])
def test_merge_shard_order_invariance(seed):
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    batches = [rand_batch(rng, B=128) for _ in range(8)]
    whole = fold_port(hllx.init_state(C, G, R), batches)
    S = pyrng.choice([2, 3])
    shards = [[] for _ in range(S)]
    for b in batches:
        shards[pyrng.randrange(S)].append(b)
    partials = [fold_port(hllx.init_state(C, G, R), sh) for sh in shards]
    pyrng.shuffle(partials)
    merged = partials[0]
    for p in partials[1:]:
        merged = hllx.merge(merged, p)
    assert torch.equal(merged.registers, whole.registers)
    assert torch.equal(merged.totals, whole.totals)
    assert int(merged.watermark) == int(whole.watermark)


def test_merge_geometry_mismatch_raises():
    with pytest.raises(ValueError, match=r"hllx\.merge.*128.*64"):
        hllx.merge(hllx.init_state(C, G, R), hllx.init_state(C, G, 64))
    for kw, msg in (({"groups": 0}, "groups"), ({"groups": 25}, "groups"),
                    ({"num_registers": 96}, "power of two"),
                    ({"num_registers": 8}, "power of two")):
        with pytest.raises(ValueError, match=msg):
            hllx.init_state(C, **kw)
    with pytest.raises(ValueError, match="int32 flat"):
        hllx.init_state(2**20, 24, 128)


def test_moments_within_rtol_of_jax_and_track_exact_statistics():
    """``tests/test_hllx.py:180-225``'s seeded Zipf workload: the port's
    moments within rtol 1e-6 of JAX's, F1 exact, and the reference's
    accuracy bounds against the exact counts."""
    rng = np.random.default_rng(21)
    events = []
    for c in range(C):
        counts = np.minimum(rng.zipf(1.3, 400), 128)
        for k, n in enumerate(counts):
            events.extend((c, c * 100_000 + k) for _ in range(n))
    rng.shuffle(events)
    ev = np.array(events, np.int64)
    times = (10 * np.arange(len(ev))).astype(np.int32)
    ad_of_c = np.array([0, 2, 3, 4, 5], np.int32)
    B = 512
    batches = []
    for i in range(0, len(ev), B):
        n = min(B, len(ev) - i)
        pad = B - n
        batches.append({
            "ad_idx": np.concatenate([ad_of_c[ev[i:i + n, 0]],
                                      np.zeros(pad)]).astype(np.int32),
            "user_idx": np.concatenate([ev[i:i + n, 1],
                                        np.zeros(pad)]).astype(np.int32),
            "event_type": np.zeros(B, np.int32),
            "event_time": np.concatenate([times[i:i + n],
                                          np.zeros(pad)]).astype(np.int32),
            "valid": np.concatenate([np.ones(n, bool),
                                     np.zeros(pad, bool)])})
    port = fold_port(hllx.init_state(C, G, R), batches)
    jax = fold_jax(jax_hllx.init_state(C, G, R), batches)
    assert_same(port, jax)
    m = {k: v.numpy() for k, v in hllx.moments(port).items()}
    jm = {k: np.asarray(v) for k, v in jax_hllx.moments(jax).items()}
    assert set(m) == set(jm) == {"distinct", "softcap", "log_moment",
                                 "totals"}
    for k in m:
        assert m[k].dtype == jm[k].dtype and m[k].shape == jm[k].shape, k
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-6, err_msg=k)
    from collections import Counter
    cnt = Counter((int(c), int(u)) for c, u in ev)
    for c in range(C):
        cs = np.array([n for (cc, _), n in cnt.items() if cc == c])
        assert abs(m["distinct"][c] - len(cs)) / len(cs) < 0.2
        logm = np.log2(1 + cs).sum()
        assert abs(m["log_moment"][c] - logm) / logm < 0.15
        assert int(m["totals"][c]) == int(cs.sum())


def test_legacy_int32_plane_folds_as_the_reference():
    """An int32 register plane (an old snapshot's) folds with the rank cast
    to the plane's dtype, and stays int32, as JAX's."""
    rng = np.random.default_rng(9)
    batches = [rand_batch(rng) for _ in range(3)]
    pst = hllx.init_state(C, G, R)
    pst = pst._replace(registers=pst.registers.to(torch.int32))
    jst = jax_hllx.init_state(C, G, R)
    jst = jst._replace(registers=jst.registers.astype(jnp.int32))
    port, jax = fold_port(pst, batches), fold_jax(jst, batches)
    assert port.registers.dtype == torch.int32
    assert np.asarray(jax.registers).dtype == np.int32
    assert_same(port, jax)
    u8 = fold_port(hllx.init_state(C, G, R), batches)
    assert torch.equal(port.registers, u8.registers.to(torch.int32))


# ----------------------------------------------------------------------
# the engine

@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("hllx"))
    gen.do_setup(as_redis(make_store()), default_config(),
                 broker=FileBroker(os.path.join(wd, "broker")),
                 events_num=12_000, rng=random.Random(77), workdir=wd)
    mapping = gen.load_ad_mapping_file(os.path.join(wd,
                                                    gen.AD_TO_CAMPAIGN_FILE))
    campaigns, _ = gen.load_ids(wd)
    return wd, campaigns, mapping


def make(side, campaigns, mapping, redis=None, **cfg_kw):
    cfg_kw = {"redis_hashtable": TABLE, **cfg_kw}
    if side == "jax":
        return jax_sketches.HLLXEngine(jax_default_config(**cfg_kw), mapping,
                                       campaigns=campaigns, redis=redis)
    return sketches.HLLXEngine(default_config(**cfg_kw), mapping,
                               campaigns=campaigns, redis=redis,
                               device="cpu")


def run_side(side, wd, campaigns, mapping, **cfg_kw):
    jax = side == "jax"
    r = jax_as_redis(jax_make_store()) if jax else as_redis(make_store())
    broker = (JaxBroker if jax else FileBroker)(os.path.join(wd, "broker"))
    eng = make(side, campaigns, mapping, redis=r, **cfg_kw)
    stats = (JaxRunner if jax else StreamRunner)(
        eng, broker.reader(default_config().kafka_topic)).run_catchup()
    eng.close()
    return eng, stats, r.hgetall(f"{TABLE}_hllx")


def planes(eng):
    return np.asarray(eng.state.registers), np.asarray(eng.state.totals)


def views(wd):
    with open(os.path.join(wd, gen.KAFKA_JSON_FILE)) as f:
        return sum(1 for ln in f if json.loads(ln)["event_type"] == "view")


def assert_rows_close(got, want):
    assert set(got) == set(want) and got
    for key, w in want.items():
        g = got[key]
        if key.endswith(":views"):
            assert int(g) == int(w), key
        elif key.endswith(":distinct"):
            assert abs(int(g) - int(w)) <= 1, key
        else:
            assert abs(float(g) - float(w)) <= 0.1, key


@pytest.mark.parametrize("cfg_kw", [
    {"jax_batch_size": 512},
    {"jax_batch_size": 512, "jax_scan_batches": 1},
    {"jax_batch_size": 1024, "jax_ingest_pipeline": "on",
     "jax_encode_workers": 2}],
    ids=["packed_scan", "per_batch", "pipelined_pool"])
def test_engine_catchup_equals_jax(journal, cfg_kw):
    wd, campaigns, mapping = journal
    port, pst, prow = run_side("port", wd, campaigns, mapping, **cfg_kw)
    ref, jst, jrow = run_side("jax", wd, campaigns, mapping, **cfg_kw)
    assert pst.events == jst.events == 12_000
    assert pst.windows_written == jst.windows_written == 0
    for a, b in zip(planes(port), planes(ref)):
        np.testing.assert_array_equal(a, b)
    assert int(port.state.watermark) == int(ref.state.watermark)
    assert port.dropped == ref.dropped == 0
    assert int(port.moments()["totals"].sum()) == views(wd)
    assert_rows_close(prow, jrow)
    # G = 8 rungs: distinct, logm, views and 8 caps per campaign seen
    assert len(prow) == 11 * int((port.moments()["totals"] > 0).sum())


@pytest.mark.parametrize("first,second", [("jax", "port"),
                                          ("port", "jax")],
                         ids=["jax_to_port", "port_to_jax"])
def test_snapshots_restore_across_packages(journal, tmp_path, first,
                                           second):
    """A snapshot one package wrote halfway finishes in the other: the
    registers and totals equal an uninterrupted run's."""
    wd, campaigns, mapping = journal
    full, _, _ = run_side("port", wd, campaigns, mapping,
                          jax_batch_size=512)
    ckdir = str(tmp_path / f"ck_{first}")
    topic = default_config().kafka_topic

    def parts(side):
        jax = side == "jax"
        broker = (JaxBroker if jax else FileBroker)(os.path.join(wd,
                                                                 "broker"))
        return (broker, JaxCheckpointer if jax else Checkpointer,
                JaxRunner if jax else StreamRunner)

    broker1, ck1, run1 = parts(first)
    a = make(first, campaigns, mapping, jax_batch_size=512)
    run1(a, broker1.reader(topic), checkpointer=ck1(ckdir),
         checkpoint_interval_ms=0).run_catchup(max_events=6_000)
    broker2, ck2, run2 = parts(second)
    b = make(second, campaigns, mapping, jax_batch_size=512)
    runner = run2(b, broker2.reader(topic), checkpointer=ck2(ckdir),
                  checkpoint_interval_ms=0)
    assert runner.resume()
    assert b.events_processed == a.events_processed
    runner.run_catchup()
    for x, y in zip(planes(b), planes(full)):
        np.testing.assert_array_equal(x, y)


def test_restore_refuses_other_geometry_and_family(journal):
    wd, campaigns, mapping = journal
    eng = make("port", campaigns, mapping, jax_batch_size=512)
    snap = eng.snapshot(offset=0)
    other = sketches.HLLXEngine(default_config(jax_batch_size=512), mapping,
                                campaigns=campaigns, groups=4, device="cpu")
    with pytest.raises(ValueError, match="hllx_groups"):
        other.restore(snap)
    reach = sketches.ReachSketchEngine(default_config(), mapping,
                                       campaigns=campaigns, device="cpu")
    with pytest.raises(ValueError, match="engine family"):
        reach.restore(snap)


def test_hllx_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sketches.HLLXEngine(default_config(), {"ad": "camp"})


def test_warmup_leaves_the_state_empty(journal):
    wd, campaigns, mapping = journal
    eng = make("port", campaigns, mapping, jax_batch_size=512)
    eng.warmup()
    assert int(eng.state.registers.max()) == 0
    assert int(eng.state.totals.sum()) == 0 and eng.events_processed == 0


def _cli(module, wd, conf, extra=()):
    proc = subprocess.run(
        [sys.executable, "-m", module, "--confPath", conf, "--workdir", wd,
         "--catchup", "--engine", "hllx", *extra],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


def test_cli_engine_hllx_on_cpu_with_the_obs_keys(journal, tmp_path):
    """``--engine hllx --device cpu --catchup`` with xfer, devmem and
    occupancy on: the stats line counts the hllx fold under its own
    family (12 B a packed row: the word, the user id, the time), no
    kernel launches, and the run's events equal the JAX CLI's."""
    wd, _, _ = journal
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\njax.obs.xfer: true\n'
                    "jax.obs.devmem: true\njax.obs.occupancy: true\n")
    lines = _cli("streambench_tpu_torch.engine", wd, str(conf),
                 ["--device", "cpu"])
    assert any("engine up:" in ln and "engine=hllx" in ln for ln in lines)
    stats = json.loads(lines[-1])
    assert stats["events"] == 12_000 and stats["dropped"] == 0
    assert stats["windows_written"] == 0
    assert stats["kernel_launches"] == {"count_cells": 0, "decode_rows": 0,
                                        "cms_rows": 0}
    packed = stats["xfer"]["formats"]["packed"]
    assert packed["bytes_per_row"] == 12
    assert stats["devmem"]["state_bytes"] == 100 * 8 * 128 + 100 * 4 + 8
    assert "device_busy_ratio" in stats
    jconf = tmp_path / "jconf.yaml"
    jconf.write_text('redis.host: ":inprocess:"\n')
    jstats = json.loads(_cli("streambench_tpu.engine", wd, str(jconf))[-1])
    assert jstats["events"] == stats["events"]
    assert jstats["windows_written"] == stats["windows_written"] == 0


def test_cli_sharded_hllx_is_an_error(journal, tmp_path):
    """As the reference's: hllx has no sharded form."""
    wd, _, _ = journal
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\n')
    proc = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.engine", "--confPath",
         str(conf), "--workdir", wd, "--catchup", "--engine", "hllx",
         "--sharded", "--device", "cpu"], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == 2
    assert ("--sharded supports exact/hll/sliding/session/reach, not "
            "--engine hllx") in proc.stderr


def test_harness_torch_test_with_engine_hllx_on_cpu(tmp_path):
    """``ENGINE=hllx TORCH_TEST``: no window rows, so the composite's
    evidence is the engine's final stats line."""
    from tests.test_torch_harness import free_port, run_harness

    wd = str(tmp_path / "run")
    env = {"WORKDIR": wd, "REDIS_PORT": str(free_port()), "LOAD": "400",
           "TEST_TIME": "6", "STOP_STATS_GRACE": "2", "TOPIC": TOPIC,
           "DEVICE": "cpu", "ENGINE": "hllx"}
    try:
        proc = run_harness(["TORCH_TEST"], env, timeout=240)
    finally:
        run_harness(["STOP_ALL"], env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TORCH_TEST evidence:" in proc.stdout + proc.stderr
    log = open(os.path.join(wd, "logs", "engine.log")).read()
    assert "engine=hllx" in log
    stats = json.loads(log.strip().splitlines()[-1])
    emitted = int(open(os.path.join(wd, "logs", "load.log")).read()
                  .split("emitted ")[-1].split()[0])
    assert stats["events"] == emitted > 0 and stats["dropped"] == 0
