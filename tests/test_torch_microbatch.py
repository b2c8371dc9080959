"""The fork's count-window micro-batch mode in the port
(``streambench_tpu_torch/engine/microbatch.py``) against the JAX
package's (``streambench_tpu/engine/microbatch.py``), on the CPU.

The window folds bit for bit on seeded inputs (negative and
out-of-range ad indices, campaign -1, a user whose hash gives
``w = 2^25 - 1``); ``run_microbatch`` exact and HLL over one generated
3-partition journal through both packages, with each barrier; the
reference's barrier, latency-hash, end-of-stream and checkpoint tests
mirrored; the engine CLI's ``--microbatch`` against the JAX CLI's.
"""

import json
import random
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import __main__ as jax_cli
from streambench_tpu.engine import microbatch as jmb
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import __main__ as cli
from streambench_tpu_torch.engine import microbatch as mb
from streambench_tpu_torch.io.fakeredis import FakeRedisStore
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import as_redis, read_latency_hash

torch.set_num_threads(1)

_U32 = 0xFFFFFFFF


def _unxorshift(y: int, s: int) -> int:
    x = y
    for _ in range(32 // s + 1):
        x = y ^ (x >> s)
    return x & _U32


def splitmix32_inverse(h: int) -> int:
    """The uint32 whose ``splitmix32`` is ``h``."""
    x = _unxorshift(h, 15)
    x = (x * pow(0x735A2D97, -1, 2**32)) & _U32
    x = _unxorshift(x, 15)
    x = (x * pow(0x21F0AAAD, -1, 2**32)) & _U32
    x = _unxorshift(x, 16)
    return (x - 0x9E3779B9) & _U32


#: a user whose hash is ``(2^25 - 1) << 7 | 5``: at R = 128 (p = 7)
#: ``w = 2^25 - 1``, which the reference's float32 frexp reads as rank 0
FAULT_USER = int(np.array([splitmix32_inverse(((2**25 - 1) << 7) | 5)],
                          np.uint32).view(np.int32)[0])


def setup(tmp_path, events=1800, partitions=3, window_size=300, seed=21):
    cfg = default_config(window_size=window_size, map_partitions=partitions)
    broker = FileBroker(str(tmp_path / "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=events,
                 rng=random.Random(seed), workdir=str(tmp_path),
                 partitions=partitions)
    mapping = gen.load_ad_mapping_file(str(tmp_path / gen.AD_TO_CAMPAIGN_FILE))
    campaigns, _ = gen.load_ids(str(tmp_path))
    return cfg, broker, mapping, campaigns


def jax_side(tmp_path, cfg):
    """The same journal through the JAX package's config and broker."""
    return (jax_default_config(window_size=cfg.window_size,
                               map_partitions=cfg.map_partitions),
            JaxBroker(str(tmp_path / "broker")))


def golden_windows(broker, cfg, mapping, campaigns):
    """Per-(window, campaign) view counts recomputed from the partition
    journals (``tests/test_microbatch.py:golden_windows``)."""
    P = cfg.map_partitions
    psize = cfg.window_size // P
    cidx = {c: i for i, c in enumerate(campaigns)}
    per_part = []
    for p in range(P):
        with broker.reader(cfg.kafka_topic, p) as r:
            lines = []
            while True:
                got = r.poll()
                if not got:
                    break
                lines.extend(got)
        per_part.append(lines)
    n_windows = min(len(lines) // psize for lines in per_part)
    out = []
    for k in range(n_windows):
        counts = np.zeros(len(campaigns), np.int64)
        for p in range(P):
            for line in per_part[p][k * psize:(k + 1) * psize]:
                ev = json.loads(line)
                if ev["event_type"] == "view":
                    counts[cidx[mapping[ev["ad_id"]]]] += 1
        out.append(counts)
    return out


def truncate_partition(broker, cfg, p: int, lines_kept: int) -> None:
    path = broker.topic_path(cfg.kafka_topic, p)
    with open(path, "rb") as f:
        lines = f.read().splitlines()[:lines_kept]
    with open(path, "wb") as f:
        f.write(b"".join(line + b"\n" for line in lines))


# ----------------------------------------------------------------------
# the window folds, bit for bit
# ----------------------------------------------------------------------

def _window_inputs(seed: int, B: int = 1666, C: int = 7, T: int = 40):
    rng = np.random.default_rng(seed)
    # a join table with misses (-1) and its trailing "unknown" row
    join = rng.integers(-1, C, T).astype(np.int32)
    join[-1] = -1
    ad = rng.integers(-T - 3, T + 3, B).astype(np.int32)
    etype = rng.integers(-1, 3, B).astype(np.int32)
    valid = rng.random(B) < 0.9
    users = rng.integers(-2**31, 2**31 - 1, B).astype(np.int32)
    # the rank-fault user, a valid view of a joined ad on a few rows
    hit = np.flatnonzero(join >= 0)[0]
    users[:5] = FAULT_USER
    ad[:5], etype[:5], valid[:5] = hit, 0, True
    return join, ad, etype, valid, users


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_campaign_counts_bit_identical_to_jax(seed):
    join, ad, etype, valid, _ = _window_inputs(seed)
    C = 7
    want = np.asarray(jmb.window_campaign_counts(
        jnp.asarray(join), ad, etype, valid, num_campaigns=C))
    t = torch.from_numpy
    got = mb.window_campaign_counts(t(join), t(ad), t(etype), t(valid),
                                    num_campaigns=C)
    assert got.dtype == torch.int32 and tuple(got.shape) == (C,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("R", [16, 128, 256])
def test_window_campaign_hll_bit_identical_to_jax(R):
    join, ad, etype, valid, users = _window_inputs(R)
    C = 7
    want = np.asarray(jmb.window_campaign_hll(
        jnp.asarray(join), ad, users, etype, valid, num_campaigns=C,
        num_registers=R))
    t = torch.from_numpy
    got = mb.window_campaign_hll(t(join), t(ad), t(users), t(etype),
                                 t(valid), num_campaigns=C,
                                 num_registers=R)
    assert got.dtype == torch.int32 and tuple(got.shape) == (C, R)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 0


def test_the_rank_fault_user_folds_rank_0_like_the_reference():
    """At R = 128 the fault user alone leaves its register at 0 in both
    packages (an exact bit length would give rank 1)."""
    join = np.array([0, -1], np.int32)
    one = np.ones(1, np.int32)
    args = (join, np.zeros(1, np.int32), one * FAULT_USER,
            np.zeros(1, np.int32), np.ones(1, bool))
    want = np.asarray(jmb.window_campaign_hll(
        jnp.asarray(args[0]), *args[1:], num_campaigns=1,
        num_registers=128))
    got = mb.window_campaign_hll(*map(torch.from_numpy, args),
                                 num_campaigns=1, num_registers=128)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want.max()) == 0


# ----------------------------------------------------------------------
# run_microbatch through both packages
# ----------------------------------------------------------------------

def _barriers(kind: str, cfg):
    if kind == "local":
        return None, None
    return (jmb.RedisWindowBarrier(jax_as_redis(JaxStore()), "bt",
                                   cfg.map_partitions),
            mb.RedisWindowBarrier(as_redis(FakeRedisStore()), "bt",
                                  cfg.map_partitions))


@pytest.mark.parametrize("barrier", ["local", "redis"])
@pytest.mark.parametrize("engine", ["exact", "hll"])
def test_run_microbatch_matches_jax(tmp_path, engine, barrier):
    cfg, broker, mapping, campaigns = setup(tmp_path, events=3600)
    jcfg, jbroker = jax_side(tmp_path, cfg)
    jb, tb = _barriers(barrier, cfg)
    want, jres = jmb.run_microbatch(jcfg, jbroker, mapping, campaigns,
                                    engine=engine, barrier=jb)
    got, res = mb.run_microbatch(cfg, broker, mapping, campaigns,
                                 engine=engine, barrier=tb, device="cpu")
    assert sorted(got) == sorted(want) == list(range(12))
    for k in want:
        diff = np.abs(got[k].astype(np.int64) - want[k].astype(np.int64))
        assert diff.max() <= (1 if engine == "hll" else 0), k
    assert ([(r.partition, r.windows, r.events) for r in res]
            == [(r.partition, r.windows, r.events) for r in jres]
            == [(p, 12, 1200) for p in range(3)])
    assert res[0].stamps == res[1].stamps == res[2].stamps
    if engine == "exact":
        expected = golden_windows(broker, cfg, mapping, campaigns)
        for k, e in enumerate(expected):
            np.testing.assert_array_equal(got[k].astype(np.int64), e)
    assert all(lat >= 0 for r in res for lat in r.latency.values())


def test_hll_union_across_partitions(tmp_path):
    """The same user seen in different partitions counts once
    (stateless id hashing), as in ``tests/test_microbatch_sketch.py``."""
    P, psize, distinct = 3, 100, 40
    cfg = default_config(window_size=P * psize, map_partitions=P)
    broker = FileBroker(str(tmp_path / "broker"))
    broker.create_topic(cfg.kafka_topic, partitions=P)
    for p in range(P):
        with broker.writer(cfg.kafka_topic, p) as w:
            for i in range(psize):
                w.append(json.dumps({
                    "user_id": f"user-{i % distinct}",
                    "page_id": f"page-{i}", "ad_id": "ad-0",
                    "ad_type": "banner", "event_type": "view",
                    "event_time": str(100_000 + i),
                    "ip_address": "1.2.3.4"}))
    merged, _ = mb.run_microbatch(cfg, broker, {"ad-0": "camp-0"},
                                  ["camp-0"], engine="hll", registers=256,
                                  device="cpu")
    assert abs(int(merged[0][0]) - distinct) <= 12


def test_other_families_are_refused_with_the_reference_text(tmp_path):
    cfg, broker, mapping, campaigns = setup(tmp_path, events=300)
    with pytest.raises(ValueError, match="count-window") as got:
        mb.run_microbatch(cfg, broker, mapping, campaigns, engine="session",
                          device="cpu")
    jcfg, jbroker = jax_side(tmp_path, cfg)
    with pytest.raises(ValueError) as want:
        jmb.run_microbatch(jcfg, jbroker, mapping, campaigns,
                           engine="session")
    assert str(got.value) == str(want.value)


def test_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    cfg, broker, mapping, campaigns = setup(tmp_path, events=300)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mb.run_microbatch(cfg, broker, mapping, campaigns)


# ----------------------------------------------------------------------
# the reference's barrier and end-of-stream tests, mirrored
# ----------------------------------------------------------------------

def test_redis_barrier_agrees_and_is_delete_race_free(tmp_path):
    cfg, broker, mapping, campaigns = setup(tmp_path, events=900)
    r = as_redis(FakeRedisStore())
    barrier = mb.RedisWindowBarrier(r, "barrier_tbl", cfg.map_partitions)
    merged, results = mb.run_microbatch(cfg, broker, mapping, campaigns,
                                        barrier=barrier, device="cpu")
    assert len(merged) == 3
    assert results[0].stamps == results[1].stamps == results[2].stamps
    # per-window stamp fields persist (nothing HDEL'd mid-wait) and the
    # counter wrapped back to 0 after each full rendezvous
    for k in range(3):
        assert r.hget("barrier_tbl", f"start_time:{k}") is not None
    assert r.hget("barrier_tbl", "partition_count") == "0"


def test_latency_dump_uses_fork_hash_schema(tmp_path):
    cfg, broker, mapping, campaigns = setup(tmp_path, events=900)
    r = as_redis(FakeRedisStore())
    mb.run_microbatch(cfg, broker, mapping, campaigns, redis=r,
                      device="cpu")
    running, per_idx = read_latency_hash(r, cfg.redis_hashtable)
    assert set(per_idx) == {1, 2, 3}       # one dump a partition
    for idx in per_idx:
        # one latency a window, except where windows share a stamp
        assert 1 <= len(per_idx[idx]) <= 3
        assert running[idx] >= 0


@pytest.mark.parametrize("barrier", ["local", "redis"])
def test_unequal_partitions_end_without_deadlock(tmp_path, barrier):
    """One partition runs dry a window early: peers are released (by the
    local barrier's abort or the Redis abort broadcast, not a timeout)
    and the extra windows dropped."""
    cfg, broker, mapping, campaigns = setup(tmp_path, events=1800)
    truncate_partition(broker, cfg, 2, 100)
    b = (None if barrier == "local" else mb.RedisWindowBarrier(
        as_redis(FakeRedisStore()), "bt", cfg.map_partitions, timeout_s=20))
    done = []
    t0 = time.monotonic()
    t = threading.Thread(target=lambda: done.append(mb.run_microbatch(
        cfg, broker, mapping, campaigns, barrier=b, device="cpu")),
        daemon=True)
    t.start()
    t.join(30)
    assert not t.is_alive(), "microbatch run deadlocked"
    assert time.monotonic() - t0 < 10
    merged, results = done[0]
    assert len(merged) == 1 and results[2].windows == 1


def test_stock_window_size_runs_as_the_fork_divides_it(tmp_path):
    """The stock ``window.size: 5000`` over ``map.partitions: 3``: the
    fork buffers 5000 // 3 = 1,666 events a partition
    (``AdvertisingTopologyNative.java:200-201``), and so does the port;
    the JAX package refuses the stock configuration (5000 is not a
    multiple of 3), a reference fault the port does not copy."""
    cfg, broker, mapping, campaigns = setup(tmp_path, events=10_000,
                                            window_size=5000)
    jcfg, jbroker = jax_side(tmp_path, cfg)
    with pytest.raises(ValueError, match="not divisible"):
        jmb.run_microbatch(jcfg, jbroker, mapping, campaigns)
    merged, results = mb.run_microbatch(cfg, broker, mapping, campaigns,
                                        device="cpu")
    assert len(merged) == 2                 # 3,333 lines a partition
    assert all(r.windows == 2 and r.events == 2 * 1666 for r in results)
    expected = golden_windows(broker, cfg, mapping, campaigns)
    assert len(expected) == 2
    for k, e in enumerate(expected):
        np.testing.assert_array_equal(merged[k].astype(np.int64), e)
    with pytest.raises(ValueError, match="smaller than map.partitions"):
        mb.run_microbatch(default_config(window_size=2, map_partitions=3),
                          broker, mapping, campaigns, device="cpu")


def test_missing_partition_is_an_error_not_empty_result(tmp_path):
    _, broker, mapping, campaigns = setup(tmp_path, events=300,
                                          partitions=1)
    cfg = default_config(window_size=300, map_partitions=3)
    with pytest.raises(ValueError, match="no partition"):
        mb.run_microbatch(cfg, broker, mapping, campaigns, device="cpu")


def test_barrier_timeout_is_an_error_not_eos():
    b = mb.LocalWindowBarrier(2, timeout_s=0.05)
    with pytest.raises(TimeoutError, match="failed to arrive"):
        b.arrive(0)  # the second partition never shows up


def test_redis_barrier_reset_clears_stale_run_residue():
    r = as_redis(FakeRedisStore())
    r.execute("HSET", "bt", "partition_count", "2")
    r.execute("HSET", "bt", "aborted", "1")
    r.execute("HSET", "bt", "start_time:0", "12345")
    b = mb.RedisWindowBarrier(r, "bt", 1)
    b.reset()  # the run's single reset point
    assert r.hget("bt", "start_time:0") is None
    assert b.arrive(0) > 12345  # a fresh stamp, not the stale one
    assert r.hget("bt", "partition_count") == "0"


def test_redis_barrier_construction_has_no_side_effects():
    r = as_redis(FakeRedisStore())
    r.execute("HSET", "bt", "aborted", "1")  # live broadcast from a peer
    mb.RedisWindowBarrier(r, "bt", 3)        # late construction
    assert r.hget("bt", "aborted") == "1"


def test_redis_barrier_run_id_namespaces_fields():
    r = as_redis(FakeRedisStore())
    a = mb.RedisWindowBarrier(r, "bt", 1, run_id="runA")
    z = mb.RedisWindowBarrier(r, "bt", 1, run_id="runZ")
    a.reset()
    z.reset()
    a.abort()  # run A ends
    assert z.arrive(0) > 0  # run Z is unaffected
    assert r.hget("bt", "start_time:runZ:0") is not None
    assert r.hget("bt", "aborted:runA") == "1"


def test_local_barrier_stamps_shared():
    b = mb.LocalWindowBarrier(4)
    out = [[] for _ in range(4)]

    def worker(i):
        for k in range(5):
            out[i].append(b.arrive(k))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k in range(5):
        assert len({out[i][k] for i in range(4)}) == 1  # same stamp
    assert out[0] == sorted(out[0])


def test_local_barrier_returns_the_stamp_of_a_generation_broken_late():
    """The CPython ``Barrier`` race: a peer's ``abort()`` after the
    generation completed must not lose the window; the stamp says the
    action ran."""
    b = mb.LocalWindowBarrier(1)
    assert b.arrive(0) > 0
    b.abort()
    b._stamps[1] = 7           # the action of generation 1 ran, then abort
    assert b.arrive(1) == 7
    with pytest.raises(threading.BrokenBarrierError):
        b.arrive(2)            # a window that never assembled: end of stream


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------

@pytest.mark.parametrize("engine,registers", [("exact", 128), ("hll", 64)])
def test_checkpoint_resume_matches_clean_run(tmp_path, engine, registers):
    cfg, broker, mapping, campaigns = setup(tmp_path, events=3600, seed=33)
    kw = dict(engine=engine, registers=registers, device="cpu")
    clean, _ = mb.run_microbatch(cfg, broker, mapping, campaigns, **kw)
    ckdir = str(tmp_path / "ck")
    part1, _ = mb.run_microbatch(cfg, broker, mapping, campaigns,
                                 checkpoint_dir=ckdir, checkpoint_every=4,
                                 max_windows=9, **kw)
    assert len(part1) == 9
    k, meta, _ = mb.MicroBatchCheckpointer(ckdir).load()
    assert k == 8 and meta["engine"] == engine
    part2, results = mb.run_microbatch(cfg, broker, mapping, campaigns,
                                       checkpoint_dir=ckdir,
                                       checkpoint_every=4, **kw)
    assert sorted(part2) == sorted(clean)
    for w in clean:
        np.testing.assert_array_equal(part2[w], clean[w], err_msg=f"w={w}")
    assert all(r.windows == 12 and r.events == 1200 for r in results)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The chunk files are the reference's, key for key: a chain the JAX
    package wrote resumes in the port to the port's clean run."""
    cfg, broker, mapping, campaigns = setup(tmp_path, events=3600, seed=33)
    jcfg, jbroker = jax_side(tmp_path, cfg)
    ckdir = str(tmp_path / "ck")
    jmb.run_microbatch(jcfg, jbroker, mapping, campaigns,
                       checkpoint_dir=ckdir, checkpoint_every=4,
                       max_windows=6)
    clean, _ = mb.run_microbatch(cfg, broker, mapping, campaigns,
                                 device="cpu")
    got, results = mb.run_microbatch(cfg, broker, mapping, campaigns,
                                     checkpoint_dir=ckdir,
                                     checkpoint_every=4, device="cpu")
    assert sorted(got) == sorted(clean)
    for w in clean:
        np.testing.assert_array_equal(got[w], clean[w], err_msg=f"w={w}")
    assert all(r.windows == 12 for r in results)


def test_checkpoint_geometry_mismatch_rejected(tmp_path):
    cfg, broker, mapping, campaigns = setup(tmp_path, events=1800, seed=33)
    ckdir = str(tmp_path / "ck")
    mb.run_microbatch(cfg, broker, mapping, campaigns, checkpoint_dir=ckdir,
                      checkpoint_every=2, device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        mb.run_microbatch(cfg, broker, mapping, campaigns, engine="hll",
                          checkpoint_dir=ckdir, device="cpu")


def test_broken_checkpoint_chain_is_refused(tmp_path):
    cfg, broker, mapping, campaigns = setup(tmp_path, events=1800, seed=33)
    ckdir = tmp_path / "ck"
    mb.run_microbatch(cfg, broker, mapping, campaigns,
                      checkpoint_dir=str(ckdir), checkpoint_every=2,
                      device="cpu")
    files = sorted(ckdir.glob("mb-*.npz"))
    assert len(files) >= 2
    files[0].unlink()
    with pytest.raises(ValueError, match="chain broken"):
        mb.MicroBatchCheckpointer(str(ckdir)).load()


def test_checkpoints_need_the_in_process_barrier(tmp_path):
    cfg, broker, mapping, campaigns = setup(tmp_path, events=300)
    b = mb.RedisWindowBarrier(as_redis(FakeRedisStore()), "bt", 3)
    with pytest.raises(ValueError, match="in-process barrier"):
        mb.run_microbatch(cfg, broker, mapping, campaigns, barrier=b,
                          checkpoint_dir=str(tmp_path / "ck"),
                          device="cpu")


# ----------------------------------------------------------------------
# the engine CLI
# ----------------------------------------------------------------------

STATS_KEYS = ("engine", "windows", "events", "partitions", "total_views")


@pytest.mark.parametrize("engine", ["exact", "hll"])
def test_cli_microbatch_matches_the_jax_cli(tmp_path, capsys, engine):
    setup(tmp_path, events=3600)
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\nwindow.size: 300\n'
                    'map.partitions: 3\n')
    args = ["--confPath", str(conf), "--workdir", str(tmp_path),
            "--microbatch"] + (["--engine", engine]
                               if engine != "exact" else [])
    assert jax_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for key in STATS_KEYS[:-1]:
        assert got[key] == want[key], key
    # HLL: each (window, campaign) estimate within 1 of the reference's
    tol = 0 if engine == "exact" else want["windows"] * 100
    assert abs(got["total_views"] - want["total_views"]) <= tol
    assert got["windows"] == 12 and got["events"] == 3600
    assert got["p50_latency_ms"] >= 0


def test_cli_microbatch_refuses_other_engines_as_the_reference(tmp_path):
    setup(tmp_path, events=300)
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\n')
    args = ["--confPath", str(conf), "--workdir", str(tmp_path),
            "--microbatch", "--engine", "sliding"]
    with pytest.raises(SystemExit) as want:
        jax_cli.main(args)
    with pytest.raises(SystemExit) as got:
        cli.main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "no count-window form of --engine sliding" in str(got.value)
