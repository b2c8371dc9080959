"""The dimensional-aggregation family of the port
(``streambench_tpu_torch/dimensions/``) against the JAX package's
(``streambench_tpu/dimensions/``), on the CPU.

The schema parser; ``DimensionsComputation.step`` state bit for bit over
several batches with all four aggregators, lateness drops, overflow keys
and int32 wrap; ``flush_closed`` closed and drained; ``merge`` and its
divergent-ring refusal; ``run_synthetic``'s rows; ``DimensionApp`` end to
end (stored rows and published rows, ``now_ms`` frozen in both apps'
modules); and the CLI's stats line against the JAX CLI's.
"""

import json
import random

import numpy as np
import pytest
import torch

import streambench_tpu.dimensions.app as jax_app_mod
import streambench_tpu.utils.ids as jax_ids
from streambench_tpu.dimensions import __main__ as jax_cli
from streambench_tpu.dimensions import compute as jc
from streambench_tpu.dimensions import schema as js
from streambench_tpu.dimensions import synthetic as jsyn
from streambench_tpu.dimensions.store import (
    DurableDimensionStore as JaxStore,
)
import streambench_tpu_torch.dimensions.app as app_mod
import streambench_tpu_torch.utils.ids as ids
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.dimensions import __main__ as cli
from streambench_tpu_torch.dimensions import compute as tc
from streambench_tpu_torch.dimensions import schema as ts
from streambench_tpu_torch.dimensions import synthetic as tsyn
from streambench_tpu_torch.dimensions import (
    SENTINEL_CAMPAIGN,
    DimensionApp,
    DurableDimensionStore,
)

torch.set_num_threads(1)

SCHEMA = {
    "keys": [{"name": "campaignId"}],
    "timeBuckets": ["10s"],
    "values": [{"name": "clicks", "aggregators": ["SUM", "COUNT"]},
               {"name": "latency", "aggregators": ["MAX", "MIN"]}],
    "dimensions": [{"combination": ["campaignId"]}],
}


def _pair(schema=SCHEMA, **kw):
    jd = jc.DimensionsComputation(js.parse_schema(schema), **kw)
    td = tc.DimensionsComputation(ts.parse_schema(schema), device="cpu",
                                  **kw)
    return jd, td


def same_state(a, b) -> None:
    for x, y in zip(a.aggs, b.aggs, strict=True):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(np.asarray(a.presence), b.presence.numpy())
    np.testing.assert_array_equal(np.asarray(a.window_ids),
                                  b.window_ids.numpy())
    assert int(a.watermark) == int(b.watermark)
    assert int(a.dropped) == int(b.dropped)


def _batch(rng, B, K, t0, spread=5_000, late=0):
    key = rng.integers(-1, K + 1, B).astype(np.int32)   # -1: overflow
    t = (t0 + rng.integers(-late, spread, B)).astype(np.int32)
    clicks = rng.integers(-2**31, 2**31 - 1, B).astype(np.int32)  # wraps
    lat = rng.integers(-1000, 1000, B).astype(np.int32)
    valid = rng.random(B) < 0.9
    return key, t, valid, {"clicks": clicks, "latency": lat}


# ----------------------------------------------------------------- schema
def test_parse_schema_equals_the_reference():
    # the reference's own eventSchema.json (which has a trailing comma)
    src = """{"keys": [ {"name":"campaignId","type":"string"}, ],
 "timeBuckets":["10s"],
 "values": [
    {"name":"clicks","type":"long","aggregators":["SUM"]},
    {"name":"latency","type":"long","aggregators":["MAX"]} ],
 "dimensions": [ {"combination":["campaignId"]} ]}"""
    for doc in (src, SCHEMA, {"keys": [{"name": "k"}], "timeBuckets": [],
                              "values": [{"name": "v"}]}):
        got, want = ts.parse_schema(doc), js.parse_schema(doc)
        assert (got.keys, got.time_bucket_ms, got.combinations,
                got.aggregate_slots()) == (want.keys, want.time_bucket_ms,
                                           want.combinations,
                                           want.aggregate_slots())
    assert ts.AGGREGATORS == js.AGGREGATORS
    for spec in ("200ms", "1m", "10s", "2h"):
        assert ts.parse_time_bucket(spec) == js.parse_time_bucket(spec)
    with pytest.raises(ValueError, match="unsupported aggregator"):
        ts.parse_schema({"keys": [{"name": "k"}],
                         "values": [{"name": "v", "aggregators": ["MEDIAN"]}]})


# ----------------------------------------------------------------- fold
@pytest.mark.parametrize("seed", [0, 1])
def test_step_and_flush_bit_identical_to_jax(seed):
    """Several batches with late rows (past the 20 s lateness), overflow
    keys (-1) and keys past the plane, invalid rows and int32 sums that
    wrap; a flush of the closed buckets every third batch; the drain."""
    rng = np.random.default_rng(seed)
    K, B = 7, 256
    jd, td = _pair(num_keys=K, window_slots=8, lateness_ms=20_000)
    a, b = jd.init_state(), td.init_state()
    emitted = 0
    for i in range(12):
        cols = _batch(rng, B, K, 100_000 + 5_000 * i, late=30_000)
        a = jd.step(a, *cols)
        b = td.step(b, *cols)
        same_state(a, b)
        if i % 3 == 2:
            ra, a = jd.flush_closed(a)
            rb, b = td.flush_closed(b)
            assert rb == ra
            emitted += len(ra)
            same_state(a, b)
    assert emitted > 0 and int(b.dropped) > 0
    ra, a = jd.flush_closed(a, drain=True)
    rb, b = td.flush_closed(b, drain=True)
    assert rb == ra and len(ra) > 0
    same_state(a, b)
    assert td.flush_closed(b, drain=True) == ([], b)


def test_kernel_matches_numpy_oracle():
    rng = np.random.default_rng(5)
    K, B, NB = 7, 256, 6
    _, td = _pair(num_keys=K, window_slots=8, lateness_ms=20_000)
    state = td.init_state()
    want: dict = {}
    for b in range(NB):
        key = rng.integers(0, K, B).astype(np.int32)
        t = (100_000 + b * 5000 + rng.integers(0, 5000, B)).astype(np.int32)
        clicks = rng.integers(1, 5, B).astype(np.int32)
        lat = rng.integers(0, 1000, B).astype(np.int32)
        state = td.step(state, key, t, np.ones(B, bool),
                        {"clicks": clicks, "latency": lat})
        for k, tt, c, lt in zip(key.tolist(), t.tolist(), clicks.tolist(),
                                lat.tolist()):
            s, n, mx, mn = want.get((k, tt // 10_000),
                                    (0, 0, -(2**31) + 1, 2**31 - 1))
            want[(k, tt // 10_000)] = (s + c, n + 1, max(mx, lt), min(mn, lt))
    rows, state = td.flush_closed(state, drain=True)
    assert int(state.dropped) == 0
    got = {(k, w): (a["clicks:SUM"], a["clicks:COUNT"], a["latency:MAX"],
                    a["latency:MIN"]) for k, w, a in rows}
    assert got == want


def test_zero_valued_sum_rows_and_overflow_keys():
    schema = {"keys": [{"name": "k"}], "timeBuckets": ["10s"],
              "values": [{"name": "revenue", "aggregators": ["SUM"]}],
              "dimensions": [{"combination": ["k"]}]}
    jd, td = _pair(schema, num_keys=2, window_slots=4, lateness_ms=0)
    cols = (np.array([1, 1, -1], np.int32),
            np.array([10_000, 10_001, 10_002], np.int32),
            np.array([True, True, True]),
            {"revenue": np.array([0, 0, 5], np.int32)})
    a, b = jd.step(jd.init_state(), *cols), td.step(td.init_state(), *cols)
    same_state(a, b)
    assert int(b.dropped) == 1
    assert td.flush_closed(b, drain=True)[0] == [(1, 1, {"revenue:SUM": 0})]


def test_steps_update_the_planes_in_place():
    """By design the port's planes update in place (K1 adds in place): the
    returned state holds the same tensors, and a flush resets the closed
    slots in them."""
    _, td = _pair(num_keys=3, window_slots=4, lateness_ms=0)
    s0 = td.init_state()
    cols = (np.array([0, 2], np.int32), np.array([10_000, 25_000], np.int32),
            np.array([True, True]), {"clicks": np.ones(2, np.int32),
                                     "latency": np.ones(2, np.int32)})
    s1 = td.step(s0, *cols)
    assert s1.presence is s0.presence and all(
        x is y for x, y in zip(s1.aggs, s0.aggs))
    assert int(s0.presence.sum()) == 2
    rows, s2 = td.flush_closed(s1, drain=True)
    assert len(rows) == 2 and int(s0.presence.sum()) == 0
    assert s2.aggs[0].data_ptr() == s0.padded[0].data_ptr()


@pytest.mark.parametrize("seed", [3, 4])
def test_merge_equals_jax_and_the_single_fold(seed):
    rng = np.random.default_rng(seed)
    K, B = 5, 128
    jd, td = _pair(num_keys=K, window_slots=8, lateness_ms=20_000)
    key = rng.integers(0, K, 2 * B).astype(np.int32)
    t = (50_000 + rng.integers(0, 20_000, 2 * B)).astype(np.int32)
    clicks = rng.integers(1, 4, 2 * B).astype(np.int32)
    lat = rng.integers(0, 500, 2 * B).astype(np.int32)
    valid = np.ones(2 * B, bool)
    half = [(key[s], t[s], valid[s], {"clicks": clicks[s],
                                      "latency": lat[s]})
            for s in (slice(0, B), slice(B, None))]
    jm = jc.DimensionsComputation.merge(
        jd.step(jd.init_state(), *half[0]), jd.step(jd.init_state(),
                                                    *half[1]), jd.kinds)
    tm = tc.DimensionsComputation.merge(
        td.step(td.init_state(), *half[0]), td.step(td.init_state(),
                                                    *half[1]), td.kinds)
    same_state(jm, tm)
    whole = td.step(td.init_state(), key, t, valid,
                    {"clicks": clicks, "latency": lat})
    for x, y in zip(whole.aggs, tm.aggs):
        assert torch.equal(x, y)
    # the merged state folds and flushes on like any other
    more = _batch(rng, B, K, 60_000)
    jm, tm = jd.step(jm, *more), td.step(tm, *more)
    same_state(jm, tm)
    assert td.flush_closed(tm, drain=True)[0] == jd.flush_closed(
        jm, drain=True)[0]


def test_merge_rejects_divergent_ring_contents():
    jd, td = _pair(num_keys=3, window_slots=4, lateness_ms=20_000)
    key, valid = np.zeros(8, np.int32), np.ones(8, bool)
    vals = {"clicks": np.ones(8, np.int32), "latency": np.ones(8, np.int32)}
    t1 = (50_000 + np.arange(8, dtype=np.int32) * 4_000)
    t2 = (90_000 + np.arange(8, dtype=np.int32) * 4_000)
    with pytest.raises(ValueError) as want:
        jc.DimensionsComputation.merge(jd.step(jd.init_state(), key, t1,
                                               valid, vals),
                                       jd.step(jd.init_state(), key, t2,
                                               valid, vals), jd.kinds)
    h1 = td.step(td.init_state(), key, t1, valid, vals)
    with pytest.raises(ValueError, match="divergent ring contents") as got:
        tc.DimensionsComputation.merge(
            h1, td.step(td.init_state(), key, t2, valid, vals), td.kinds)
    assert str(got.value) == str(want.value)
    # empty slots merge freely: a fresh partial is always mergeable
    tc.DimensionsComputation.merge(h1, td.init_state(), td.kinds)


def test_computation_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.DimensionsComputation(ts.parse_schema(SCHEMA), num_keys=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DimensionApp(None, {"ad": "camp"}, "/nonexistent", ["camp"])


# ------------------------------------------------------ synthetic source
@pytest.mark.parametrize("kw", [
    dict(n_events=5000, batch=512, num_campaigns=10_000, key_capacity=256,
         seed=4),
    dict(n_events=3000, batch=512, num_campaigns=50, key_capacity=64,
         seed=9),
    dict(n_events=20_000, batch=4096, num_campaigns=1_000_000,
         key_capacity=1 << 14, seed=7, window_slots=4)],
    ids=["overflow", "exact", "wide"])
def test_run_synthetic_rows_equal_jax(kw):
    seed = kw.pop("seed")
    rows, interner, dropped = tsyn.run_synthetic(
        rng=random.Random(seed), device="cpu", **kw)
    jrows, jinterner, jdropped = jsyn.run_synthetic(rng=random.Random(seed),
                                                    **kw)
    assert rows == jrows and dropped == jdropped
    assert interner.index == jinterner.index
    assert interner.overflow == jinterner.overflow
    total = sum(a["clicks:SUM"] for _, _, a in rows)
    assert total + dropped == kw["n_events"]


# ------------------------------------------------------ the app end to end
FROZEN_NOW = 1_700_000_050_000


def _events(n=4000, bad=7, late=40):
    rng = random.Random(31)
    campaigns = gen.make_ids(10, rng)
    ads = gen.make_ids(100, rng)
    mapping = {a: campaigns[i % 10] for i, a in enumerate(ads)}
    src = gen.EventSource(ads=ads + gen.make_ids(5, rng),   # unknown ads
                          user_ids=gen.make_ids(5, rng),
                          page_ids=gen.make_ids(5, rng), rng=rng)
    base = 1_700_000_000_000
    lines = [e.encode() for e in src.events_at(base + 25 * i
                                               for i in range(n))]
    # rows past the lateness (dropped) and rows that do not parse
    lines += [e.encode() for e in src.events_at(base + 25 * i
                                                for i in range(late))]
    lines[100:100] = [b"not json"] * bad
    return mapping, campaigns, lines


def _stored(store) -> dict:
    return {key: {a: v for a, v in aggs.items() if not a.startswith("_")}
            for key, aggs in store.items()}


class _Published:
    def __init__(self):
        self.rows = []

    def publish(self, topic, data):
        self.rows.append((topic, data))
        return 0


@pytest.mark.parametrize("join", [True, False], ids=["join", "no_join"])
def test_app_end_to_end_equals_jax(tmp_path, monkeypatch, join):
    monkeypatch.setattr(app_mod, "now_ms", lambda: FROZEN_NOW)
    monkeypatch.setattr(jax_app_mod, "now_ms", lambda: FROZEN_NOW)
    mapping, campaigns, lines = _events()
    out = {}
    for name, cls, store_cls, kw in (
            ("torch", DimensionApp, DurableDimensionStore,
             {"device": "cpu"}),
            ("jax", jax_app_mod.DimensionApp, JaxStore, {})):
        pub = _Published()
        app = cls(None, mapping, str(tmp_path / name), campaigns=campaigns,
                  include_join=join, pubsub=pub, batch_size=512,
                  lateness_ms=10_000, **kw)
        for off in range(0, len(lines), 1000):
            app.process_lines(lines[off:off + 1000])
            app.flush()
        report = app.close()
        out[name] = (app.events, app.invalid_tuples, app.dropped,
                     _stored(store_cls(str(tmp_path / name))), pub.rows,
                     "latency report" in report)
    assert out["torch"] == out["jax"]
    events, invalid, dropped, stored, published, _ = out["torch"]
    assert invalid == 7 and events > 0 and stored and published
    if join:
        assert dropped > 0 and any(k == SENTINEL_CAMPAIGN for k, _ in stored)
    else:
        assert {k for k, _ in stored} == {SENTINEL_CAMPAIGN}
    lat = [v["latency:MAX"] for v in stored.values()]
    assert min(lat) == 0 and max(lat) > 0    # the clamp at 0, and real ones


# ------------------------------------------------------------------- CLI
def _stats(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_generate_matches_the_jax_cli(tmp_path, capsys, monkeypatch):
    for mod in (ids, jax_ids, app_mod, jax_app_mod):
        monkeypatch.setattr(mod, "now_ms", lambda: FROZEN_NOW)
    args = ["--generate", "20000", "--numCampaigns", "20"]
    assert jax_cli.main(args + ["--storeDir", str(tmp_path / "j")]) == 0
    want = _stats(capsys)
    assert cli.main(args + ["--storeDir", str(tmp_path / "t"),
                            "--device", "cpu"]) == 0
    got = _stats(capsys)
    assert got == want and got["events"] > 0 and got["stored_rows"] > 0
    assert (_stored(DurableDimensionStore(str(tmp_path / "t")))
            == _stored(JaxStore(str(tmp_path / "j"))))


@pytest.mark.parametrize("no_join", [False, True], ids=["join", "no_join"])
def test_cli_broker_mode_matches_the_jax_cli(tmp_path, capsys, monkeypatch,
                                            no_join):
    from streambench_tpu_torch.config import default_config
    from streambench_tpu_torch.io.journal import FileBroker

    for mod in (app_mod, jax_app_mod):
        monkeypatch.setattr(mod, "now_ms", lambda: FROZEN_NOW)
    cfg = default_config()
    gen.do_setup(None, cfg, broker=FileBroker(str(tmp_path / "broker")),
                 events_num=6000, rng=random.Random(3),
                 workdir=str(tmp_path))
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\n')
    args = ["--confPath", str(conf), "--workdir", str(tmp_path)]
    args += ["--noJoin"] if no_join else []
    assert jax_cli.main(args + ["--storeDir", str(tmp_path / "j")]) == 0
    want = _stats(capsys)
    assert cli.main(args + ["--storeDir", str(tmp_path / "t"),
                            "--device", "cpu"]) == 0
    got = _stats(capsys)
    assert got == want and got["events"] == 6000
    assert (_stored(DurableDimensionStore(str(tmp_path / "t")))
            == _stored(JaxStore(str(tmp_path / "j"))))


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--generate", "10", "--storeDir", str(tmp_path / "s")])


def test_the_package_exports_what_the_reference_exports():
    import streambench_tpu.dimensions as ref
    import streambench_tpu_torch.dimensions as port

    names = {n for n in vars(ref) if not n.startswith("_")
             and not isinstance(getattr(ref, n), type(ref))}
    assert names <= set(vars(port))
    assert port.AGGREGATORS == ref.AGGREGATORS
    assert port.SENTINEL_CAMPAIGN == ref.SENTINEL_CAMPAIGN
