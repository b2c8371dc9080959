"""The port's engine with the observability layer attached, against the
JAX engine's, on the CPU.

One seeded journal at config #1's key space (small batches) goes through
the JAX ``AdAnalyticsEngine`` + ``StreamRunner.run_catchup`` and through
the port's on ``device="cpu"``, each with a registry, the window
lifecycle, the occupancy sampler and the transfer ledger attached.  The
host-side telemetry must agree key by key, the lifecycle must see the
same written windows with all five segments each, the occupancy sampler
the same dispatches, and the transfer ledger the same payload bytes per
wire format (the JAX engine pads a partial scan group to a power of two
with empty batches, the port does not: there its bytes are the JAX
engine's less whole pad batches).  The persistent state's bytes agree at
config #1 and at a narrowed config #5 key space, and the host watermark
mirror restores from snapshots as the reference's does.
"""

import os

import numpy as np
import pytest
import torch

from streambench_tpu import obs as jax_obs
from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.engine import AdAnalyticsEngine as JaxEngine
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.engine import pipeline as jax_pipeline
from streambench_tpu.io.fakeredis import make_store as jax_make_store
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu.obs import devmem as jax_devmem
from streambench_tpu.ops import windowcount as jax_wc
from streambench_tpu_torch import obs as port_obs
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.engine import pipeline as port_pipeline
from streambench_tpu_torch.io.fakeredis import make_store
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import as_redis, seed_campaigns
from streambench_tpu_torch.obs import devmem as port_devmem
from streambench_tpu_torch.ops import windowcount as port_wc
from tests.test_torch_engine import TOPIC, write_journal

torch.set_num_threads(1)

NOW_MS = 1_900_000_000_000     # the telemetry's wall clock, pinned


SIDES = {
    "jax": dict(obs=jax_obs, config=jax_default_config, engine=JaxEngine,
                runner=JaxRunner, broker=JaxBroker, store=jax_make_store,
                as_redis=jax_as_redis, seed=jax_seed, kw={},
                pipeline=jax_pipeline),
    "port": dict(obs=port_obs, config=default_config,
                 engine=AdAnalyticsEngine, runner=StreamRunner,
                 broker=FileBroker, store=make_store, as_redis=as_redis,
                 seed=seed_campaigns, kw={"device": "cpu"},
                 pipeline=port_pipeline),
}


def run_side(side, workdir, campaigns, mapping, overrides, monkeypatch):
    """A catchup with obs attached; what the comparison reads."""
    s = SIDES[side]
    monkeypatch.setattr(s["pipeline"], "now_ms", lambda: NOW_MS)
    cfg = s["config"](kafka_topic=TOPIC, **overrides)
    r = s["as_redis"](s["store"]())
    s["seed"](r, campaigns)
    engine = s["engine"](cfg, mapping, campaigns=campaigns, redis=r,
                         **s["kw"])
    o = s["obs"]
    reg = o.MetricsRegistry()
    occ = o.OccupancySampler(reg, sample_every=4, watch_compiles=False)
    xfer = o.TransferLedger(reg, sample_every=0)
    engine.attach_obs(reg, lifecycle=True, occupancy=occ, xfer=xfer)
    lc = engine._obs_lifecycle
    written = []
    note_written = lc.note_written

    def record(window_ts, stamp):
        written.extend(int(t) for t in window_ts)
        note_written(window_ts, stamp)

    lc.note_written = record
    reader = s["broker"](os.path.join(workdir, "broker")).reader(TOPIC)
    stats = s["runner"](engine, reader).run_catchup()
    engine.drain_writes()
    out = {
        "events": stats.events,
        "telemetry": engine.telemetry(),
        "host_wm": engine._host_wm,
        "oldest_open": engine._oldest_open_span_start(),
        "lifecycle": lc.summary(),
        "written": written,
        "occupancy": occ.summary(),
        "xfer": xfer.summary(),
    }
    engine.close()
    reader.close()
    occ.close()
    return out


# stock: every 8192-row batch outspans the ring and folds as halved
# steps; 1 ms spacing with K = 1: steps with a partial last batch; with
# K = 4: stacked scan groups, the last ones partial
@pytest.mark.parametrize("spacing_ms,events,overrides", [
    (10, 30_000, {}),
    (1, 6_000, {"jax_batch_size": 512, "jax_scan_batches": 1}),
    (1, 12_000, {"jax_batch_size": 512, "jax_scan_batches": 4}),
], ids=["stock_halved_steps", "steps", "scan_groups"])
def test_obs_attached_engines_agree(tmp_path, monkeypatch, spacing_ms,
                                    events, overrides):
    workdir = str(tmp_path)
    campaigns = write_journal(workdir, events, spacing_ms, seed=21)
    mapping = gen.load_ad_mapping_file(
        os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE))
    ref, port = (run_side(side, workdir, campaigns, mapping, overrides,
                          monkeypatch) for side in ("jax", "port"))
    assert port["events"] == ref["events"] == events

    # telemetry, key by key (the wall clock pinned)
    assert port["telemetry"] == ref["telemetry"]
    assert port["telemetry"]["watermark_lag_ms"] == NOW_MS - port["host_wm"]
    assert port["host_wm"] == ref["host_wm"]
    assert port["oldest_open"] == ref["oldest_open"]

    # the same written windows, each with all five segments
    assert sorted(port["written"]) == sorted(ref["written"])
    lc, rlc = port["lifecycle"], ref["lifecycle"]
    n = lc["writes_observed"]
    assert n == rlc["writes_observed"] > 0
    assert lc["writes_untracked"] == rlc["writes_untracked"] == 0
    assert lc["e2e_ms"]["count"] == n
    assert {k: v["count"] for k, v in lc["segments"].items()} == {
        k: n for k in ("ingest", "encode", "fold", "flush", "sink")}

    # the same dispatches, sampled alike
    for key in ("dispatches", "sampled", "sample_every"):
        assert port["occupancy"][key] == ref["occupancy"][key]
    assert port["occupancy"]["dispatches"] > 0

    # the same payload bytes per wire format
    pf = port["xfer"]["formats"]["packed"]
    rf = ref["xfer"]["formats"]["packed"]
    assert set(port["xfer"]["formats"]) == set(ref["xfer"]["formats"])
    assert pf["dispatches"] == rf["dispatches"]
    assert pf["events"] == rf["events"] == events
    assert pf["bytes_per_row"] == 8.0
    B = overrides.get("jax_batch_size", 8192)
    if overrides.get("jax_scan_batches", 8) == 1 or spacing_ms == 10:
        # steps only (the stock batches are halved): nothing is padded
        assert pf["wire_bytes"] == rf["wire_bytes"]
        assert pf["col_bytes"] == rf["col_bytes"]
    else:
        pad = rf["wire_bytes"] - pf["wire_bytes"]
        assert pad >= 0 and pad % (8 * B) == 0
        assert pf["rows"] * 8 == pf["wire_bytes"]


@pytest.mark.parametrize("campaigns,slots", [(100, 16), (20_000, 64)],
                         ids=["config1", "config5_narrowed"])
def test_state_bytes_agree(campaigns, slots):
    mapping = {f"ad{i}": f"c{i}" for i in range(campaigns)}
    names = [f"c{i}" for i in range(campaigns)]
    ref = JaxEngine(jax_default_config(jax_window_slots=slots), mapping,
                    campaigns=names)
    port = AdAnalyticsEngine(default_config(jax_window_slots=slots),
                             mapping, campaigns=names, device="cpu")
    want = campaigns * slots * 4 + slots * 4 + 4 + 4
    assert jax_devmem.state_nbytes(ref.state) == want
    assert port_devmem.state_nbytes(port.state) == want
    led = port_obs.DeviceMemoryLedger()
    rep = led.analyze_engine(port)
    assert rep["state_bytes"] == want
    assert rep["kernels"] == {}        # the CPU count launches no kernel


@pytest.mark.parametrize("side", ["jax", "port"])
def test_restore_watermark_sentinel_states(side):
    """``_restore_host`` gates the host watermark mirror on the NEG
    sentinel, not truthiness: a relative watermark of 0 is SET (host_wm
    = base), the NEG 'no events' value and a pre-first-event base are
    UNSET (None).  Ported from the reference's test of the same name."""
    s = SIDES[side]
    neg = (jax_wc if side == "jax" else port_wc).NEG
    assert neg == jax_wc.NEG
    cfg = s["config"](jax_batch_size=64)
    mapping = {"ad0": "c0", "ad1": "c1"}
    eng = s["engine"](cfg, mapping, **s["kw"])
    base = 1_000_000

    def restored(watermark, base_time_ms=base):
        snap = eng.snapshot(0)
        snap.watermark = watermark
        snap.meta["base_time_ms"] = base_time_ms
        dst = s["engine"](cfg, mapping, **s["kw"])
        dst.restore(snap)
        return dst._host_wm

    assert restored(0) == base              # legit zero watermark: SET
    assert restored(12_345) == base + 12_345
    assert restored(neg) is None            # 'no events' sentinel: unset
    assert restored(0, base_time_ms=None) is None  # pre-first-event snap


def test_snapshot_carries_the_watermark_mirror_across_engines(tmp_path):
    """A port snapshot restored into the JAX engine and back gives both
    the same host watermark and oldest-open window."""
    workdir = str(tmp_path)
    campaigns = write_journal(workdir, 3_000, 10, seed=22)
    mapping = gen.load_ad_mapping_file(
        os.path.join(workdir, gen.AD_TO_CAMPAIGN_FILE))
    port = AdAnalyticsEngine(default_config(kafka_topic=TOPIC,
                                            jax_batch_size=512),
                             mapping, campaigns=campaigns, device="cpu")
    reader = FileBroker(os.path.join(workdir, "broker")).reader(TOPIC)
    StreamRunner(port, reader).run_catchup()
    reader.close()
    snap = port.snapshot(0)
    ref = JaxEngine(jax_default_config(kafka_topic=TOPIC,
                                       jax_batch_size=512),
                    mapping, campaigns=campaigns)
    ref.restore(snap)
    assert ref._host_wm == port._host_wm is not None
    assert ref._oldest_open_span_start() == port._oldest_open_span_start()
    assert int(np.asarray(snap.watermark)) + snap.meta["base_time_ms"] \
        == port._host_wm
