"""Device decode in the port (``ops.devdecode``, ``ops.decode``) against
the JAX package's ``ops/devdecode.py``, on the CPU.

The same bytes, made from fixed seeds, go through each JAX function and
its port: the host probe (native and numpy), the join table, the decode
(K2's plain version against ``_decode_columns``, exact on valid rows),
and the decode + fold (the state bit for bit).  End to end, the port's
engine with ``jax.decode.device`` on gives the JAX engine's counts,
dropped count, bad lines and dead-letter journal on an adversarial
block, and the generator's oracle on generated journals, serial and
pipelined, through a small ring and across a checkpoint.  Every value is
an integer, so every comparison is exact (tolerance 0).
"""

import dataclasses
import os
import random
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.encode.encoder import EventEncoder as JaxEncoder
from streambench_tpu.engine import AdAnalyticsEngine as JaxEngine
from streambench_tpu.io.journal import JournalWriter as JaxJournalWriter
from streambench_tpu.ops import devdecode as jdd
from streambench_tpu.ops import windowcount as jwc
from streambench_tpu_torch import native
from streambench_tpu_torch.checkpoint import Checkpointer
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.encode.encoder import EventEncoder
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.io.fakeredis import FakeRedisStore
from streambench_tpu_torch.io.journal import FileBroker, JournalWriter
from streambench_tpu_torch.io.redis_schema import as_redis, seed_campaigns
from streambench_tpu_torch.ops import _build
from streambench_tpu_torch.ops import decode as tdec
from streambench_tpu_torch.ops import devdecode as tdd
from streambench_tpu_torch.ops import methodbench
from streambench_tpu_torch.ops import windowcount as twc
from streambench_tpu_torch.utils.build import BuildError

torch.set_num_threads(1)

T0 = 1_722_700_000_000


def _mk_mapping(rng, n_campaigns=5, ads_per=3):
    campaigns = gen.make_ids(n_campaigns, rng)
    ads = gen.make_ids(n_campaigns * ads_per, rng)
    return {ad: campaigns[i // ads_per] for i, ad in enumerate(ads)}


def _event(rng, ads, t, event_type="view", ad=None, ad_type="banner"):
    return (
        '{"user_id": "%s", "page_id": "%s", "ad_id": "%s", '
        '"ad_type": "%s", "event_type": "%s", "event_time": "%d", '
        '"ip_address": "1.2.3.4"}'
        % (str(uuid.UUID(int=rng.getrandbits(128), version=4)),
           str(uuid.UUID(int=rng.getrandbits(128), version=4)),
           ad if ad is not None else rng.choice(ads), ad_type,
           event_type, t)).encode()


def _adversarial_block(rng, ads, t0=T0):
    """A journal block with every fallback class next to normal rows (the
    reference test's block)."""
    lines = [
        _event(rng, ads, t0),                       # plain view
        b"not json at all",                         # malformed -> DLQ
        _event(rng, ads, t0 + 5, "click"),          # filtered, valid
        b'{"event_time": "oops"}',                  # malformed -> DLQ
        _event(rng, ads, t0 + 11, "purchase"),
        # unseen ad id: valid row, campaign -1, not dead-lettered
        _event(rng, ads, t0 + 20, ad=str(uuid.UUID(
            int=rng.getrandbits(128), version=4))),
        # re-ordered keys: valid JSON, the host slow path parses it
        ('{"event_time": "%d", "ad_id": "%s", "event_type": "view", '
         '"user_id": "u", "page_id": "p", "ad_type": "modal"}'
         % (t0 + 30, ads[0])).encode(),
        # short (non-13-digit) timestamp: out of the rebased int32 range
        _event(rng, ads, 12345),
        _event(rng, ads, t0 + 40, "hover"),         # unknown type
        # long ad_type value (still quote-free): decodes on the device
        _event(rng, ads, t0 + 52, ad_type="sponsored-search"),
        _event(rng, ads, t0 + 60),
        b"",                                        # blank -> DLQ
        _event(rng, ads, t0 + 70),
    ]
    return b"\n".join(lines) + b"\n"


def _layout_breaks(rng, ads):
    good = _event(rng, ads, T0)
    return [good] + [
        good.replace(b'"user_id"', b'"user_xx"'),      # key literal
        good.replace(b'"ip_address": "1.2.3.4"',
                     b'"ip_address": "9.9.9.9"'),      # suffix literal
        good.replace(b'"event_type": "view"',
                     b'"event_type": "hover"'),        # unknown type
        good[:40] + b'"' + good[41:],                  # quote in uuid
        good.replace(b'"ad_type": "banner"',
                     b'"ad_type": "ban\\"er"'),        # quote in ad_type
        good[:-5] + b'x' + good[-4:],                  # broken suffix
        good.replace(b'"%d"' % T0, b'"%dx"' % (T0 // 10)),  # digit
    ]


# ----------------------------------------------------------------------
# the probe and the join table
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 8])
@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_probe_matches_jax_probe_on_adversarial_blocks(seed, impl):
    rng = random.Random(seed)
    mapping = _mk_mapping(rng)
    ads = list(mapping)
    data = (_adversarial_block(rng, ads)
            + b"\n".join(_layout_breaks(rng, ads)) + b"\n"
            + b'{"user_id": "torn')                 # torn tail: not scanned
    if impl == "native":
        assert native.load() is not None
    want = jdd.probe_block(data, native=False)
    got = tdd.probe_block(data, native=impl == "native")
    for a, b, name in zip(want, got, ("starts", "lens", "times", "ok")):
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    assert int(got[3].sum()) >= 8
    # numpy arrays in, as bytes in
    arr = np.frombuffer(data, np.uint8)
    for a, b in zip(want, tdd.probe_block(arr, native=impl == "native")):
        assert np.array_equal(a, b)


def test_probe_rejects_each_layout_break():
    rng = random.Random(9)
    rows = _layout_breaks(rng, list(_mk_mapping(rng)))
    block = b"\n".join(rows) + b"\n"
    for impl in (False, None):
        starts, lens, times, ok = tdd.probe_block(block, native=impl)
        assert ok.tolist() == [True] + [False] * (len(rows) - 1), impl
        assert int(times[0]) == T0


@pytest.mark.parametrize("n_campaigns,ads_per", [(11, 7), (100, 10)])
def test_ad_table_identical_to_jax(n_campaigns, ads_per):
    rng = random.Random(21)
    mapping = _mk_mapping(rng, n_campaigns, ads_per)
    enc, jenc = EventEncoder(mapping), JaxEncoder(mapping)
    got = tdd.build_ad_table([a.encode() for a in enc.ads],
                             enc.join_table[:-1])
    want = jdd.build_ad_table([a.encode() for a in jenc.ads],
                              jenc.join_table[:-1])
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2] == want[2] >= 1
    assert tdd.fnv1a32(b"x" * 36) == jdd.fnv1a32(b"x" * 36)
    for name in ("UUID_LEN", "AD_OFF", "ADTYPE_OFF", "TIME_DIGITS",
                 "SUF_OFF", "DIG_OFF", "TM_OFF", "MIN_ROW", "FNV_OFFSET",
                 "FNV_PRIME", "HEAD", "SUFFIX", "LIT_TM", "LIT_ET"):
        assert getattr(tdec, name) == getattr(jdd, name), name


def test_ad_table_rejects_non_uuid_ads():
    with pytest.raises(ValueError, match="36-byte"):
        tdd.build_ad_table([b"short"], np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="non-empty"):
        tdd.build_ad_table([], np.zeros(0, np.int32))


# ----------------------------------------------------------------------
# the decode: K2's plain version against _decode_columns
# ----------------------------------------------------------------------

def _decode_case(seed, n_ads, probes_at_least=1):
    """A padded buffer of generator-format rows (every event type, unknown
    ads, times on both sides of a 10^9 boundary) plus pad rows, the join
    table, and the base split at 10^9."""
    rng = random.Random(seed)
    mapping = _mk_mapping(rng, max(n_ads // 3, 1), 3)
    enc = EventEncoder(mapping)
    keys, vals, probes = tdd.build_ad_table([a.encode() for a in enc.ads],
                                            enc.join_table[:-1])
    assert probes >= probes_at_least
    ads = list(mapping)
    boundary = 1_723_000_000_000          # a multiple of 10^9
    rows = []
    for i in range(300):
        et = ("view", "click", "purchase")[i % 3]
        ad = (str(uuid.UUID(int=rng.getrandbits(128), version=4))
              if i % 7 == 0 else rng.choice(ads))
        t = boundary + rng.randint(-5_000, 5_000)
        rows.append(_event(rng, ads, t, et, ad=ad,
                           ad_type=rng.choice(["banner", "modal", "x"])))
    data = b"\n".join(rows) + b"\n"
    starts, lens, times, ok = tdd.probe_block(data)
    assert ok.all()
    base = boundary - 70_000
    cap = 1 << (len(data) - 1).bit_length()
    buf = np.zeros(cap, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    # pad rows (len 0) among the real ones, as a padded dispatch has
    pad = np.zeros(20, np.int32)
    starts = np.concatenate([starts, pad]).astype(np.int32)
    lens = np.concatenate([lens, pad]).astype(np.int32)
    return buf, starts, lens, keys, vals, probes, base, times


def _table_with_probes(min_probes):
    """A table whose probe bound is at least ``min_probes``: search seeds
    until linear probing chains that far."""
    for seed in range(200):
        rng = random.Random(seed)
        mapping = _mk_mapping(rng, 40, 3)
        enc = EventEncoder(mapping)
        table = tdd.build_ad_table([a.encode() for a in enc.ads],
                                   enc.join_table[:-1])
        if table[2] >= min_probes:
            return seed
    raise AssertionError("no table chains that far")


@pytest.mark.parametrize("seed,n_ads,min_probes", [
    (1, 30, 1), (2, 300, 1), (_table_with_probes(3), 120, 3)],
    ids=["30_ads", "300_ads", "3_probes"])
def test_decode_rows_plain_matches_decode_columns(seed, n_ads, min_probes):
    buf, starts, lens, keys, vals, probes, base, times = _decode_case(
        seed, n_ads, min_probes)
    base_hi, base_lo = base // 1_000_000_000, base % 1_000_000_000
    want = jdd._decode_columns(
        jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(keys), jnp.asarray(vals), jnp.int32(base_hi),
        jnp.int32(base_lo), probes)
    got = tdec.decode_rows(
        torch.from_numpy(buf), torch.from_numpy(starts),
        torch.from_numpy(lens), torch.from_numpy(keys),
        torch.from_numpy(vals), probes, base_hi, base_lo)
    valid = np.asarray(want[3])
    assert np.array_equal(valid, got[3].numpy())
    for name, a, b in zip(("campaign", "is_view", "rel"), want[:3], got[:3]):
        assert np.array_equal(np.asarray(a)[valid], b.numpy()[valid]), name
    # the times are the probe's, rebased; some rows are unknown ads
    real = lens > 0
    assert np.array_equal(got[2].numpy()[real], times - base)
    assert (got[0].numpy()[real] == -1).any()
    assert got[1].numpy()[real].any() and not got[1].numpy()[real].all()
    # pad rows: the fixed values of both the kernel and its plain version
    assert (got[0].numpy()[~real] == -1).all()
    assert not got[1].numpy()[~real].any()
    assert (got[2].numpy()[~real] == 0).all()


def test_decode_rows_time_wraps_as_int32_like_jax():
    """A time 3 * 10^9 ms past the base leaves int32 in the reference's
    product; both wrap it alike (the probe never ships such a row)."""
    buf, starts, lens, keys, vals, probes, base, _ = _decode_case(4, 30)
    for base_hi, base_lo in ((base // 10**9 - 3, 999_999_999),
                             (base // 10**9 + 5, 0)):
        want = jdd._decode_columns(
            jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(lens),
            jnp.asarray(keys), jnp.asarray(vals), jnp.int32(base_hi),
            jnp.int32(base_lo), probes)
        got = tdec.decode_rows_plain(
            torch.from_numpy(buf), torch.from_numpy(starts),
            torch.from_numpy(lens), torch.from_numpy(keys),
            torch.from_numpy(vals), probes, base_hi, base_lo)
        valid = np.asarray(want[3])
        assert np.array_equal(np.asarray(want[2])[valid],
                              got[2].numpy()[valid])


def test_decode_rows_keeps_shape_and_checks_its_inputs():
    buf, starts, lens, keys, vals, probes, base, _ = _decode_case(5, 30)
    args = [torch.from_numpy(a) for a in (buf, starts[:300], lens[:300],
                                          keys, vals)]
    flat = tdec.decode_rows(*args, probes, 1, 2)
    two = tdec.decode_rows(args[0], args[1].view(3, 100),
                           args[2].view(3, 100), *args[3:], probes, 1, 2)
    for a, b in zip(flat, two):
        assert b.shape == (3, 100) and torch.equal(a, b.reshape(-1))
    with pytest.raises(ValueError, match="buf must be"):
        tdec.decode_rows(args[0].int(), *args[1:], probes, 1, 2)
    with pytest.raises(ValueError, match="differ in shape"):
        tdec.decode_rows(args[0], args[1], args[2][:-1], *args[3:],
                         probes, 1, 2)
    with pytest.raises(ValueError, match="power of two"):
        tdec.decode_rows(*args[:3], args[3][:-1], args[4][:-1], probes,
                         1, 2)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tdec.decode_rows(*(a.to("meta") for a in args), probes, 1, 2)


def test_cuda_launch_raises_and_counts_nothing_when_the_library_fails(
        monkeypatch):
    """On a CUDA tensor the wrapper launches or raises: a refused launch
    (a non-zero CUDA error) and a library that cannot be built both
    raise, nothing falls back to the plain version, and only a launch
    that was made counts."""
    buf, starts, lens, keys, vals, probes, base, _ = _decode_case(6, 30)
    meta = tdec.slot_meta(keys, vals, vals >= 0).view(np.int32)
    args = [torch.from_numpy(a) for a in (buf, starts, lens, keys, meta)]
    outs = (torch.empty(starts.shape, dtype=torch.int32),
            torch.empty(starts.shape, dtype=torch.bool),
            torch.empty(starts.shape, dtype=torch.int32),
            torch.empty(starts.shape, dtype=torch.bool))
    plan = tdec._PlanArgs(1, 64, 1, tdec.meta_bytes(keys.shape[0]), 1)
    calls = []

    class Lib:
        def __init__(self, rc):
            self.rc = rc

        def sb_decode_rows(self, *a):
            calls.append(a)
            return self.rc

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    before = tdec.decode_rows.launches
    monkeypatch.setattr(_build, "decode_rows_lib", lambda: Lib(209))
    with pytest.raises(RuntimeError, match="CUDA error 209"):
        tdec._launch(*args, probes, 1, 2, outs, 0, plan)
    assert tdec.decode_rows.launches == before

    def no_nvcc():
        raise BuildError("nvcc failed")

    monkeypatch.setattr(_build, "decode_rows_lib", no_nvcc)
    with pytest.raises(BuildError):
        tdec._launch(*args, probes, 1, 2, outs, 0, plan)
    assert tdec.decode_rows.launches == before

    monkeypatch.setattr(_build, "decode_rows_lib", lambda: Lib(0))
    tdec._launch(*args, probes, 1, 2, outs, 0, plan)
    assert tdec.decode_rows.launches == before + 1
    # rows, table size and probes reach the kernel as ints
    assert calls[-1][4] == starts.size and calls[-1][7] == keys.shape[0]
    assert calls[-1][8] == probes


def test_decode_build_targets_hopper_and_stays_lazy(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build._nvcc(_build.DECODE_ROWS_SRC)("out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith(os.path.join("csrc", "decode_rows.cu"))
    assert _build.decode_rows_lib.lib is None


# ----------------------------------------------------------------------
# the decode + fold against decode_fold_scan
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tm,jm", [("scatter", "scatter"),
                                   ("kernel", "pallas"),
                                   ("matmul", "matmul")])
def test_decode_fold_scan_state_matches_jax(tm, jm):
    buf, starts, lens, keys, vals, probes, base, _ = _decode_case(7, 60)
    B = 64
    R = starts.size
    kp = 1 << (-(-R // B) - 1).bit_length()
    s = np.zeros(kp * B, np.int32)
    l = np.zeros(kp * B, np.int32)
    s[:R], l[:R] = starts, lens
    base_hi, base_lo = base // 1_000_000_000, base % 1_000_000_000
    C, W = 5, 16
    jstate = jwc.init_state(C, W)
    tstate = twc.init_state(C, W)
    for _ in range(2):                    # a second pass over the same rows
        jstate = jdd.decode_fold_scan(
            jstate, jnp.asarray(buf), jnp.asarray(s.reshape(kp, B)),
            jnp.asarray(l.reshape(kp, B)), jnp.asarray(keys),
            jnp.asarray(vals), jnp.int32(base_hi), jnp.int32(base_lo),
            divisor_ms=10_000, lateness_ms=60_000, method=jm,
            probes=probes)
        tstate = tdd.decode_fold_scan(
            tstate, torch.from_numpy(buf),
            torch.from_numpy(s.reshape(kp, B)),
            torch.from_numpy(l.reshape(kp, B)), torch.from_numpy(keys),
            torch.from_numpy(vals), base_hi, base_lo, divisor_ms=10_000,
            lateness_ms=60_000, method=tm, probes=probes)
    for name, a, b in zip(jwc.WindowState._fields, jstate, tstate):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    assert int(tstate.counts.sum()) > 0


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

ARMS = ("device", "native", "python")


def _arm_cfg(arm, jax=False, **over):
    cfg = (jax_default_config if jax else default_config)(
        jax_batch_size=256, jax_scan_batches=2, **over)
    if arm == "device":
        return dataclasses.replace(cfg, jax_decode_device="on")
    if arm == "python":
        return dataclasses.replace(cfg, jax_use_native_encoder=False)
    return cfg


def _accounting(arm, mapping, data, tmp_path, jax=False):
    cfg = _arm_cfg(arm, jax)
    d = tmp_path / f"dlq-{'jax' if jax else 'torch'}-{arm}"
    d.mkdir()
    if jax:
        eng = JaxEngine(cfg, mapping)
        dlq = JaxJournalWriter(os.path.join(d, "dlq.txt"))
    else:
        eng = AdAnalyticsEngine(cfg, mapping, device="cpu")
        dlq = JournalWriter(os.path.join(d, "dlq.txt"))
    eng.encoder.set_deadletter(dlq)
    eng.process_block(data)
    eng.flush(final=True)
    dlq.close()
    if arm == "device":
        assert eng._devdecode is not None and eng._devdecode.rows_decoded
    path = d / "dlq.txt"
    return {"counts": eng.pending_counts(), "dropped": int(eng.dropped),
            "bad_lines": eng.encoder.bad_lines,
            "dlq": sorted((path.read_bytes() if path.exists()
                           else b"").splitlines()),
            "events": eng.events_processed}


def test_adversarial_block_every_port_arm_equals_jax_device_arm(tmp_path):
    rng = random.Random(11)
    mapping = _mk_mapping(rng)
    data = _adversarial_block(rng, list(mapping))
    want = _accounting("device", mapping, data, tmp_path, jax=True)
    assert want["bad_lines"] == 4 and want["dlq"]
    for arm in ARMS:
        assert _accounting(arm, mapping, data, tmp_path) == want, arm


def _generated(tmp_path, events, seed, **over):
    cfg = default_config(**over)
    broker = FileBroker(str(tmp_path / "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=events,
                 rng=random.Random(seed), workdir=str(tmp_path))
    mapping = gen.load_ad_mapping_file(
        str(tmp_path / gen.AD_TO_CAMPAIGN_FILE))
    return cfg, broker, mapping


def _store(mapping):
    r = as_redis(FakeRedisStore())
    seed_campaigns(r, sorted(set(mapping.values())))
    return r


def _oracle_exact(r, tmp_path):
    correct, differ, missing = gen.check_correct(
        r, workdir=str(tmp_path), log=lambda s: None)
    assert (differ, missing) == (0, 0) and correct > 0


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_generator_journal_oracle_equality(tmp_path, pipeline):
    """A generated journal through the runner's block path with decode on,
    serial and pipelined: every row decoded on the device, none falls
    back, and every window passes the oracle."""
    cfg, broker, mapping = _generated(tmp_path, 12_000, 5,
                                      jax_batch_size=512,
                                      jax_scan_batches=2)
    r = _store(mapping)
    eng = AdAnalyticsEngine(
        dataclasses.replace(cfg, jax_decode_device="on"), mapping,
        redis=r, device="cpu")
    with broker.reader(cfg.kafka_topic) as reader:
        runner = StreamRunner(eng, reader, ingest_pipeline=pipeline)
        stats = runner.run_catchup()
        tel = (runner._pipeline.telemetry() if pipeline == "on"
               else eng.telemetry())
        eng.close()
    assert stats.events == 12_000 and eng.dropped == 0
    dd = eng._devdecode.telemetry()
    assert dd["rows_decoded"] == 12_000 and dd["rows_fallback"] == 0
    assert tel["device_decode"]["rows_decoded"] == 12_000
    assert "device_decode" in eng.tracer.as_dict()
    assert "decode_probe" in eng.tracer.as_dict()
    _oracle_exact(r, tmp_path)


def test_line_mode_rejoins_into_device_blocks(tmp_path):
    """Line-mode ingest (the paced readers' path) with decode on: the
    lines rejoin into one block and decode on the device."""
    cfg, broker, mapping = _generated(tmp_path, 3_000, 6,
                                      jax_batch_size=256)
    r = _store(mapping)
    eng = AdAnalyticsEngine(
        dataclasses.replace(cfg, jax_decode_device="on"), mapping,
        redis=r, device="cpu")
    with broker.reader(cfg.kafka_topic) as reader:
        while True:
            lines = reader.poll(max_records=700)
            if not lines:
                break
            eng.process_chunk(lines)
    eng.close()
    assert eng._devdecode.rows_decoded == 3_000
    _oracle_exact(r, tmp_path)


def test_small_ring_span_guard_still_exact(tmp_path):
    """A ring far smaller than the journal's span forces mid-run drains
    and block halving through the device path; counts stay exact."""
    cfg, broker, mapping = _generated(
        tmp_path, 8_000, 13, jax_batch_size=128, jax_scan_batches=2,
        jax_window_slots=16, jax_allowed_lateness_ms=10_000)
    r = _store(mapping)
    eng = AdAnalyticsEngine(
        dataclasses.replace(cfg, jax_decode_device="on"), mapping,
        redis=r, device="cpu")
    with broker.reader(cfg.kafka_topic) as reader:
        StreamRunner(eng, reader).run_catchup()
    eng.close()
    assert eng._devdecode.rows_decoded == 8_000
    _oracle_exact(r, tmp_path)


def test_checkpoint_resume_with_device_decode(tmp_path):
    """A snapshot mid-journal with decode on: the resumed engine takes the
    encoder's base time from the snapshot (the snapshot path is the host
    encoder's, unchanged), and the final counts stay exact."""
    cfg, broker, mapping = _generated(
        tmp_path, 6_000, 17, jax_batch_size=256, jax_scan_batches=2,
        jax_checkpoint_interval_ms=0)
    cfg_on = dataclasses.replace(cfg, jax_decode_device="on")
    r = _store(mapping)
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    eng = AdAnalyticsEngine(cfg_on, mapping, redis=r, device="cpu")
    with broker.reader(cfg.kafka_topic) as reader:
        StreamRunner(eng, reader, checkpointer=ckpt).run_catchup(
            max_events=3_000)
    eng.drain_writes()
    base = eng.encoder.base_time_ms
    snap = ckpt.load()
    assert snap.meta["base_time_ms"] == base is not None
    eng2 = AdAnalyticsEngine(cfg_on, mapping, redis=r, device="cpu")
    assert eng2.encoder.base_time_ms is None
    with broker.reader(cfg.kafka_topic) as reader:
        runner2 = StreamRunner(eng2, reader, checkpointer=ckpt)
        assert runner2.resume()
        assert eng2.encoder.base_time_ms == base
        runner2.run_catchup()
    eng2.close()
    assert 0 < eng2._devdecode.rows_decoded < 6_000
    _oracle_exact(r, tmp_path)


def test_non_uuid_ads_fall_back_quietly(capsys):
    cfg = dataclasses.replace(default_config(), jax_decode_device="on")
    eng = AdAnalyticsEngine(cfg, {"short-ad": "c1", "other-ad": "c1"},
                            device="cpu")
    assert eng._devdecode is None     # the fixed 36-byte wire format only
    assert "falling back to host encode" in capsys.readouterr().err
    eng.process_block(b'{"bad": 1}\n')
    assert eng.encoder.bad_lines == 1


def test_config5_key_space_keeps_the_host_encode():
    """From the large-key-space drains' threshold on (config #5's 1e6 x 64
    plane is far past it) the touched-rows drains read host-side ad
    columns that device decode never builds: decode stays off, quietly.
    The smallest such plane here: 2^16 campaigns x 64 slots = 2^22
    cells."""
    rng = random.Random(2)
    mapping = _mk_mapping(rng, 1 << 16, 1)
    cfg = dataclasses.replace(default_config(jax_window_slots=64),
                              jax_decode_device="on")
    eng = AdAnalyticsEngine(cfg, mapping, device="cpu")
    assert eng.state.counts.numel() == eng.COMPACT_DRAIN_MIN_CELLS
    assert eng._track_dirty_rows() and eng._devdecode is None


def test_auto_mode_reads_the_port_cache(tmp_path, monkeypatch):
    """``auto`` follows the port's cached A/B winner of the ingest mode the
    runner resolves (serial and pipelined are measured apart), and nothing
    but the device type's default when that mode was not measured."""
    monkeypatch.setenv("STREAMBENCH_TORCH_METHOD_CACHE",
                       str(tmp_path / "cache.json"))
    # the JAX package's winner lives elsewhere and is never read
    monkeypatch.setenv("STREAMBENCH_METHOD_CACHE",
                       str(tmp_path / "jax_cache.json"))
    for pipelined in (False, True):
        assert tdd.auto_enabled("cpu", pipelined) is False
        assert tdd.auto_enabled("cuda", pipelined) is True
    assert tdd.ab_key("cuda", True) == "cuda/devdecode/pipelined"
    methodbench.record("cpu/devdecode/serial", {"winner": "device"})
    assert tdd.auto_enabled("cpu", False) is True
    assert tdd.auto_enabled("cpu", True) is False
    methodbench.record("cuda/devdecode/pipelined", {"winner": "host"})
    assert tdd.auto_enabled("cuda", True) is False
    assert tdd.auto_enabled("cuda", False) is True
    rng = random.Random(4)
    mapping = _mk_mapping(rng)
    cfg = dataclasses.replace(default_config(), jax_decode_device="auto")
    eng = AdAnalyticsEngine(cfg, mapping, device="cpu")
    assert eng._devdecode is not None           # serial until settled
    broker = FileBroker(str(tmp_path / "broker"))
    broker.create_topic(cfg.kafka_topic)
    with broker.reader(cfg.kafka_topic) as reader:
        StreamRunner(eng, reader, ingest_pipeline="on")
        assert eng._devdecode is None
        StreamRunner(eng, reader, ingest_pipeline="off")
        assert eng._devdecode is not None
    methodbench.record("cpu/devdecode/serial", {"winner": "host"})
    assert AdAnalyticsEngine(cfg, mapping, device="cpu")._devdecode is None
    # "on" ignores the A/B
    on = dataclasses.replace(cfg, jax_decode_device="on")
    eng = AdAnalyticsEngine(on, mapping, device="cpu")
    eng.settle_decode(True)
    assert eng._devdecode is not None
    assert not (tmp_path / "jax_cache.json").exists()


def test_transfer_ledger_counts_every_block_buffer_once(monkeypatch):
    """The ``devdecode`` wire bytes hold each block's byte buffer once
    (span-guard halves share it) and each fold's (start, len) vectors,
    also when a block's buffer is freed before the next one is made (the
    allocator may then hand the next block the same address)."""
    from streambench_tpu_torch import obs

    rng = random.Random(8)
    mapping = _mk_mapping(rng)
    ads = list(mapping)
    cfg = dataclasses.replace(default_config(jax_batch_size=64),
                              jax_decode_device="on")
    eng = AdAnalyticsEngine(cfg, mapping, device="cpu")
    xfer = obs.TransferLedger(obs.MetricsRegistry(), sample_every=0)
    eng.attach_obs(obs.MetricsRegistry(), xfer=xfer)
    # a block that outspans the ring folds as halves sharing one buffer
    spans = (10, eng._span_guard)
    want = rows = 0
    for i, step in enumerate(spans * 4):
        data = b"".join(_event(rng, ads, T0 + 60_000 * i + step * k) + b"\n"
                        for k in range(40))
        assert eng.process_block(data) == 40
        want += len(data) + 40 * 8
        rows += 40
    got = xfer.summary()["formats"]["devdecode"]
    assert got["rows"] == rows
    assert got["wire_bytes"] == want
    eng.close()


def test_warmup_with_decode_leaves_state_unchanged():
    rng = random.Random(3)
    cfg = dataclasses.replace(default_config(jax_batch_size=64),
                              jax_decode_device="on")
    eng = AdAnalyticsEngine(cfg, _mk_mapping(rng), device="cpu")
    eng.warmup()
    counts, window_ids, watermark, dropped = eng.state
    assert not counts.any() and (window_ids == -1).all()
    assert int(watermark) == 0 and int(dropped) == 0
