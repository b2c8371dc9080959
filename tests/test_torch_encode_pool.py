"""The parallel encode pool of the port, against serial encode and the JAX
package.

``encode.parallel.ParallelEncodePool`` spreads one raw journal block (or
one chunk of lines) over per-thread native encoders that share the
primary's base time.  Its batches may be cut at other record boundaries
than the serial ``carve_block``'s, so what must be bit-identical is the
event stream they carry (every column of every valid row, in journal
order) and the windows it folds to: the same in the port with
``jax.encode.workers`` = 1, 2 and 4, and the same as the JAX engine's
with the same workers.
"""

import os
import random

import numpy as np
import pytest
import torch

from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.encode.native_encoder import (
    make_encoder as jax_make_encoder,
)
from streambench_tpu.encode.parallel import (
    ParallelEncodePool as JaxParallelEncodePool,
)
from streambench_tpu.engine import AdAnalyticsEngine as JaxEngine
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu.io.redis_schema import seed_campaigns as jax_seed
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.encode.native_encoder import make_encoder
from streambench_tpu_torch.encode.parallel import ParallelEncodePool
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.io.fakeredis import FakeRedisStore
from streambench_tpu_torch.io.journal import FileBroker
from streambench_tpu_torch.io.redis_schema import (
    as_redis,
    read_seen_counts,
    seed_campaigns,
)

torch.set_num_threads(1)

COLS = ("ad_idx", "event_type", "event_time", "valid")
WORKERS = pytest.mark.parametrize("workers", [1, 2, 4])


@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    """One generated journal (skew on: late and out-of-order events) and
    its ad->campaign map."""
    wd = tmp_path_factory.mktemp("pool")
    cfg = default_config(jax_batch_size=512)
    broker = FileBroker(str(wd / "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=15_000,
                 rng=random.Random(11), workdir=str(wd))
    mapping = gen.load_ad_mapping_file(str(wd / gen.AD_TO_CAMPAIGN_FILE))
    with open(broker.topic_path(cfg.kafka_topic), "rb") as f:
        data = f.read()
    # salt two malformed records in (rejected by every encoder alike)
    cut = data.index(b"\n", len(data) // 3) + 1
    data = data[:cut] + b"}{ not an event\n" + data[cut:] + b'{"user"\n'
    return str(wd), cfg, mapping, data


def _stream(batches, base=None):
    """Every column of every valid row, in order, with absolute times."""
    out = {c: np.concatenate([getattr(b, c)[:b.n] for b in batches])
           for c in COLS}
    bases = {b.base_time_ms for b in batches}
    assert len(bases) == 1, bases         # one base for every encoder
    out["abs_time"] = out["event_time"].astype(np.int64) + bases.pop()
    return out


def _encoder(mapping, native_mod):
    e = native_mod(mapping, None)
    e.set_intern_ids(False)
    return e


@WORKERS
def test_block_pool_carries_the_serial_stream(journal, workers):
    wd, cfg, mapping, data = journal
    B = cfg.jax_batch_size
    serial = _encoder(mapping, make_encoder)
    want, consumed = serial.carve_block(data, B)
    assert consumed == len(data)
    primary = _encoder(mapping, make_encoder)
    pool = ParallelEncodePool(primary,
                              lambda: _encoder(mapping, make_encoder),
                              workers=workers)
    try:
        got, consumed = pool.carve_block_parallel(data, B)
    finally:
        pool.close()
    assert consumed == len(data)
    assert all(b.batch_size == B for b in got)
    assert all(b.n == B for b in got[:-1])  # repacked full batches
    w, g = _stream(want), _stream(got)
    for c in (*COLS, "abs_time"):
        assert np.array_equal(w[c], g[c]), c
    assert primary.base_time_ms == serial.base_time_ms


@WORKERS
def test_block_pool_batches_equal_the_jax_pools(journal, workers):
    """The port's pool against the JAX package's on the same block:
    bit-identical batches, batch by batch."""
    wd, cfg, mapping, data = journal
    B = cfg.jax_batch_size
    pools = []
    for mk, cls in ((make_encoder, ParallelEncodePool),
                    (jax_make_encoder, JaxParallelEncodePool)):
        pools.append(cls(_encoder(mapping, mk),
                         lambda mk=mk: _encoder(mapping, mk),
                         workers=workers))
    try:
        (got, n1), (want, n2) = (p.carve_block_parallel(data, B)
                                 for p in pools)
    finally:
        for p in pools:
            p.close()
    assert n1 == n2 == len(data)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.n, a.base_time_ms) == (b.n, b.base_time_ms)
        for c in COLS:
            assert np.array_equal(getattr(a, c), getattr(b, c)), c


@WORKERS
def test_chunk_pool_carries_the_serial_stream(journal, workers):
    wd, cfg, mapping, data = journal
    B = cfg.jax_batch_size
    lines = data.split(b"\n")[:-1]
    chunks = [lines[i:i + B] for i in range(0, len(lines), B)]
    serial = _encoder(mapping, make_encoder)
    want = [serial.encode(c, B) for c in chunks]
    pool = ParallelEncodePool(_encoder(mapping, make_encoder),
                              lambda: _encoder(mapping, make_encoder),
                              workers=workers)
    try:
        got = pool.encode_chunks(chunks, B)
    finally:
        pool.close()
    assert [b.n for b in got] == [b.n for b in want]
    for a, b in zip(got, want):
        for c in COLS:
            assert np.array_equal(getattr(a, c), getattr(b, c)), c
    assert serial.bad_lines == 2


def _catchup(wd, mapping, workers, jax, pipeline, multi=False):
    over = dict(jax_batch_size=512, jax_scan_batches=4,
                jax_encode_workers=workers, jax_ingest_pipeline=pipeline)
    campaigns = gen.load_ids(wd)[0]
    root = os.path.join(wd, "broker")
    if jax:
        cfg = jax_default_config(**over)
        r = jax_as_redis(JaxStore())
        jax_seed(r, campaigns)
        eng = JaxEngine(cfg, mapping, campaigns=campaigns, redis=r)
        broker, runner_cls = JaxBroker(root), JaxRunner
    else:
        cfg = default_config(**over)
        r = as_redis(FakeRedisStore())
        seed_campaigns(r, campaigns)
        eng = AdAnalyticsEngine(cfg, mapping, campaigns=campaigns, redis=r,
                                device="cpu")
        assert (eng._encode_pool is not None) == (workers > 1)
        broker, runner_cls = FileBroker(root), StreamRunner
    reader = (broker.multi_reader(cfg.kafka_topic) if multi
              else broker.reader(cfg.kafka_topic))
    stats = runner_cls(eng, reader).run_catchup()
    eng.close()
    reader.close()
    assert eng._encode_pool is None       # closed with the engine
    return stats.events, (jax_seen(r) if jax else read_seen_counts(r)), r


@WORKERS
@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_pool_windows_equal_serial_and_jax(journal, workers, pipeline):
    wd, cfg, mapping, _ = journal
    n, want, _ = _catchup(wd, mapping, 1, jax=False, pipeline="off")
    n_t, got, r = _catchup(wd, mapping, workers, jax=False,
                           pipeline=pipeline)
    n_j, jax_rows, _ = _catchup(wd, mapping, workers, jax=True,
                                pipeline=pipeline)
    assert n == n_t == n_j == 15_000
    assert got == want == jax_rows
    correct, differ, missing = gen.check_correct(r, workdir=wd,
                                                 log=lambda s: None)
    assert differ == 0 and missing == 0 and correct > 0


def test_pool_over_line_mode_partitions(tmp_path):
    """Three partitions (a ``MultiReader``: line mode) with two workers:
    the chunk path of the pool, windows equal to the JAX engine's."""
    wd = str(tmp_path)
    cfg = default_config(jax_batch_size=512)
    gen.do_setup(None, cfg, broker=FileBroker(os.path.join(wd, "broker")),
                 events_num=9_000, rng=random.Random(2), workdir=wd,
                 partitions=3)
    mapping = gen.load_ad_mapping_file(
        os.path.join(wd, gen.AD_TO_CAMPAIGN_FILE))
    n_t, got, _ = _catchup(wd, mapping, 2, jax=False, pipeline="on",
                           multi=True)
    n_j, want, _ = _catchup(wd, mapping, 2, jax=True, pipeline="on",
                            multi=True)
    assert n_t == n_j == 9_000 and got == want


def test_pure_python_encoder_gets_no_pool(journal):
    """Only an encoder that releases the GIL parallelizes: with the
    native encoder off the engine keeps the serial path."""
    wd, cfg, mapping, _ = journal
    eng = AdAnalyticsEngine(
        default_config(jax_encode_workers=4, jax_use_native_encoder=False),
        mapping, device="cpu")
    assert eng._encode_pool is None
    eng.close()
