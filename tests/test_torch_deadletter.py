"""Dead-letter queue and torn-journal recovery of the port, against the JAX
package.

The ports of the cases of ``tests/test_deadletter.py``: with
``jax.deadletter.enabled`` malformed events land raw on a
``<topic>-deadletter`` journal instead of only bumping ``bad_lines``, and a
journal holding a NUL-torn record is consumed in ``skip_corrupt`` mode
with clean resumption.  The engine cases run through both engines on the
same journal; the CLI case shows the key wired to the encoder.
"""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

from streambench_tpu.config import default_config as jax_default_config
from streambench_tpu.encode.encoder import EventEncoder as JaxEventEncoder
from streambench_tpu.engine import AdAnalyticsEngine as JaxEngine
from streambench_tpu.engine import StreamRunner as JaxRunner
from streambench_tpu.io.fakeredis import FakeRedisStore as JaxStore
from streambench_tpu.io.journal import FileBroker as JaxBroker
from streambench_tpu.io.redis_schema import as_redis as jax_as_redis
from streambench_tpu.io.redis_schema import read_seen_counts as jax_seen
from streambench_tpu_torch.config import BenchmarkConfig, default_config
from streambench_tpu_torch.datagen import gen
from streambench_tpu_torch.encode.encoder import EventEncoder
from streambench_tpu_torch.encode.native_encoder import make_encoder
from streambench_tpu_torch.engine import AdAnalyticsEngine, StreamRunner
from streambench_tpu_torch.io.fakeredis import FakeRedisStore
from streambench_tpu_torch.io.journal import FileBroker, JournalReader
from streambench_tpu_torch.io.redis_schema import as_redis, read_seen_counts

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPPING = {"ad-1": "camp-1", "ad-2": "camp-1", "ad-3": "camp-2"}
GARBAGE = [b"}{ not an event", b'{"user_id": "u"']


def ev(ad="ad-1", t=1_000_000):
    return (f'{{"user_id": "u1", "page_id": "p1", "ad_id": "{ad}", '
            f'"ad_type": "banner", "event_type": "view", '
            f'"event_time": "{t}", "ip_address": "1.2.3.4"}}').encode()


def test_deadletter_config_key_parses():
    cfg = BenchmarkConfig.from_mapping({"jax.deadletter.enabled": "true"})
    assert cfg.jax_deadletter_enabled
    assert not default_config().jax_deadletter_enabled


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_encoder_deadletters_rejects(tmp_path, native):
    enc = make_encoder(MAPPING) if native else EventEncoder(MAPPING)
    broker = FileBroker(str(tmp_path / "b"))
    dlq = broker.writer("test1-deadletter")
    enc.set_deadletter(dlq)
    bad1, bad2 = b"not json at all", b'{"user_id": "u", "trunc'
    enc.encode([ev(), bad1, ev("ad-2"), bad2], 8)
    dlq.close()
    assert enc.bad_lines == 2 and enc.dlq_lines == 2
    assert list(broker.read_all("test1-deadletter")) == [bad1, bad2]


def test_deadletter_off_by_default_only_counts():
    for enc in (EventEncoder(MAPPING), JaxEventEncoder(MAPPING)):
        enc.encode([ev(), b"garbage"], 4)
        assert enc.bad_lines == 1 and enc.dlq_lines == 0


def test_deadletter_tbl_path(tmp_path):
    broker = FileBroker(str(tmp_path / "b"))
    dlq = broker.writer("t-deadletter")
    enc = EventEncoder(MAPPING)
    enc.set_deadletter(dlq)
    enc.encode_tbl([b"u|p|ad-1|banner|view|1000000",
                    b"too|few", b"u|p|ad-1|banner|view|notanint"], 4)
    dlq.close()
    assert enc.bad_lines == 2 and enc.dlq_lines == 2
    assert list(broker.read_all("t-deadletter")) == [
        b"too|few", b"u|p|ad-1|banner|view|notanint"]


def _salted_journal(tmp_path, events=500, seed=3):
    cfg = default_config(jax_batch_size=64)
    broker = FileBroker(str(tmp_path / "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=events,
                 rng=random.Random(seed), workdir=str(tmp_path))
    with broker.writer(cfg.kafka_topic) as w:
        w.append_many(GARBAGE)
    mapping = gen.load_ad_mapping_file(
        str(tmp_path / gen.AD_TO_CAMPAIGN_FILE))
    return cfg, broker, mapping


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_run_stats_surface_dlq_and_bad_lines(tmp_path, pipeline):
    """A topic salted with garbage: RunStats.faults carries dlq_lines and
    bad_lines, the DLQ journal holds exactly the garbage, and the rows
    equal the JAX engine's — serial and pipelined."""
    cfg, broker, mapping = _salted_journal(tmp_path)
    topic = cfg.kafka_topic
    rows = []
    for jax in (True, False):
        c = (jax_default_config if jax else default_config)(
            jax_batch_size=64, jax_ingest_pipeline=pipeline)
        root = str(tmp_path / "broker")
        b = JaxBroker(root) if jax else FileBroker(root)
        r = jax_as_redis(JaxStore()) if jax else as_redis(FakeRedisStore())
        eng = (JaxEngine(c, mapping, redis=r) if jax else
               AdAnalyticsEngine(c, mapping, redis=r, device="cpu"))
        dlq = b.writer(f"{topic}-deadletter-{'jax' if jax else 'torch'}")
        eng.encoder.set_deadletter(dlq)
        with b.reader(topic) as reader:
            st = (JaxRunner if jax else StreamRunner)(eng,
                                                      reader).run_catchup()
        eng.close()
        dlq.close()
        assert st.events == 500
        assert st.faults.get("bad_lines") == 2
        assert st.faults.get("dlq_lines") == 2
        rows.append(jax_seen(r) if jax else read_seen_counts(r))
    assert rows[0] == rows[1]
    assert list(broker.read_all(f"{topic}-deadletter-torch")) == GARBAGE


def test_cli_deadletter_key_journals_the_rejects(tmp_path):
    """``jax.deadletter.enabled`` in the CLI's config opens
    ``<topic>-deadletter`` on the broker and hands it to the encoder."""
    cfg, broker, _ = _salted_journal(tmp_path, events=300, seed=8)
    conf = tmp_path / "conf.yaml"
    conf.write_text('redis.host: ":inprocess:"\n'
                    f'kafka.topic: "{cfg.kafka_topic}"\n'
                    "jax.deadletter.enabled: true\n"
                    "jax.ingest.pipeline: \"on\"\n")
    p = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.engine",
         "--confPath", str(conf), "--workdir", str(tmp_path), "--catchup",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert p.returncode == 0, p.stderr[-2000:]
    stats = json.loads(p.stdout.strip().splitlines()[-1])
    assert stats["events"] == 300
    assert stats["faults"] == {"bad_lines": 2, "dlq_lines": 2}
    assert list(broker.read_all(f"{cfg.kafka_topic}-deadletter")) == GARBAGE


# ----------------------------------------------------------------------
# torn-tail / skip_corrupt recovery
# ----------------------------------------------------------------------

def test_skip_corrupt_consumes_torn_record(tmp_path):
    path = str(tmp_path / "t.jsonl")
    good = [b"rec-%d" % i for i in range(6)]
    with open(path, "wb") as f:
        f.write(b"".join(line + b"\n" for line in good[:3]))
        f.write(b"rec-\x00\x00\x00\x00torn\n")
        f.write(b"".join(line + b"\n" for line in good[3:]))
    r = JournalReader(path, skip_corrupt=True)
    assert r.poll(100) == good
    assert r.corrupt_records == 1
    assert r.offset == os.path.getsize(path)
    r.seek(0)
    assert r.poll(4) == good[:3]
    assert r.poll(100) == good[3:]
    assert len(JournalReader(path).poll(100)) == 7


def test_skip_corrupt_block_mode(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with open(path, "wb") as f:
        f.write(b"aaaa\n\x00\x00\x00\x00\nbbbb\n")
    r = JournalReader(path, skip_corrupt=True)
    assert r.poll_block() == b"aaaa\nbbbb\n"
    assert r.corrupt_records == 1
    assert r.offset == os.path.getsize(path)


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_torn_journal_engine_resumes_cleanly(tmp_path, pipeline):
    cfg = default_config(jax_batch_size=64, jax_ingest_pipeline=pipeline)
    broker = FileBroker(str(tmp_path / "broker"))
    gen.do_setup(None, cfg, broker=broker, events_num=400,
                 rng=random.Random(5), workdir=str(tmp_path))
    topic = broker.topic_path(cfg.kafka_topic)
    with open(topic, "r+b") as f:
        data = f.read()
        third = data.index(b"\n", data.index(b"\n", data.index(b"\n") + 1)
                           + 1) + 1
        end = data.index(b"\n", third)
        f.seek(third)
        f.write(b"\x00" * (end - third))
    mapping = gen.load_ad_mapping_file(
        str(tmp_path / gen.AD_TO_CAMPAIGN_FILE))
    eng = AdAnalyticsEngine(cfg, mapping, redis=as_redis(FakeRedisStore()),
                            device="cpu")
    reader = broker.reader(cfg.kafka_topic, skip_corrupt=True)
    st = StreamRunner(eng, reader).run_catchup()
    eng.close()
    assert st.events == 399
    assert st.faults.get("journal_corrupt_skipped") == 1
    assert reader.corrupt_records == 1
