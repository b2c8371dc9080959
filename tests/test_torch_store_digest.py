"""The in-process store's whole-store window digest (``window_digest``).

``chip_smoke.py`` holds a sharded engine's store to the unsharded one's
with it (phases 17 and 18 (b)) instead of reading a 1e6-campaign store
back one command a campaign.  The native store (``sbr_window_digest``)
and the Python store must give the same digest for the same windows, the
digest must be the one ``window_digest_of`` computes from the windows
read back by commands, and a window moved, added or miscounted must
change it.
"""

import random

import pytest

from streambench_tpu_torch import native
from streambench_tpu_torch.io.fakeredis import (
    FakeRedisStore,
    NativeRedisStore,
    window_digest_of,
)
from streambench_tpu_torch.io.redis_schema import (
    as_redis,
    read_seen_counts,
    seed_campaigns,
    write_window,
    write_windows_pipelined,
)

CAMPAIGNS = [f"camp-{i:03d}" for i in range(40)]


def stores():
    out = [FakeRedisStore()]
    lib = native.load()
    if lib is not None:
        out.append(NativeRedisStore(lib))
    return out


def fill(r, rows) -> None:
    """Per-command windows, a pipelined (bulk) flush of increments and an
    absolute one, and hashes that are not windows."""
    seed_campaigns(r, CAMPAIGNS)
    for c, ts, n in rows[:20]:
        write_window(r, c, ts, n, time_updated=5)
    write_windows_pipelined(r, rows[20:], time_updated=6)
    write_windows_pipelined(r, rows[:5], time_updated=7, absolute=True)
    r.execute("HSET", "campaigns_reach", CAMPAIGNS[0], "17")
    r.execute("HSET", "latency", "1000", "12")


def read_rows(r) -> list:
    return [(c, ts, n) for c, win in read_seen_counts(r).items()
            for ts, n in win.items()]


@pytest.fixture
def rows():
    rng = random.Random(5)
    keys = {(rng.choice(CAMPAIGNS), 10_000 * rng.randrange(30))
            for _ in range(300)}
    return [(c, ts, rng.randrange(1, 50)) for c, ts in sorted(keys)]


@pytest.mark.parametrize("kind", ["python", "native"])
def test_digest_is_the_windows_read_back(kind, rows):
    st = stores()
    if kind == "native" and len(st) < 2:
        pytest.skip("native library unavailable: no g++")
    store = st[0] if kind == "python" else st[1]
    r = as_redis(store)
    fill(r, rows)
    got = store.window_digest()
    want = window_digest_of(read_rows(r))
    assert got == want
    assert got["windows"] == len(rows)
    # the absolute flush of rows[:5] overwrote their increments
    assert got["seen"] == sum(n for _, _, n in rows)


def test_native_and_python_stores_agree(rows):
    st = stores()
    if len(st) < 2:
        pytest.skip("native library unavailable: no g++")
    for store in st:
        fill(as_redis(store), rows)
    assert st[0].window_digest() == st[1].window_digest()


@pytest.mark.parametrize("change", ["moved", "added", "miscounted",
                                    "other_campaign"])
def test_a_changed_window_changes_the_digest(change, rows):
    base = FakeRedisStore()
    fill(as_redis(base), rows)
    other = FakeRedisStore()
    r = as_redis(other)
    fill(r, rows)
    c, ts, _ = rows[30]
    if change == "moved":
        key = r.execute("HGET", c, str(ts))
        r.execute("HDEL", c, str(ts))
        r.execute("HSET", c, str(ts + 10_000 * 100), key)
    elif change == "added":
        write_window(r, c, ts + 10_000 * 100, 0, time_updated=8)
    elif change == "miscounted":
        write_window(r, c, ts, 1, time_updated=8)
    else:
        key = r.execute("HGET", c, str(ts))
        r.execute("HDEL", c, str(ts))
        to = next(x for x in CAMPAIGNS if x != c)
        r.execute("HSET", to, str(10_000 * 500), key)
    a, b = base.window_digest(), other.window_digest()
    assert a["digest"] != b["digest"]
    assert b["windows"] - a["windows"] == (1 if change == "added" else 0)
    assert b["seen"] - a["seen"] == (1 if change == "miscounted" else 0)


def test_digest_ignores_row_order():
    rows = [(c, 1000 * i, i + 1) for i, c in enumerate(CAMPAIGNS)]
    shuffled = list(rows)
    random.Random(3).shuffle(shuffled)
    a = window_digest_of(rows)
    assert a == window_digest_of(shuffled)
    assert a["windows"] == 40 and a["seen"] == sum(range(1, 41))
