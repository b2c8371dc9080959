"""Ground truth for reach queries: exact set arithmetic + a numpy
mirror of the sketch algebra.

Two verification strengths (bench_reach.py uses both):

- **bit-exact** at small cardinality: per-campaign device-id sets are
  built by exact set arithmetic over the generator's journal, the
  expected ``[C, k]`` / ``[C, R]`` sketch planes are computed in numpy
  from those *sets* (dedup-invariance of the streamed fold is part of
  what this pins), and query evaluation is mirrored slot-for-slot —
  the device state and the integer collision counts must match
  exactly;
- **statistical** at large cardinality: estimates are compared against
  the exact union/intersection counts and the measured relative error
  must sit inside the theoretical bounds (``reach.query.union_bound``
  / ``overlap_bound``).

The numpy splitmix32/rank mirrors must stay bit-identical to
``ops/hll.py`` / ``ops/minhash.py`` — tests/test_minhash.py pins the
differential.
"""

from __future__ import annotations

import json
import zlib

import numpy as np

from streambench_tpu_torch.ops.minhash import EMPTY, _SALT_GAMMA


def splitmix32_np(x: np.ndarray) -> np.ndarray:
    """numpy mirror of ``ops.hll.splitmix32`` (uint32, wrapping)."""
    x = np.asarray(x).astype(np.uint32)
    x = (x + np.uint32(0x9E3779B9)).astype(np.uint32)
    x = ((x ^ (x >> np.uint32(16)))
         * np.uint32(0x21F0AAAD)).astype(np.uint32)
    x = ((x ^ (x >> np.uint32(15)))
         * np.uint32(0x735A2D97)).astype(np.uint32)
    return (x ^ (x >> np.uint32(15))).astype(np.uint32)


def rank_np(h: np.ndarray, p: int) -> np.ndarray:
    """numpy mirror of ``ops.hll._rank``: 1 + leading-zero count of the
    top (32-p) bits."""
    bits = 32 - p
    w = (h >> np.uint32(p)).astype(np.int64)
    bitlen = np.where(w > 0, np.frexp(w.astype(np.float64))[1], 0)
    return (bits - bitlen + 1).astype(np.int32)


def salts_np(k: int) -> np.ndarray:
    """numpy mirror of ``ops.minhash.salts``."""
    return splitmix32_np(
        (np.arange(1, k + 1, dtype=np.uint32)
         * np.uint32(_SALT_GAMMA)).astype(np.uint32))


def id_hash32(user_id: str | bytes) -> int:
    """The encoder's stateless crc32 id (signed int32 bit pattern) —
    what ``HASHED_IDS`` engines see in the ``user_idx`` column."""
    b = user_id.encode() if isinstance(user_id, str) else user_id
    c = zlib.crc32(b)
    return c - (1 << 32) if c & 0x80000000 else c


def campaign_user_sets(lines, mapping: dict[str, str],
                       campaigns: list[str]) -> dict[str, set[int]]:
    """Exact per-campaign device sets from journal lines: the crc32 ids
    of users with a *view* event joining to each campaign (the same
    filter/join the device fold applies)."""
    sets: dict[str, set[int]] = {c: set() for c in campaigns}
    for line in lines:
        if isinstance(line, bytes):
            line = line.decode()
        line = line.strip()
        if not line:
            continue
        ev = json.loads(line)
        if ev.get("event_type") != "view":
            continue
        campaign = mapping.get(ev.get("ad_id"))
        if campaign is None:
            continue
        sets[campaign].add(id_hash32(ev["user_id"]))
    return sets


def expected_state(sets: dict[str, set[int]], campaigns: list[str],
                   k: int, num_registers: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The sketch planes a correct fold must produce, computed from the
    exact sets (order- and duplicate-free by construction)."""
    R = num_registers
    p = R.bit_length() - 1
    mins = np.full((len(campaigns), k), EMPTY, np.uint32)
    regs = np.zeros((len(campaigns), R), np.int32)
    salt = salts_np(k)
    for ci, name in enumerate(campaigns):
        ids = sets.get(name, set())
        if not ids:
            continue
        h = splitmix32_np(np.asarray(sorted(ids), np.int64)
                          .astype(np.uint32))
        hk = splitmix32_np(h[:, None] ^ salt[None, :])
        mins[ci] = hk.min(axis=0)
        j = (h & np.uint32(R - 1)).astype(np.int64)
        rank = rank_np(h, p)
        np.maximum.at(regs[ci], j, rank)
    return mins, regs


def query_oracle_np(mins: np.ndarray, registers: np.ndarray,
                    mask: np.ndarray) -> np.ndarray:
    """numpy mirror of the device query's integer collision count
    (``agree``) per query row — the bit-exact comparison target."""
    sel = mask[:, :, None]
    sel_min = np.where(sel, mins[None], np.uint32(EMPTY)).min(axis=1)
    sel_max = np.where(sel, mins[None], np.uint32(0)).max(axis=1)
    return np.sum((sel_min == sel_max) & (sel_min != np.uint32(EMPTY)),
                  axis=1).astype(np.int32)


def exact_counts(sets: dict[str, set[int]], names: list[str],
                 op: str) -> tuple[int, int]:
    """Exact ``(result, union)`` cardinalities by set arithmetic:
    ``op='union'`` -> (|∪|, |∪|); ``op='overlap'`` -> (|∩|, |∪|)."""
    if not names:
        return 0, 0
    sel = [sets.get(n, set()) for n in names]
    union = set().union(*sel)
    if op == "union":
        return len(union), len(union)
    inter = set(sel[0])
    for s in sel[1:]:
        inter &= s
    return len(inter), len(union)
