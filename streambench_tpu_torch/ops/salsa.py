"""SALSA-style count-min sketch: 8-bit cells that merge on overflow.

The port of ``streambench_tpu/ops/salsa.py``.  Every counter starts at 8
bits and widens only where traffic lands: a cell that overflows merges
with its sibling into a 16-bit pair, an overflowing pair into a 32-bit
quad.  State, all static-shaped:

- ``table [D, Wd] uint8``: the cell bytes; a merged group stores its
  value little-endian across its member bytes;
- ``m1 [D, Wd//16] uint8``: packed bitmap, one bit per PAIR (bit ``p`` of
  the little-endian bit order: cells ``2p, 2p+1`` form one counter);
- ``m2 [D, Wd//32] uint8``: one bit per QUAD (implies both pair bits);
- ``total [] int32``: the total folded weight.

The transition is a multiset homomorphism: overflow is detected on the
exact int32 value (decode, add, settle), merging sums the siblings, and
merge bits only turn on, when a group's running total first exceeds its
width, so the state is a closed-form function of the exact per-cell
totals (``oracle_encode_np``), whatever the batching, order or shard
split.  Quads saturate at ``CAP2 = 2^31 - 1``; the decoded plane is int32
throughout, as the reference's is.

Query semantics match ``ops/cms.py`` exactly while every touched group is
still solo.  The ``[D, B]`` hashed columns come from K3's column entry
point (``ops/cmsrows.py:cms_cols``) on the card; the plane passes stay
torch ops.  The numpy oracles carry their own copy of the uint32
splitmix32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from streambench_tpu_torch.ops.cms import _SALTS, _row_cols, top_k

#: width caps per merge level: solo byte, 16-bit pair, 32-bit quad
CAP0 = 255
CAP1 = 65_535
CAP2 = 2**31 - 1


class SalsaState(NamedTuple):
    table: torch.Tensor   # [D, Wd] uint8 cell bytes
    m1: torch.Tensor      # [D, Wd//16] uint8 packed pair-merge bits
    m2: torch.Tensor      # [D, Wd//32] uint8 packed quad-merge bits
    total: torch.Tensor   # [] int32 total folded weight


def init_state(depth: int = 4, width: int = 2048, cell_bits: int = 8,
               device: torch.device | str = "cpu") -> SalsaState:
    """A fresh plane; ``cell_bits=16`` starts with every pair merged
    (the ``jax.cms.cell.bits`` knob)."""
    if width & (width - 1) or width < 32:
        raise ValueError("width must be a power of two >= 32")
    if depth > len(_SALTS):
        raise ValueError(f"depth <= {len(_SALTS)}")
    if cell_bits not in (8, 16):
        raise ValueError(f"cell_bits must be 8 or 16, got {cell_bits}")
    m1_fill = 0xFF if cell_bits == 16 else 0
    u8 = dict(dtype=torch.uint8, device=device)
    return SalsaState(
        table=torch.zeros((depth, width), **u8),
        m1=torch.full((depth, width // 16), m1_fill, **u8),
        m2=torch.zeros((depth, width // 32), **u8),
        total=torch.zeros((), dtype=torch.int32, device=device))


# ----------------------------------------------------------------------
# bitmap and value-plane plumbing

def _expand_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """[D, n//8] packed uint8 -> [D, n] int32 in {0, 1} (bit k of byte i
    is group 8i+k)."""
    D = packed.shape[0]
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None].to(torch.int32) >> shifts) & 1
    return bits.reshape(D, n)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[D, n] {0,1} -> [D, n//8] packed uint8 (inverse of _expand_bits)."""
    D, n = bits.shape
    b = bits.reshape(D, n // 8, 8).to(torch.int32)
    w = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b * w).sum(-1, dtype=torch.int32).to(torch.uint8)


def _rep(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.repeat_interleave(x, k, dim=1)


def _decode(state: SalsaState):
    """Base-placed value plane ``v [D, Wd] int32`` (each group's value at
    its FIRST cell, zero at its other cells) and the expanded pair and
    quad bit planes."""
    D, Wd = state.table.shape
    b = state.table.to(torch.int32)
    pair = b[:, 0::2] + (b[:, 1::2] << 8)            # [D, Wd/2] raw LE16
    quad = pair[:, 0::2] + (pair[:, 1::2] << 16)     # [D, Wd/4] raw LE32
    m1b = _expand_bits(state.m1, Wd // 2)
    m2b = _expand_bits(state.m2, Wd // 4)
    idx = torch.arange(Wd, dtype=torch.int32, device=b.device)
    pair_base = (idx % 2 == 0)[None, :]
    quad_base = (idx % 4 == 0)[None, :]
    v = torch.where(
        _rep(m2b, 4) == 1,
        torch.where(quad_base, _rep(quad, 4), 0),
        torch.where(_rep(m1b, 2) == 1,
                    torch.where(pair_base, _rep(pair, 2), 0), b))
    return v, m1b, m2b


def _settle(v: torch.Tensor, m1b: torch.Tensor, m2b: torch.Tensor):
    """Overflow pass and re-encode: merge bits turn on where a group
    outgrew its width (solo > 255 -> pair, pair > 65535 -> quad, quads
    saturate at CAP2); returns (table, m1, m2)."""
    D, Wd = v.shape
    pair_tot = v[:, 0::2] + v[:, 1::2]
    quad_tot = pair_tot[:, 0::2] + pair_tot[:, 1::2]
    cell_hi = torch.maximum(v[:, 0::2], v[:, 1::2])
    m1b = torch.maximum(m1b, (cell_hi > CAP0).to(torch.int32))
    pair_over = (m1b == 1) & (pair_tot > CAP1)
    quad_over = pair_over[:, 0::2] | pair_over[:, 1::2]
    m2b = torch.maximum(m2b, quad_over.to(torch.int32))
    m1b = torch.maximum(m1b, _rep(m2b, 2))           # a quad implies pairs
    quad_tot = torch.clamp(quad_tot, max=CAP2)
    idx = torch.arange(Wd, dtype=torch.int32, device=v.device)[None, :]
    m1_cell = _rep(m1b, 2) == 1
    m2_cell = _rep(m2b, 4) == 1
    group_val = torch.where(
        m2_cell, _rep(quad_tot, 4),
        torch.where(m1_cell, _rep(pair_tot, 2), v))
    lane = torch.where(m2_cell, idx % 4, torch.where(m1_cell, idx % 2, 0))
    table = ((group_val >> (lane * 8)) & 0xFF).to(torch.uint8)
    return table, _pack_bits(m1b), _pack_bits(m2b)


def _bit_at(packed: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    """Bit ``group`` of each row's packed bitmap: packed [D, G//8],
    group [D, B] int32 -> [D, B] int32 in {0, 1}."""
    byte = torch.gather(packed, 1, (group >> 3).to(torch.int64)).to(
        torch.int32)
    return (byte >> (group & 7)) & 1


# ----------------------------------------------------------------------
# the transitions

def update(state: SalsaState, keys: torch.Tensor, weights: torch.Tensor,
           mask: torch.Tensor) -> SalsaState:
    """Add ``weights`` for ``keys`` (masked rows dropped): decode, add
    each key's weight at its CURRENT group base, settle, re-encode.
    Returns a new state."""
    D, Wd = state.table.shape
    cols = _row_cols(keys, D, Wd)                        # [D, B]
    m = mask.bool()
    w = torch.where(m, weights, 0).to(torch.int32)
    v, m1b, m2b = _decode(state)
    m1_at = _bit_at(state.m1, cols >> 1)
    m2_at = _bit_at(state.m2, cols >> 2)
    base = torch.where(m2_at == 1, (cols >> 2) << 2,
                       torch.where(m1_at == 1, (cols >> 1) << 1, cols))
    rows = torch.arange(D, dtype=torch.int64, device=cols.device)[:, None]
    flat = torch.where(m[None, :], rows * Wd + base.to(torch.int64), D * Wd)
    padded = torch.cat([v.reshape(-1), v.new_zeros(1)])
    padded.index_add_(0, flat.reshape(-1), w.expand(D, -1).reshape(-1))
    table, m1, m2 = _settle(padded[:-1].reshape(D, Wd), m1b, m2b)
    return SalsaState(table, m1, m2,
                      state.total + w.sum(dtype=torch.int32))


def query(state: SalsaState, keys: torch.Tensor) -> torch.Tensor:
    """Point estimates (upper bounds): the widest merged counter covering
    each key's cell, min over the D rows."""
    D, Wd = state.table.shape
    cols = _row_cols(keys, D, Wd)
    m1_at = _bit_at(state.m1, cols >> 1)
    m2_at = _bit_at(state.m2, cols >> 2)
    t = state.table.to(torch.int32)

    def at(off_base, k):
        return torch.gather(t, 1, (off_base + k).to(torch.int64))

    solo = at(cols, 0)
    p0 = (cols >> 1) << 1
    pairv = at(p0, 0) + (at(p0, 1) << 8)
    q0 = (cols >> 2) << 2
    quadv = (at(q0, 0) + (at(q0, 1) << 8)
             + (at(q0, 2) << 16) + (at(q0, 3) << 24))
    val = torch.where(m2_at == 1, quadv,
                      torch.where(m1_at == 1, pairv, solo))
    return val.min(0).values


def merge(a: SalsaState, b: SalsaState) -> SalsaState:
    """Shard union: OR the bitmaps, sum the decoded value planes, settle,
    re-encode; commutative and associative bit for bit."""
    if (a.table.shape != b.table.shape
            or a.table.dtype != b.table.dtype):
        raise ValueError(
            f"salsa.merge: geometry mismatch — a.table "
            f"{tuple(a.table.shape)}/{a.table.dtype} vs b.table "
            f"{tuple(b.table.shape)}/{b.table.dtype}")
    va, m1a, m2a = _decode(a)
    vb, m1b, m2b = _decode(b)
    table, m1, m2 = _settle(va + vb, torch.maximum(m1a, m1b),
                            torch.maximum(m2a, m2b))
    return SalsaState(table, m1, m2, a.total + b.total)


def heavy_hitters(state: SalsaState, candidate_keys: torch.Tensor, *,
                  k: int = 16):
    """Top-k candidates by SALSA estimate (peer of cms.heavy_hitters)."""
    return top_k(query(state, candidate_keys), k)


def stats(state: SalsaState) -> dict:
    """Host-side merge census: cells, merged pairs and quads, total."""
    Wd = state.table.shape[1]
    m1 = np.unpackbits(state.m1.cpu().numpy(), axis=1, count=Wd // 2,
                       bitorder="little")
    m2 = np.unpackbits(state.m2.cpu().numpy(), axis=1, count=Wd // 4,
                       bitorder="little")
    return {"cells": int(state.table.numel()),
            "merged_pairs": int(m1.sum()),
            "merged_quads": int(m2.sum()),
            "total": int(state.total)}


# ----------------------------------------------------------------------
# numpy differential oracle: the expected state in closed form from the
# exact per-cell totals, never replaying the batched transition

def splitmix32_np(x: np.ndarray) -> np.ndarray:
    """numpy uint32 splitmix32 (wrapping)."""
    x = np.asarray(x).astype(np.uint32)
    x = (x + np.uint32(0x9E3779B9)).astype(np.uint32)
    x = ((x ^ (x >> np.uint32(16))) * np.uint32(0x21F0AAAD)).astype(
        np.uint32)
    x = ((x ^ (x >> np.uint32(15))) * np.uint32(0x735A2D97)).astype(
        np.uint32)
    return (x ^ (x >> np.uint32(15))).astype(np.uint32)


def oracle_cols_np(keys: np.ndarray, depth: int, width: int) -> np.ndarray:
    """numpy mirror of ``cms._row_cols`` ([D, B] column per row)."""
    cols = []
    for d in range(depth):
        h = splitmix32_np(np.asarray(keys).astype(np.uint32)
                          ^ np.uint32(_SALTS[d]))
        cols.append((h & np.uint32(width - 1)).astype(np.int32))
    return np.stack(cols)


def oracle_totals_np(batches, depth: int, width: int) -> np.ndarray:
    """Exact per-cell totals [D, Wd] int64 from (keys, weights, mask)
    batch triples."""
    tot = np.zeros((depth, width), np.int64)
    for keys, weights, mask in batches:
        cols = oracle_cols_np(np.asarray(keys), depth, width)
        w = np.where(mask, weights, 0).astype(np.int64)
        for d in range(depth):
            np.add.at(tot[d], cols[d], w)
    return tot


def oracle_encode_np(totals: np.ndarray, cell_bits: int = 8):
    """Closed-form expected state from exact per-cell totals: a pair is
    merged iff a member's total exceeds 255, a quad iff a pair total
    exceeds 65535; values are group sums clipped at CAP2, bytes
    little-endian per group.  Returns (table uint8, m1, m2 packed)."""
    D, Wd = totals.shape
    t = totals
    pair_tot = t[:, 0::2] + t[:, 1::2]
    m1 = np.maximum(t[:, 0::2], t[:, 1::2]) > CAP0
    if cell_bits == 16:
        m1 = np.ones_like(m1)
    m2 = ((m1 & (pair_tot > CAP1))[:, 0::2]
          | (m1 & (pair_tot > CAP1))[:, 1::2])
    m1 = m1 | np.repeat(m2, 2, axis=1)
    quad_tot = np.minimum(pair_tot[:, 0::2] + pair_tot[:, 1::2], CAP2)
    m1c = np.repeat(m1, 2, axis=1)
    m2c = np.repeat(m2, 4, axis=1)
    group = np.where(m2c, np.repeat(quad_tot, 4, axis=1),
                     np.where(m1c, np.repeat(pair_tot, 2, axis=1), t))
    idx = np.arange(Wd)
    lane = np.where(m2c, idx % 4, np.where(m1c, idx % 2, 0))
    table = ((group >> (lane * 8)) & 0xFF).astype(np.uint8)
    pm1 = np.packbits(m1.astype(np.uint8), axis=1, bitorder="little")
    pm2 = np.packbits(m2.astype(np.uint8), axis=1, bitorder="little")
    return table, pm1, pm2


def oracle_query_np(totals: np.ndarray, keys: np.ndarray,
                    cell_bits: int = 8) -> np.ndarray:
    """Expected point estimates from exact totals at the final merge
    geometry (what ``query`` must return bit for bit)."""
    D, Wd = totals.shape
    table, pm1, pm2 = oracle_encode_np(totals, cell_bits)
    m1 = np.unpackbits(pm1, axis=1, count=Wd // 2, bitorder="little")
    m2 = np.unpackbits(pm2, axis=1, count=Wd // 4, bitorder="little")
    pair_tot = totals[:, 0::2] + totals[:, 1::2]
    quad_tot = np.minimum(pair_tot[:, 0::2] + pair_tot[:, 1::2], CAP2)
    cols = oracle_cols_np(np.asarray(keys), D, Wd)
    out = np.empty((D, cols.shape[1]), np.int64)
    for d in range(D):
        c = cols[d]
        solo = totals[d, c]
        pv = pair_tot[d, c >> 1]
        qv = quad_tot[d, c >> 2]
        out[d] = np.where(m2[d, c >> 2] == 1, qv,
                          np.where(m1[d, c >> 1] == 1, pv, solo))
    return out.min(axis=0)
