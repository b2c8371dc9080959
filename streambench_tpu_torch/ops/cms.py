"""Count-min sketch and its heavy-hitter ring: BASELINE config #4.

The port of ``streambench_tpu/ops/cms.py``: approximate per-key counts
(clicks per user) in ``D`` hash rows x ``Wd`` counters.  ``update`` is a
masked scatter-add and ``query`` the min over rows; on a CUDA tensor both,
and the two-stage sketch's ``update2`` / ``query_small``, are one launch
of K3 (``ops/cmsrows.py``, ``csrc/cms_rows.cu``), on a CPU tensor its
plain version.  The rest stays torch ops.

- ``CMS2State``: the SF-style two-stage sketch: the ordinary fat stage
  plus a small query-side stage ``[D, Ws]`` refreshed, after each update,
  with the touched keys' new fat estimates (scatter-max).  It does not
  merge (``merge2`` raises).
- ``sk_update`` / ``point_query`` / ``sk_total``: the family dispatch
  over fixed, two-stage and SALSA (``ops/salsa.py``) states;
  ``update_query`` is ``sk_update`` then ``point_query`` of the same keys,
  one K3 call for the fixed and two-stage families (the session fold's
  closed sets).
- ``TopKState``: the fixed-size heavy-hitter candidate ring;
  ``fold_candidates`` folds a batch into a chunk-local hash-slotted
  table in O(B), ``update_topk`` merges keys into the ring exactly.

Differences from the JAX functions, all deliberate: ``update``,
``update_rowloop`` and ``update2`` update the state's tensors IN PLACE
(as K3 does) and return the same state; ``jax.lax.top_k`` is a stable
descending sort and its head (ties go to the lowest index, which
``torch.topk`` does not promise); ``jnp.lexsort`` is two stable argsorts,
the secondary key first; uint32 arithmetic runs in int64 under a 32-bit
mask; dropped scatter rows go to a pad element past the buffer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from streambench_tpu_torch.ops import cmsrows
from streambench_tpu_torch.ops.hll import splitmix32

_SALTS = cmsrows.SALTS
_U32 = 0xFFFFFFFF


class CMSState(NamedTuple):
    table: torch.Tensor   # [D, Wd] int32
    total: torch.Tensor   # [] int32: total weight folded in


def init_state(depth: int = 4, width: int = 2048,
               device: torch.device | str = "cpu") -> CMSState:
    if width & (width - 1):
        raise ValueError("width must be a power of two")
    if depth > len(_SALTS):
        raise ValueError(f"depth <= {len(_SALTS)}")
    return CMSState(
        table=torch.zeros((depth, width), dtype=torch.int32, device=device),
        total=torch.zeros((), dtype=torch.int32, device=device))


def _row_cols(keys: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """``[D, B]`` column per row: salted splitmix32, low log2(Wd) bits
    (K3's column entry point on the card)."""
    return cmsrows.cms_cols(keys, depth, width)


def update(state: CMSState, keys: torch.Tensor, weights: torch.Tensor,
           mask: torch.Tensor) -> CMSState:
    """Add ``weights`` for ``keys`` (masked rows dropped), in place."""
    cmsrows.cms_update(state.table, state.total, keys, weights, mask)
    return state


def update_rowloop(state: CMSState, keys: torch.Tensor,
                   weights: torch.Tensor, mask: torch.Tensor) -> CMSState:
    """``update`` as D per-row scatter-adds over K3's columns instead of
    one flat scatter, in place: bit-identical; the method table's
    ``rowloop`` arm."""
    D, Wd = state.table.shape
    cols = _row_cols(keys, D, Wd)
    m = mask.bool()
    w = torch.where(m, weights, 0).to(torch.int32)
    row = torch.empty(Wd + 1, dtype=torch.int32, device=state.table.device)
    for d in range(D):
        row.zero_()
        row.index_add_(0, torch.where(m, cols[d], Wd).to(torch.int64), w)
        state.table[d].add_(row[:Wd])
    state.total.add_(w.sum(dtype=torch.int32))
    return state


def query(state: CMSState, keys: torch.Tensor) -> torch.Tensor:
    """Point estimates (upper bounds) for ``keys``: min over rows."""
    return cmsrows.cms_query(state.table, keys)


def merge(a: CMSState, b: CMSState) -> CMSState:
    """Sketch union: elementwise add; the geometry is checked first."""
    if a.table.shape != b.table.shape or a.table.dtype != b.table.dtype:
        raise ValueError(
            f"cms.merge: geometry mismatch — a.table "
            f"{tuple(a.table.shape)}/{a.table.dtype} vs b.table "
            f"{tuple(b.table.shape)}/{b.table.dtype}")
    return CMSState(a.table + b.table, a.total + b.total)


# ----------------------------------------------------------------------
# the SF-style two-stage sketch

class CMS2State(NamedTuple):
    """Two-stage count-min: ``fat`` is the update-linear ``[D, Wd]``
    sketch; ``small [D, Ws]`` the query-side stage, raised to each
    touched key's post-update fat estimate.  Queries read the small
    plane and stay upper bounds.  It does not merge across shards."""

    fat: CMSState
    small: torch.Tensor   # [D, Ws] int32


def init_two_stage(depth: int = 4, width: int = 2048,
                   small_width: int | None = None,
                   device: torch.device | str = "cpu") -> CMS2State:
    sw = small_width if small_width is not None else max(width // 8, 64)
    if sw & (sw - 1):
        raise ValueError("small_width must be a power of two")
    return CMS2State(fat=init_state(depth, width, device=device),
                     small=torch.zeros((depth, sw), dtype=torch.int32,
                                       device=device))


def update2(state: CMS2State, keys: torch.Tensor, weights: torch.Tensor,
            mask: torch.Tensor) -> CMS2State:
    """Fat scatter-add, then the small stage raised to the keys' NEW fat
    estimates (masked rows dropped); in place, two K3 launches."""
    update(state.fat, keys, weights, mask)
    cmsrows.cms_refresh_small(state.fat.table, state.small, keys, mask)
    return state


def query_small(state: CMS2State, keys: torch.Tensor) -> torch.Tensor:
    """Point estimates from the small stage: min over its rows."""
    return cmsrows.cms_query(state.small, keys)


def merge2(a: CMS2State, b: CMS2State) -> CMS2State:
    raise ValueError(
        "cms.CMS2State does not merge: max over small-stage estimates "
        "undercuts the summed true count (no longer an upper bound) — "
        "merge the fat stages (cms.merge) and rebuild, or run two-stage "
        "single-device only")


# ----------------------------------------------------------------------
# the family dispatch: the session engine's fold runs over the fixed,
# SALSA and two-stage families through these

def sk_update(state, keys: torch.Tensor, weights: torch.Tensor,
              mask: torch.Tensor):
    """Family-dispatching update (fixed / salsa / two-stage)."""
    if isinstance(state, CMSState):
        return update(state, keys, weights, mask)
    if isinstance(state, CMS2State):
        return update2(state, keys, weights, mask)
    from streambench_tpu_torch.ops import salsa

    if isinstance(state, salsa.SalsaState):
        return salsa.update(state, keys, weights, mask)
    raise TypeError(f"not a sketch state: {type(state).__name__}")


def point_query(state, keys: torch.Tensor) -> torch.Tensor:
    """Family-dispatching point query: two-stage reads the SMALL stage,
    SALSA the widest merged counter."""
    if isinstance(state, CMSState):
        return query(state, keys)
    if isinstance(state, CMS2State):
        return query_small(state, keys)
    from streambench_tpu_torch.ops import salsa

    if isinstance(state, salsa.SalsaState):
        return salsa.query(state, keys)
    raise TypeError(f"not a sketch state: {type(state).__name__}")


def update_query(state, keys: torch.Tensor, weights: torch.Tensor,
                 mask: torch.Tensor):
    """``sk_update`` then ``point_query`` of the same keys: (state,
    estimates).  Fixed and two-stage update in place, in one fused K3
    call (``cmsrows.cms_update_query`` / ``cms2_update_query``); SALSA
    returns a new state from ``salsa.update``, then ``salsa.query``."""
    if isinstance(state, CMSState):
        return state, cmsrows.cms_update_query(state.table, state.total,
                                               keys, weights, mask)
    if isinstance(state, CMS2State):
        return state, cmsrows.cms2_update_query(
            state.fat.table, state.small, state.fat.total, keys, weights,
            mask)
    from streambench_tpu_torch.ops import salsa

    if isinstance(state, salsa.SalsaState):
        state = salsa.update(state, keys, weights, mask)
        return state, salsa.query(state, keys)
    raise TypeError(f"not a sketch state: {type(state).__name__}")


def sk_total(state) -> torch.Tensor:
    """Total folded weight for any family."""
    return state.fat.total if isinstance(state, CMS2State) else state.total


def top_k(values: torch.Tensor, k: int) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest values, ties to the lowest
    index, and their indices."""
    idx = torch.sort(values, descending=True, stable=True).indices[:k]
    return values[idx], idx


def heavy_hitters(state, candidate_keys: torch.Tensor, *, k: int = 16):
    """Top-k candidates by sketch estimate: (values, indices into the
    candidates), over any family.  Cost is linear in the candidates."""
    return top_k(point_query(state, candidate_keys), k)


class TopKState(NamedTuple):
    """The device-resident heavy-hitter candidate ring: ``keys [M]``
    (int32 interned ids, -1 empty) with their last-queried estimates
    ``ests [M]`` (-1 for empty slots).  Report cost is O(M)."""

    keys: torch.Tensor
    ests: torch.Tensor


def init_topk(capacity: int = 128,
              device: torch.device | str = "cpu") -> TopKState:
    return TopKState(
        keys=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        ests=torch.full((capacity,), -1, dtype=torch.int32, device=device))


def init_candidates(capacity: int, device: torch.device | str = "cpu"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """A fresh chunk-local candidate table for ``fold_candidates``."""
    if capacity & (capacity - 1):
        raise ValueError("candidate capacity must be a power of two")
    return (torch.full((capacity,), -1, dtype=torch.int32, device=device),
            torch.full((capacity,), -1, dtype=torch.int32, device=device))


def fold_candidates(cand_keys: torch.Tensor, cand_ests: torch.Tensor,
                    keys: torch.Tensor, ests: torch.Tensor,
                    mask: torch.Tensor,
                    salt) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold one batch into a hash-slotted candidate table: O(B), no sort.

    Each key competes for ONE slot salted by ``salt`` (an int or a 0-dim
    tensor; the caller varies it chunk to chunk); the winner is decided
    by (estimate, key) through two scatter-max passes, so ties are
    deterministic.  A collision shadows the lighter key for this chunk
    only."""
    M2 = cand_keys.shape[0]
    k = keys.to(torch.int32)
    if isinstance(salt, torch.Tensor):
        salt = salt.to(torch.int64) & _U32
    else:
        salt = int(salt) & _U32
    h = splitmix32((k.to(torch.int64) & _U32) ^ 0xA5A5A5A5 ^ salt)
    slot = (h & (M2 - 1)).to(torch.int64)
    e = torch.where(mask, ests, -1).to(torch.int32)
    best = torch.cat([cand_ests, cand_ests.new_full((1,), -1)])
    best.scatter_reduce_(0, torch.where(mask, slot, M2), e, "amax",
                         include_self=True)
    best = best[:M2]
    # the occupant keeps the slot where it still holds the max; ties
    # between occupant and batch (or within the batch) go to the max key
    win = mask & (e >= best[slot])
    new_keys = torch.cat([torch.where(best == cand_ests, cand_keys, -1),
                          cand_keys.new_full((1,), -1)])
    new_keys.scatter_reduce_(0, torch.where(win, slot, M2),
                             torch.where(win, k, -1), "amax",
                             include_self=True)
    return new_keys[:M2], best


def update_topk(state, topk: TopKState, keys: torch.Tensor,
                mask: torch.Tensor) -> TopKState:
    """Fold one batch of (masked) keys into the candidate ring.

    Ring + batch, deduped by key keeping the largest estimate (grouped by
    key ascending, largest estimate first), then the top M by estimate.
    ``state`` is any sketch family (``point_query``)."""
    M = topk.keys.shape[0]
    est = torch.where(mask, point_query(state, keys), -1).to(torch.int32)
    k_new = torch.where(mask, keys.to(torch.int32), -1)
    allk = torch.cat([topk.keys, k_new])
    alle = torch.cat([topk.ests, est])
    # lexsort((-alle, allk)): key ascending, then estimate descending
    order = torch.argsort(-alle, stable=True)
    order = order[torch.argsort(allk[order], stable=True)]
    k_sorted = allk[order]
    e_sorted = alle[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=allk.device),
                       k_sorted[1:] != k_sorted[:-1]])
    keep = first & (k_sorted >= 0)
    vals, idx = top_k(torch.where(keep, e_sorted, -1), M)
    return TopKState(keys=torch.where(vals >= 0, k_sorted[idx], -1),
                     ests=vals)
