"""K1's launch plan (``streambench_tpu_torch.ops.count.launch_plan``).

The CUDA kernel runs only on the card, but where its rows go is decided
here, in Python: the plan splits ``[0, B)`` into an unaligned head, runs
of 4 rows read with 16-byte vector loads, and a ragged tail, and sizes
the grid.  ``walk`` replays the kernel's grid-stride loop over that plan
(``csrc/count_cells.cu``, ``count_cells_kernel``) and ``unit_rows`` the
rows of each unit it visits, so these tests can hold the partition, the
alignment of every vector load and the shared memory a block needs, at
every shape ``chip_smoke.py`` launches and at the tier thresholds.  The
plain version is also held against the Pallas kernel (interpret mode) on
the inputs ``chip_smoke.py`` adds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from streambench_tpu.ops.pallas_count import count_tiles
from streambench_tpu_torch.ops.count import (PRIVATE_MIN_ROWS,
                                             ROWS_PER_THREAD, LaunchPlan,
                                             count_cells, count_cells_plain,
                                             launch_plan)

torch.set_num_threads(1)

H100 = dict(sms=132, smem_optin=232_448)
SMOKE_SHAPES = sorted({(B, C, W) for _, B, C, W, _ in chip_smoke.CASES})
SMALL_ROWS = [0, 1, 3, 5, 31, 4097]
# one row either side of the direct/private threshold, on the stock plane
# and on a 16,000-cell one
THRESHOLD_SHAPES = [(PRIVATE_MIN_ROWS + C * W + d, C, W)
                    for C, W in ((100, 16), (1000, 16)) for d in (-1, 0)]
ALIGNS = [(4 * k % 16, 4 * k % 16, k % 16) for k in range(4)]


def units(plan: LaunchPlan) -> int:
    """A thread's work items: the runs, then the head and tail if any."""
    return plan.runs + (plan.head > 0) + (plan.tail > 0)


def unit_rows(plan: LaunchPlan, u: np.ndarray):
    """``(start, n, body)`` of units ``u``, as the kernel computes them."""
    R = ROWS_PER_THREAD
    body = u < plan.runs
    is_head = (plan.head > 0) & (u == plan.runs)
    start = np.where(body, plan.head + u * R,
                     np.where(is_head, 0, plan.head + plan.runs * R))
    n = np.where(body, R, np.where(is_head, plan.head, plan.tail))
    n = np.where(u < units(plan), n, 0)
    return start, n, body


def walk(plan: LaunchPlan):
    """The units each thread of the grid visits, in the kernel's loop:
    thread ``t`` takes ``t, t + threads, t + 2 * threads, ...`` below
    ``units``, where ``threads`` is the whole grid's."""
    threads = plan.blocks * plan.threads
    steps = -(-units(plan) // threads)
    u = (np.arange(threads, dtype=np.int64)[:, None]
         + threads * np.arange(steps, dtype=np.int64)).reshape(-1)
    return u[u < units(plan)]


def check_partition(plan: LaunchPlan, B: int, align, simulate_grid=True):
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert 1 <= plan.blocks < 2**31
    assert plan.smem_bytes <= 232_448
    assert plan.head + plan.runs * ROWS_PER_THREAD + plan.tail == B
    assert 0 <= plan.head < 4 and 0 <= plan.tail < ROWS_PER_THREAD
    if simulate_grid:
        u = walk(plan)
        assert np.array_equal(np.sort(u), np.arange(units(plan)))
    else:
        u = np.arange(units(plan), dtype=np.int64)
    start, n, body = unit_rows(plan, u)
    bstart = start[body]
    order = np.argsort(start, kind="stable")
    start, n = start[order], n[order]
    # the units' row ranges tile [0, B): no gap, no overlap, no empty unit
    assert (n > 0).all()
    if B:
        assert start[0] == 0 and start[-1] + n[-1] == B
        assert np.array_equal(start[1:], start[:-1] + n[:-1])
    # every vector load is aligned: int4 for campaign and slot, one
    # 4-byte word for the mask
    camp_off, slot_off, mask_off = align
    assert ((camp_off + 4 * bstart) % 16 == 0).all()
    if plan.vector_slot:
        assert ((slot_off + 4 * bstart) % 16 == 0).all()
    if plan.vector_mask:
        assert ((mask_off + bstart) % 4 == 0).all()


@pytest.mark.parametrize("align", ALIGNS, ids=lambda a: f"head{a[2]}")
@pytest.mark.parametrize("B,C,W", SMOKE_SHAPES + THRESHOLD_SHAPES
                         + [(B, 100, 16) for B in SMALL_ROWS])
def test_plan_covers_every_row_once_with_aligned_vector_loads(B, C, W,
                                                              align):
    plan = launch_plan(B, C, W, align, **H100)
    check_partition(plan, B, align, simulate_grid=B <= 65536)


@pytest.mark.parametrize("align,vec_slot,vec_mask", [
    ((0, 0, 0), True, True),
    ((4, 4, 1), True, True),        # the smoke's 1-row views: head 3
    ((12, 12, 3), True, True),      # 3-row views: head 1
    ((0, 4, 0), False, True),       # slot 1 row off campaign: scalar slot
    ((0, 0, 2), True, False),       # mask 2 bytes off: scalar mask
])
def test_plan_reads_an_array_with_scalar_loads_when_its_alignment_differs(
        align, vec_slot, vec_mask):
    plan = launch_plan(4096, 100, 16, align, **H100)
    assert (plan.vector_slot, plan.vector_mask) == (vec_slot, vec_mask)
    check_partition(plan, 4096, align)


def test_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="4-byte aligned"):
        launch_plan(16, 3, 4, (2, 0, 0))
    with pytest.raises(ValueError, match="more than"):
        launch_plan(16, 2**20, 2**11)


@pytest.mark.parametrize("B,C,W,tier", [
    (4096, 100, 16, "direct"),          # main path: a half batch
    (8192, 100, 16, "private"),         # one micro-batch
    (65536, 100, 16, "private"),        # one scan group
    (300, 7, 5, "direct"),              # ragged
    (8192, 1_000_000, 16, "global"),    # BASELINE #5: plane > 227 KB
    (16_777_216, 100, 16, "private"),   # bandwidth case
] + [(B, C, W, "direct" if B < PRIVATE_MIN_ROWS + C * W else "private")
     for B, C, W in THRESHOLD_SHAPES])
def test_tier_at_each_smoke_shape_is_the_one_perf_md_states(B, C, W, tier):
    plan = launch_plan(B, C, W, **H100)
    assert plan.tier == tier
    assert plan.smem_bytes == (4 * C * W if tier == "private" else 0)
    if tier == "private":
        assert plan.blocks <= H100["sms"]


def _inputs(kind, B=4096, C=100, W=16, seed=7):
    rng = np.random.default_rng(seed)
    camp = ((rng.zipf(1.2, B + 3) - 1) % C).astype(np.int32)
    slot = rng.integers(0, W, B + 3, dtype=np.int32)
    mask = rng.random(B + 3) >= 0.3
    if kind == "hot":
        camp[:], slot[:] = C // 2, W - 1
    elif kind == "all_masked":
        mask[:] = False
    elif kind == "all_out_of_plane":
        mask[:] = True
        camp[::2] += C
        slot[1::2] = -1 - slot[1::2]
    off = int(kind[6:]) if kind.startswith("offset") else 0
    counts = rng.integers(0, 50, (C, W), dtype=np.int32)
    return counts, camp[off:off + B], slot[off:off + B], mask[off:off + B]


@pytest.mark.parametrize("kind", ["hot", "all_masked", "all_out_of_plane",
                                  "offset1", "offset3"])
def test_plain_matches_pallas_on_the_smokes_new_inputs(kind):
    counts, camp, slot, mask = _inputs(kind)
    want = np.asarray(count_tiles(
        jnp.asarray(counts), jnp.asarray(camp), jnp.asarray(slot),
        jnp.asarray(mask), interpret=True))
    got = torch.from_numpy(counts.copy())
    count_cells_plain(got, torch.from_numpy(camp), torch.from_numpy(slot),
                      torch.from_numpy(mask))
    assert np.array_equal(got.numpy(), want)
    if kind in ("all_masked", "all_out_of_plane"):
        assert np.array_equal(want, counts)
    if kind == "hot":
        assert int((want - counts).sum()) == int(mask.sum())
        assert int((want - counts)[50, 15]) == int(mask.sum())


@pytest.mark.parametrize("off", [1, 3])
def test_wrapper_takes_misaligned_views_on_the_cpu(off):
    """Views that start mid-buffer, as the smoke's misaligned cases give
    the kernel, go through the wrapper's checks and count exactly."""
    counts, camp, slot, mask = _inputs("zipf", B=1000, seed=off)
    base = [torch.from_numpy(np.concatenate([np.zeros(off, a.dtype), a]))
            for a in (camp, slot, mask)]
    views = [t[off:] for t in base]
    assert all(v.storage_offset() == off for v in views)
    got = torch.from_numpy(counts.copy())
    count_cells(got, *views)
    want = counts.reshape(-1) + np.bincount(
        (camp.astype(np.int64) * 16 + slot)[mask], minlength=1600)
    assert np.array_equal(got.numpy().reshape(-1), want)
