"""K2's launch plan and slot table (``streambench_tpu_torch.ops.decode``).

The CUDA kernel runs only on the card, but what it is given is decided
here, in Python: ``decode_plan`` picks the tier (the slot table staged in
shared memory, or read from global memory), the block size and the grid,
and ``slot_meta`` packs the table it probes (a tag, the value and a used
bit per slot).  These tests hold the plan's tiers, thresholds and block
sizes, the tags and the used mask against the JAX package's
``build_ad_table``, and a numpy model of the kernel's lookup order (tag
compare, key verify, stop at the first unused slot) against the
reference's ``_decode_columns`` on the CPU, on tables with a forced hash
collision, an all-zero ad, unknown ads and ads at every probe depth.
Every value is an integer, so every comparison is exact (tolerance 0).
"""

import ctypes
import random
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from streambench_tpu.ops import devdecode as jdd
from streambench_tpu_torch.ops import _build
from streambench_tpu_torch.ops import decode as tdec
from streambench_tpu_torch.ops import devdecode as tdd
from streambench_tpu_torch.utils.ids import make_ids

torch.set_num_threads(1)

H100 = dict(sms=132)
SMALL_MAX = tdec.SMALL_ROWS_PER_SM * H100["sms"]        # 16,896 rows
CONFIG1_T = 2048


# ----------------------------------------------------------------------
# decode_plan
def covered_rows(plan: tdec.DecodePlan, rows: int) -> np.ndarray:
    """Every row the kernel's grid decodes: thread ``t`` of block ``b``
    takes row ``b * threads + t`` while it is below ``rows``."""
    r = np.arange(plan.blocks * plan.threads, dtype=np.int64)
    return r[r < rows]


@pytest.mark.parametrize("groups,B,kind", sorted(
    {(g, B, k) for _, g, B, k in chip_smoke.DECODE_CASES}))
def test_plan_covers_every_row_once_at_the_smoke_shapes(groups, B, kind):
    rows = groups * B
    T = 262_144 if kind == "bigtable" else CONFIG1_T
    plan = tdec.decode_plan(T, 1 << 20, 0, rows, **H100)
    assert plan.threads in (tdec.SMALL_THREADS, tdec.LARGE_THREADS)
    # no block without a row
    assert (plan.blocks - 1) * plan.threads < rows
    got = covered_rows(plan, rows)
    assert np.array_equal(np.sort(got), np.arange(rows))
    assert plan.tier == ("global" if kind == "bigtable" else "smem")


def test_plan_spreads_the_main_dispatch_over_most_sms():
    """The stock catchup's dispatch: 4,096 real rows, then 4,096 pad rows,
    in one 8,192-row group.  64-thread blocks, one row a thread, put the
    real rows on 64 blocks (256-thread blocks would use 16)."""
    plan = tdec.decode_plan(CONFIG1_T, 1_040_842, 0, 8192, **H100)
    assert plan == tdec.DecodePlan("smem", 64, 128, 16_640, True)
    real_blocks = np.unique(np.arange(4096) // plan.threads)
    assert real_blocks.size == 64


@pytest.mark.parametrize("rows,threads,blocks", [
    (1, 64, 1), (64, 64, 1), (65, 64, 2), (8192, 64, 128),
    (16_384, 64, 256), (SMALL_MAX, 64, 264),
    (SMALL_MAX + 1, 256, 67), (32_768, 256, 128), (65_536, 256, 256),
    (524_288, 256, 2048), (16_777_216, 256, 65_536)])
def test_plan_block_size_and_grid(rows, threads, blocks):
    plan = tdec.decode_plan(CONFIG1_T, 1 << 30, 0, rows, **H100)
    assert (plan.threads, plan.blocks) == (threads, blocks)


@pytest.mark.parametrize("T,tier,smem", [
    (1, "smem", 48), (8, "smem", 80), (2048, "smem", 16_640),
    (4096, "smem", 33_280), (8192, "global", 0), (16_384, "global", 0),
    (32_768, "global", 0), (262_144, "global", 0)])
def test_plan_tier_by_table_size(T, tier, smem):
    plan = tdec.decode_plan(T, 1 << 20, 0, 8192, **H100)
    assert (plan.tier, plan.smem_bytes) == (tier, smem)
    assert tdec.meta_bytes(T) % 16 == 0
    if tier == "smem":
        assert tdec.meta_bytes(T) == smem


@pytest.mark.parametrize("T", [2048, 16_384])
def test_plan_a_table_just_past_the_shared_memory_budget(T):
    """The smem tier takes a table whose meta and the kernel's static
    bytes fit the budget exactly; one byte less and it runs global."""
    fit = tdec.meta_bytes(T) + tdec.SMEM_STATIC
    assert tdec.decode_plan(T, 1 << 20, 0, 8192, fit, 132).tier == "smem"
    assert tdec.decode_plan(T, 1 << 20, 0, 8192, fit - 1,
                            132).tier == "global"


def test_plan_stays_within_the_default_shared_memory():
    """No plan stages more than the 48 KB a block takes without opting in,
    so the kernel never needs a larger dynamic shared memory attribute;
    the largest staged table has 4,096 slots (2,048 ads at load 0.5)."""
    for T in (1 << k for k in range(19)):
        plan = tdec.decode_plan(T, 1 << 20, 0, 8192, **H100)
        assert plan.smem_bytes + tdec.SMEM_STATIC <= 48 * 1024
        assert (plan.tier == "smem") is (T <= 4096)


@pytest.mark.parametrize("align,cap,vector", [
    (0, 1 << 20, True), (1, 1 << 20, False), (3, 1 << 20, False),
    (4, 1 << 20, False), (8, 1 << 20, False), (0, 16, True),
    (0, 15, False)])
def test_plan_vector_loads_need_an_aligned_buffer(align, cap, vector):
    assert tdec.decode_plan(CONFIG1_T, cap, align, 4096,
                            **H100).vector is vector


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="power of two"):
        tdec.decode_plan(3000, 1 << 20, 0, 4096, **H100)
    with pytest.raises(ValueError, match="at least one row"):
        tdec.decode_plan(CONFIG1_T, 1 << 20, 0, 0, **H100)


# ----------------------------------------------------------------------
# the slot table: tags, vals, used bits
def _tables(seed, n_ads, extra=()):
    """The port's table with its used mask, the reference's table, and
    the ads (``n_ads`` seeded uuids, then ``extra``) with their campaign
    indices (ten ads a campaign)."""
    rng = random.Random(seed)
    ads = [a.encode() for a in make_ids(n_ads, rng)]
    ads += [a.encode() if isinstance(a, str) else a for a in extra]
    cidx = np.arange(len(ads), dtype=np.int32) // 10
    return (tdd.build_ad_table(ads, cidx, with_used=True),
            jdd.build_ad_table(ads, cidx), ads, cidx)


@pytest.mark.parametrize("seed,n_ads", [(1, 10), (2, 300), (3, 1000),
                                        (4, 3)])
def test_used_mask_marks_the_slots_the_reference_filled(seed, n_ads):
    (keys, vals, probes, used), want, ads, cidx = _tables(seed, n_ads)
    assert np.array_equal(keys, want[0])
    assert np.array_equal(vals, want[1]) and probes == want[2]
    # every campaign index is >= 0: the reference filled exactly the
    # slots whose value is not -1
    assert np.array_equal(used, want[1] != -1)
    assert used.sum() == n_ads
    # without the keyword: the three values of the reference's signature
    three = tdd.build_ad_table(ads, cidx)
    assert len(three) == 3 and three[2] == probes
    assert np.array_equal(three[0], keys) and np.array_equal(three[1], vals)


@pytest.mark.parametrize("seed,n_ads", [(5, 1), (6, 3), (7, 200),
                                        (8, 1000)])
def test_slot_meta_tags_vals_and_used_bits(seed, n_ads):
    (keys, vals, _, used), _, _, _ = _tables(seed, n_ads)
    T = keys.shape[0]
    tp, up = tdec.meta_layout(T)
    meta = tdec.slot_meta(keys, vals, used)
    assert meta.dtype == np.uint32 and meta.size == 2 * tp + up
    assert meta.nbytes == tdec.meta_bytes(T) and meta.nbytes % 16 == 0
    for j in range(T):
        if used[j]:
            assert int(meta[j]) == tdd.fnv1a32(bytes(keys[j]))
        else:
            assert meta[j] == 0
    assert np.array_equal(meta[tp:tp + T].view(np.int32), vals)
    bits = np.unpackbits(meta[2 * tp:].view(np.uint8), bitorder="little")
    assert np.array_equal(bits[:T].astype(bool), used)
    assert not bits[T:].any() and not meta[T:tp].any()
    assert not meta[tp + T:2 * tp].any()


def test_fnv1a32_rows_matches_the_scalar_hash():
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 256, (50, 36), dtype=np.uint8)
    got = tdec.fnv1a32_rows(rows)
    assert [int(h) for h in got] == [tdd.fnv1a32(bytes(r)) for r in rows]
    a, b = (np.frombuffer(x.encode(), np.uint8)
            for x in chip_smoke.COLLIDING_ADS)
    c = np.frombuffer(chip_smoke.COLLIDING_UNKNOWN.encode(), np.uint8)
    h = tdec.fnv1a32_rows(np.stack([a, b, c]))
    assert h[0] == h[1] == h[2] == 0x20FE7885
    assert len({*chip_smoke.COLLIDING_ADS, chip_smoke.COLLIDING_UNKNOWN}) == 3


# ----------------------------------------------------------------------
# the kernel's lookup order, as numpy, against _decode_columns
def kernel_lookup(ad: np.ndarray, keys: np.ndarray, meta: np.ndarray,
                  probes: int):
    """``csrc/decode_rows.cu``'s probe loop over ``slot_meta``: per row
    the campaign, the probes taken, and the tag matches whose key did not
    verify."""
    T = keys.shape[0]
    tp, _ = tdec.meta_layout(T)
    tags = meta[:T]
    vals = meta[tp:tp + T].view(np.int32)
    used_words = meta[2 * tp:]
    h = tdec.fnv1a32_rows(ad)
    camp = np.full(ad.shape[0], -1, np.int32)
    taken = np.zeros(ad.shape[0], np.int64)
    false_tags = 0
    for r in range(ad.shape[0]):
        slot = int(h[r]) & (T - 1)
        for _ in range(probes):
            taken[r] += 1
            if not (int(used_words[slot >> 5]) >> (slot & 31)) & 1:
                break
            if tags[slot] == h[r]:
                if np.array_equal(keys[slot], ad[r]):
                    camp[r] = vals[slot]
                    break
                false_tags += 1
            slot = (slot + 1) & (T - 1)
    return camp, taken, false_tags


def _rows_buffer(ads: list[bytes], seed: int):
    """Generator-format rows (``chip_smoke._event_line``), one per ad id
    (36 bytes each, any bytes), as the decode's buffer, starts and lens."""
    rng = random.Random(seed)
    users = make_ids(5, rng)
    lines = []
    for i, ad in enumerate(ads):
        line = chip_smoke._event_line(rng, users, 1_723_000_000_000 + i,
                                      ("view", "click", "purchase")[i % 3],
                                      "X" * 36).encode()
        lines.append(line.replace(b"X" * 36, ad))
    data = b"\n".join(lines) + b"\n"
    starts = np.zeros(len(ads), np.int32)
    lens = np.zeros(len(ads), np.int32)
    pos = 0
    for i, line in enumerate(lines):
        starts[i], lens[i] = pos, len(line)
        pos += len(line) + 1
    return np.frombuffer(data, np.uint8).copy(), starts, lens


def _reference_campaign(buf, starts, lens, keys, vals, probes):
    out = jdd._decode_columns(
        jnp.asarray(buf), jnp.asarray(starts), jnp.asarray(lens),
        jnp.asarray(keys), jnp.asarray(vals), jnp.int32(0), jnp.int32(0),
        probes)
    return np.asarray(out[0])


def _check_against_reference(keys, vals, used, probes, row_ads, seed):
    buf, starts, lens = _rows_buffer(row_ads, seed)
    want = _reference_campaign(buf, starts, lens, keys, vals, probes)
    ad = np.stack([np.frombuffer(a, np.uint8) for a in row_ads])
    got, taken, false_tags = kernel_lookup(ad, keys,
                                           tdec.slot_meta(keys, vals, used),
                                           probes)
    assert np.array_equal(got, want)
    return got, taken, false_tags


def test_lookup_with_a_forced_hash_collision():
    """Two table ads share one FNV-1a hash and a third, unknown ad has it
    too: the second ad's probe passes the first's slot (tag equal, key
    not), the unknown one passes both and stops at the first unused
    slot."""
    a, b = (x.encode() for x in chip_smoke.COLLIDING_ADS)
    c = chip_smoke.COLLIDING_UNKNOWN.encode()
    (keys, vals, probes, used), _, ads, _ = _tables(
        11, 200, extra=chip_smoke.COLLIDING_ADS)
    row_ads = [a, b, c, *ads[:50]]
    got, taken, false_tags = _check_against_reference(
        keys, vals, used, probes, row_ads, 11)
    assert got[0] >= 0 and got[1] >= 0 and got[2] == -1
    assert false_tags >= 3          # b passes a's slot; c passes both
    assert taken[2] < probes or probes <= 3


@pytest.mark.parametrize("zero_in_table", [False, True])
def test_lookup_of_an_all_zero_ad(zero_in_table):
    """An all-zero ad equals an unused slot's key: the reference takes
    that slot's -1, the kernel stops there with -1; when the table holds
    the all-zero ad itself, both find it before any unused slot."""
    zero = bytes(36)
    extra = (zero,) if zero_in_table else ()
    (keys, vals, probes, used), _, ads, _ = _tables(12, 100, extra=extra)
    row_ads = [zero, *ads[:20], ads[-1], zero]
    got, _, _ = _check_against_reference(keys, vals, used, probes,
                                         row_ads, 12)
    assert bool(got[0] >= 0) is zero_in_table and got[0] == got[-1]


def test_lookup_of_unknown_ads_stops_at_the_first_unused_slot():
    (keys, vals, probes, used), _, ads, _ = _tables(13, 500)
    unknown = [x.encode() for x in make_ids(300, random.Random(1013))]
    got, taken, _ = _check_against_reference(
        keys, vals, used, probes, unknown + [ads[0]], 13)
    assert (got[:-1] == -1).all() and got[-1] >= 0
    # at load <= 0.5 most unknown ads stop well before the probe bound
    assert taken[:-1].mean() < probes


@pytest.mark.parametrize("seed", [14, 15])
def test_lookup_reaches_ads_at_every_probe_depth(seed):
    """Every ad of a table whose chains run deep, each looked up once: the
    kernel's probe stops exactly at the depth the ad was inserted at (no
    unused slot cuts a chain short), the deepest at the probe bound; a
    smaller bound than the table's gives the reference's answer too."""
    for n in (40, 120, 250, 500, 1000):
        (keys, vals, probes, used), _, row_ads, _ = _tables(seed, n)
        if probes >= 4:
            break
    got, taken, _ = _check_against_reference(keys, vals, used, probes,
                                             row_ads, seed)
    T = keys.shape[0]
    ad = np.stack([np.frombuffer(a, np.uint8) for a in row_ads])
    home = tdec.fnv1a32_rows(ad).astype(np.int64) & (T - 1)
    slot = np.asarray([int(np.flatnonzero((keys == r).all(axis=1))[0])
                       for r in ad])
    assert (got >= 0).all()
    assert np.array_equal(taken, (slot - home) % T + 1)
    assert taken.min() == 1 and taken.max() == probes
    _check_against_reference(keys, vals, used, 2, row_ads, seed)


# ----------------------------------------------------------------------
# the wrapper: the plan and the new arguments reach the library
def test_launch_passes_the_plan_meta_and_table(monkeypatch):
    (keys, vals, probes, used), _, ads, _ = _tables(16, 30)
    buf, starts, lens = _rows_buffer(ads, 16)
    meta = torch.from_numpy(tdec.slot_meta(keys, vals, used).view(np.int32))
    t = [torch.from_numpy(x) for x in (buf, starts, lens, keys)]
    outs = (torch.empty(starts.shape, dtype=torch.int32),
            torch.empty(starts.shape, dtype=torch.bool),
            torch.empty(starts.shape, dtype=torch.int32),
            torch.empty(starts.shape, dtype=torch.bool))
    seen = []

    class Lib:
        def sb_decode_rows(self, *a):
            # read the plan while the call holds it, as the kernel does
            plan = ctypes.cast(a[15], ctypes.POINTER(tdec._PlanArgs)).contents
            seen.append((a, {f: getattr(plan, f) for f, _ in
                             tdec._PlanArgs._fields_}))
            return 0

    monkeypatch.setattr(_build, "decode_rows_lib", lambda: Lib())
    monkeypatch.setattr(tdec, "device_limits", lambda index: (132, 232_448))
    tdec._cached_plan.cache_clear()
    plan = tdec._cached_plan(keys.shape[0], buf.size, 1, starts.size, 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1234, raising=False)
    before = tdec.decode_rows.launches
    tdec._launch(*t, meta, probes, 7, 8, outs, 0, plan)
    tdec._cached_plan.cache_clear()
    assert tdec.decode_rows.launches == before + 1
    args, fields = seen[-1]
    assert args[0] == t[0].data_ptr() and args[1] == buf.size
    assert args[4] == starts.size and args[5] == t[3].data_ptr()
    assert args[6] == meta.data_ptr() and args[7] == keys.shape[0]
    assert args[8:11] == (probes, 7, 8)
    assert args[11:15] == tuple(o.data_ptr() for o in outs)
    assert args[16] == 1234
    want = tdec.decode_plan(keys.shape[0], buf.size, 1, starts.size,
                            sms=132)
    assert fields == {"smem_tier": 1, "threads": want.threads,
                      "blocks": want.blocks,
                      "smem_bytes": want.smem_bytes, "vector": 0}


def test_meta_checks_name_what_is_wrong():
    (keys, vals, probes, used), _, _, _ = _tables(17, 30)
    k = torch.from_numpy(keys)
    good = torch.from_numpy(tdec.slot_meta(keys, vals, used).view(np.int32))
    buf = torch.zeros(4096, dtype=torch.uint8)
    tdec._check_meta(good, k, buf)
    with pytest.raises(ValueError, match="meta must be a contiguous int32"):
        tdec._check_meta(good[:-4], k, buf)
    with pytest.raises(ValueError, match="meta must be a contiguous int32"):
        tdec._check_meta(good.view(torch.uint8), k, buf)
    shifted = torch.zeros(good.numel() + 1, dtype=torch.int32)[1:]
    shifted.copy_(good)
    with pytest.raises(ValueError, match="16-byte"):
        tdec._check_meta(shifted, k, buf)
    with pytest.raises(ValueError, match="is on"):
        tdec._check_meta(good.to("meta"), k, buf)
    # the CPU arm runs the plain version and needs no meta
    s = torch.zeros(8, dtype=torch.int32)
    out = tdec.decode_rows(buf, s, s, k, torch.from_numpy(vals), probes, 0,
                           0)
    assert not out[3].any()
