"""K3 (``streambench_tpu_torch.ops.cmsrows``) on the CPU.

Its plain versions against the reference's ``cms._row_cols``,
``update``, ``query``, ``update2`` and ``query_small`` on seeded numpy
inputs, bit for bit (integers, no tolerance), the fused entry points
against the reference's pair (``update`` then ``query``) and triple
(``update2`` then ``query_small``); its launch plan (the wide update's
threshold, every row covered once); the wrappers refusing wrong dtypes,
shapes and devices; the launch paths through a stub library (a failed
launch raises and counts nothing; the plan and sizes reach the kernel; a
fused entry is one call, counted under each kernel it launches); the
nvcc command.  The kernel itself
runs only on the card: ``chip_smoke.py`` phase 3 holds it against these
plain versions there.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.ops import cms as jcms
from streambench_tpu_torch.ops import _build, cmsrows

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _inputs(seed, B, D=4, Wd=2048):
    """Keys as ``measure_cms`` draws them (Zipf 1.1) plus -1 and keys past
    2^28 and near the int32 ends, a third of the rows masked."""
    rng = np.random.default_rng(seed)
    k = np.minimum(rng.zipf(1.1, B), 2**28).astype(np.int32)
    k[::7] = -1
    k[1::11] = 2**28 + rng.integers(0, 2**20, k[1::11].size)
    k[2::13] = rng.choice([-2**31, 2**31 - 1, -2], k[2::13].size)
    w = rng.integers(0, 50, B).astype(np.int32)
    m = rng.random(B) >= 1 / 3
    table = rng.integers(0, 100, (D, Wd)).astype(np.int32)
    return k, w, m, table


@pytest.mark.parametrize("D,Wd", [(1, 1), (4, 2048), (8, 1 << 16)])
def test_row_cols_plain_matches_row_cols(D, Wd):
    k, *_ = _inputs(D, 4096, D, Wd)
    want = np.asarray(jcms._row_cols(_j(k), D, Wd))
    got = cmsrows.row_cols_plain(_t(k), D, Wd)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cmsrows.cms_cols(_t(k), D, Wd).numpy(),
                                  want)


@pytest.mark.parametrize("seed", range(3))
def test_update_plain_matches_update(seed):
    k, w, m, table = _inputs(seed, 8192)
    js = jcms.update(jcms.CMSState(_j(table), jnp.int32(17)), _j(k), _j(w),
                     _j(m))
    t, total = _t(table), torch.tensor(17, dtype=torch.int32)
    cmsrows.cms_update_plain(t, total, _t(k), _t(w), _t(m))
    np.testing.assert_array_equal(t.numpy(), np.asarray(js.table))
    assert int(total) == int(js.total)
    # the wrapper on CPU tensors is the plain version, mask as uint8 too
    t2, total2 = _t(table), torch.tensor(17, dtype=torch.int32)
    cmsrows.cms_update(t2, total2, _t(k), _t(w), _t(m.astype(np.uint8)))
    assert torch.equal(t2, t) and torch.equal(total2, total)


@pytest.mark.parametrize("seed", range(3))
def test_query_plain_matches_query(seed):
    k, _, _, table = _inputs(10 + seed, 5000)
    want = np.asarray(jcms.query(jcms.CMSState(_j(table), jnp.int32(0)),
                                 _j(k)))
    got = cmsrows.cms_query_plain(_t(table), _t(k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cmsrows.cms_query(_t(table), _t(k)).numpy(),
                                  want)


@pytest.mark.parametrize("Ws", [64, 256])
def test_refresh_small_plain_matches_update2(Ws):
    """``update2`` = the fat update, then the small refresh."""
    k, w, m, table = _inputs(20, 8192)
    rng = np.random.default_rng(21)
    small = rng.integers(0, 3000, (4, Ws)).astype(np.int32)
    js = jcms.update2(jcms.CMS2State(
        jcms.CMSState(_j(table), jnp.int32(0)), _j(small)), _j(k), _j(w),
        _j(m))
    fat, total, sm = _t(table), torch.tensor(0, dtype=torch.int32), _t(small)
    cmsrows.cms_update(fat, total, _t(k), _t(w), _t(m))
    cmsrows.cms_refresh_small(fat, sm, _t(k), _t(m))
    np.testing.assert_array_equal(fat.numpy(), np.asarray(js.fat.table))
    np.testing.assert_array_equal(sm.numpy(), np.asarray(js.small))


def test_masked_rows_touch_nothing():
    k, w, _, table = _inputs(30, 1000)
    m = np.zeros(1000, bool)
    t, total = _t(table), torch.tensor(5, dtype=torch.int32)
    cmsrows.cms_update(t, total, _t(k), _t(w), _t(m))
    small = torch.full((4, 64), -7, dtype=torch.int32)
    cmsrows.cms_refresh_small(t, small, _t(k), _t(m))
    assert torch.equal(t, _t(table)) and int(total) == 5
    assert (small == -7).all()


def test_cpu_calls_count_no_launch():
    before = cmsrows.launches()
    k, w, m, table = _inputs(31, 256)
    cmsrows.cms_update(_t(table), torch.tensor(0, dtype=torch.int32), _t(k),
                       _t(w), _t(m))
    cmsrows.cms_query(_t(table), _t(k))
    cmsrows.cms_cols(_t(k), 4, 2048)
    cmsrows.cms_refresh_small(_t(table), torch.zeros((4, 64),
                                                     dtype=torch.int32),
                              _t(k), _t(m))
    cmsrows.cms_update_query(_t(table), torch.tensor(0, dtype=torch.int32),
                             _t(k), _t(w), _t(m))
    cmsrows.cms2_update_query(_t(table), torch.zeros((4, 64),
                                                     dtype=torch.int32),
                              torch.tensor(0, dtype=torch.int32), _t(k),
                              _t(w), _t(m))
    assert cmsrows.launches() == before
    assert set(before) == {"cms_update", "cms_query", "cms_refresh_small",
                           "cms_cols", "cms_update_query",
                           "cms2_update_query"}


# ----------------------------------------------------------------------
@pytest.mark.parametrize("B,blocks", [(0, 0), (1, 1), (256, 1), (257, 2),
                                      (8192, 32), (2**22, 16384)])
def test_launch_plan_covers_every_row_once(B, blocks):
    plan = cmsrows.launch_plan(B)
    assert plan.threads == cmsrows.THREADS == 256
    assert plan.blocks == blocks
    assert plan.blocks * plan.threads >= B > (plan.blocks - 1) * plan.threads


def test_launch_plan_refuses_negative_rows():
    with pytest.raises(ValueError, match="negative"):
        cmsrows.launch_plan(-1)


def _args():
    k, w, m, table = _inputs(40, 64)
    return (_t(table), torch.tensor(0, dtype=torch.int32), _t(k), _t(w),
            _t(m))


@pytest.mark.parametrize("bad,match", [
    (lambda a: (a[0].long(),) + a[1:], "2-D int32"),
    (lambda a: (a[0][:, ::2],) + a[1:], "2-D int32"),
    (lambda a: (a[0][:, :100].contiguous(),) + a[1:], "power of two"),
    (lambda a: (torch.zeros((9, 64), dtype=torch.int32),) + a[1:],
     "1 <= D <= 8"),
    (lambda a: (a[0], a[1].long()) + a[2:], "0-dim int32"),
    (lambda a: (a[0], a[1].reshape(1)) + a[2:], "0-dim int32"),
    (lambda a: a[:2] + (a[2].long(),) + a[3:], "keys must be"),
    (lambda a: a[:3] + (a[3].float(), a[4]), "weights must be"),
    (lambda a: a[:4] + (a[4].int(),), "mask must be"),
    (lambda a: a[:3] + (a[3][:10], a[4]), "rows"),
    (lambda a: a[:2] + (a[2][::2],) + a[3:], "contiguous 1-D"),
    (lambda a: tuple(t.to("meta") for t in a), "runs on cuda or cpu"),
], ids=["table_int64", "table_strided", "width_not_pow2", "depth_9",
        "total_int64", "total_1d", "keys_int64", "weights_float",
        "mask_int32", "rows_mismatch", "keys_strided", "meta_device"])
def test_update_wrapper_refuses_wrong_inputs(bad, match):
    with pytest.raises(ValueError, match=match):
        cmsrows.cms_update(*bad(_args()))


def test_other_wrappers_refuse_wrong_inputs():
    table, _, k, _, m = _args()
    with pytest.raises(ValueError, match="keys must be"):
        cmsrows.cms_query(table, k.long())
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        cmsrows.cms_query(table.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="is on"):
        cmsrows.cms_query(table, k.to("meta"))
    with pytest.raises(ValueError, match="does not match fat"):
        cmsrows.cms_refresh_small(table, torch.zeros((2, 64),
                                                     dtype=torch.int32), k, m)
    with pytest.raises(ValueError, match="power of two"):
        cmsrows.cms_cols(k, 4, 100)
    with pytest.raises(ValueError, match="depth"):
        cmsrows.cms_cols(k, 9, 64)


def test_launch_raises_on_a_cuda_error_and_passes_the_plan(monkeypatch):
    """The launch path with a stub library: the plan's blocks and threads
    and the sizes reach the entry point; a non-zero CUDA error raises."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1234, raising=False)
    calls = []

    def entry(rc):
        def sb_cms_query(*a):
            calls.append(a)
            return rc
        return sb_cms_query

    dev = torch.device("cuda", 0)
    cmsrows._launch(entry(0), dev, 300, 11, 22, 33, 4, 2048, 300)
    assert calls[-1] == (11, 22, 33, 4, 2048, 300, 2, 256, 1234)
    with pytest.raises(RuntimeError, match="sb_cms_query kernel launch "
                                           "failed: CUDA error 209"):
        cmsrows._launch(entry(209), dev, 300, 11, 22, 33, 4, 2048, 300)


def test_build_targets_hopper_and_stays_lazy(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build._nvcc(_build.CMS_ROWS_SRC)("out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith(os.path.join("csrc", "cms_rows.cu"))
    assert _build.cms_rows_lib.lib is None


def test_kernel_source_names_what_it_replaces_and_its_bound():
    with open(_build.CMS_ROWS_SRC) as f:
        src = f.read()
    for needle in ("streambench_tpu/ops/cms.py", "1 B of mask a row",
                   "an empty kernel", "sm_90a", "sb_cms_update",
                   "sb_cms_query", "sb_cms_refresh_small", "sb_cms_cols",
                   # what the fused entry points replace, in one call
                   "sb_cms_update_query", "_row_cols (:43)", "update (:53)",
                   "query (:88)", "update2 (:145)", "query_small (:164)",
                   "_session_cms_scan, :1083-1125", "in one call",
                   "One tier", "WIDE_MIN_ROWS = 2^16", "The threshold",
                   "chip_smoke.py phase 3", "H100 80GB HBM3",
                   # duplicate keys kept off L2
                   "hot-key table", "atomicCAS", "16 bytes at a time",
                   # what was measured and left out
                   "Measured and left out", "__match_any_sync",
                   "thread block cluster"):
        assert needle in src, needle
    salts = ", ".join(f"0x{s:08X}u" for s in cmsrows.SALTS[:3])
    assert salts in src



# ----------------------------------------------------------------------
# the fused entry points' plain versions against the reference

def _kind(k, w, m, kind):
    """The edge cases of the fused entry points' inputs."""
    if kind == "all_out":
        m = np.zeros_like(m)
    elif kind == "all_in":
        m = np.ones_like(m)
    elif kind == "empty":
        k, w, m = k[:0], w[:0], m[:0]
    return k, w, m


@pytest.mark.parametrize("kind", ["mixed", "all_out", "all_in", "empty"])
@pytest.mark.parametrize("D", range(1, 9))
def test_update_query_plain_matches_update_then_query(D, kind):
    k, w, m, table = _inputs(50 + D, 3000, D, 512)
    k, w, m = _kind(k, w, m, kind)
    js = jcms.update(jcms.CMSState(_j(table), jnp.int32(-9)), _j(k), _j(w),
                     _j(m))
    want = np.asarray(jcms.query(js, _j(k)))
    t, total = _t(table), torch.tensor(-9, dtype=torch.int32)
    got = cmsrows.cms_update_query_plain(t, total, _t(k), _t(w), _t(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t.numpy(), np.asarray(js.table))
    assert int(total) == int(js.total)
    # the wrapper on CPU tensors is the plain version
    t2, total2 = _t(table), torch.tensor(-9, dtype=torch.int32)
    got2 = cmsrows.cms_update_query(t2, total2, _t(k), _t(w),
                                    _t(m.astype(np.uint8)))
    assert torch.equal(got2, got) and torch.equal(t2, t)
    assert torch.equal(total2, total)


@pytest.mark.parametrize("kind", ["mixed", "all_out", "all_in", "empty"])
@pytest.mark.parametrize("D,Ws", [(1, 64), (3, 256), (4, 256), (8, 1024)])
def test_update2_query_plain_matches_update2_then_query_small(D, Ws, kind):
    k, w, m, table = _inputs(60 + D, 4000, D, 2048)
    k, w, m = _kind(k, w, m, kind)
    small = np.random.default_rng(61).integers(0, 3000, (D, Ws)).astype(
        np.int32)
    js = jcms.update2(jcms.CMS2State(
        jcms.CMSState(_j(table), jnp.int32(3)), _j(small)), _j(k), _j(w),
        _j(m))
    want = np.asarray(jcms.query_small(js, _j(k)))
    fat, sm = _t(table), _t(small)
    total = torch.tensor(3, dtype=torch.int32)
    got = cmsrows.cms2_update_query(fat, sm, total, _t(k), _t(w), _t(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fat.numpy(), np.asarray(js.fat.table))
    np.testing.assert_array_equal(sm.numpy(), np.asarray(js.small))
    assert int(total) == int(js.fat.total)


def test_fused_wrappers_refuse_wrong_inputs():
    table, total, k, w, m = _args()
    with pytest.raises(ValueError, match="0-dim int32"):
        cmsrows.cms_update_query(table, total.long(), k, w, m)
    with pytest.raises(ValueError, match="weights must be"):
        cmsrows.cms_update_query(table, total, k, w.float(), m)
    with pytest.raises(ValueError, match="does not match fat"):
        cmsrows.cms2_update_query(table, torch.zeros((2, 64),
                                                     dtype=torch.int32),
                                  total, k, w, m)
    with pytest.raises(ValueError, match="power of two"):
        cmsrows.cms2_update_query(table, torch.zeros((4, 48),
                                                     dtype=torch.int32),
                                  total, k, w, m)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        cmsrows.cms2_update_query(*(t.to("meta") for t in (
            table, torch.zeros((4, 64), dtype=torch.int32), total, k, w,
            m)))


# ----------------------------------------------------------------------
# the launch plan

@pytest.mark.parametrize("entry", ["cms_update_query", "cms2_update_query",
                                   "cms_update"])
def test_engine_step_plans_one_row_a_thread(entry):
    """The session engine's closed sets (8192 rows): the update one row a
    thread, no hot-key table (near-distinct interned users)."""
    plan = cmsrows.launch_plan(8192, entry=entry)
    assert plan == cmsrows.LaunchPlan(32, 256, 1, False)


@pytest.mark.parametrize("entry", ["cms_update_query", "cms2_update_query",
                                   "cms_update"])
def test_bandwidth_case_takes_the_wide_update(entry):
    plan = cmsrows.launch_plan(1 << 22, entry=entry)
    assert plan.rows_per_thread == 4 and plan.hot
    assert plan.blocks == (1 << 22) // (4 * cmsrows.THREADS)
    # misaligned rows load one a thread, still through the hot-key table
    one = cmsrows.launch_plan(1 << 22, entry=entry, aligned=False)
    assert one == cmsrows.LaunchPlan((1 << 22) // 256, 256, 1, True)


@pytest.mark.parametrize("entry,B,per_thread,hot", [
    ("cms_update", cmsrows.WIDE_MIN_ROWS - 1, 1, False),
    ("cms_update", cmsrows.WIDE_MIN_ROWS, 4, True),
    ("cms_update_query", cmsrows.WIDE_MIN_ROWS, 4, True),
    ("cms_query", 1 << 22, 1, False),
    ("cms_cols", 1 << 22, 1, False),
    ("cms_refresh_small", 1 << 22, 1, False),
])
def test_the_wide_threshold_is_the_updates_alone(entry, B, per_thread, hot):
    plan = cmsrows.launch_plan(B, entry=entry)
    assert (plan.rows_per_thread, plan.hot) == (per_thread, hot)


def _rows_covered(plan, B):
    """Each row's count of threads that take it, replayed as the kernels
    index (R rows a thread, consecutive)."""
    seen = np.zeros(B, np.int64)
    t = np.arange(plan.blocks * plan.threads)
    for j in range(plan.rows_per_thread):
        i = t * plan.rows_per_thread + j
        np.add.at(seen, i[i < B], 1)
    return seen


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("entry", ["cms_update_query", "cms2_update_query",
                                   "cms_update", "cms_query"])
@pytest.mark.parametrize("B", [1, 511, 8192, 8193, 40_000, 1 << 16,
                               (1 << 16) + 3, 300_001])
def test_every_plan_covers_every_row_once(entry, B, aligned):
    plan = cmsrows.launch_plan(B, entry=entry, aligned=aligned)
    assert (_rows_covered(plan, B) == 1).all()
    # no block is wholly past the rows
    assert (plan.blocks - 1) * plan.threads * plan.rows_per_thread < B


def test_plan_refusals():
    with pytest.raises(ValueError, match="no entry point"):
        cmsrows.launch_plan(100, entry="cms_merge")
    with pytest.raises(ValueError, match="negative"):
        cmsrows.launch_plan(-1, entry="cms_update_query")


# ----------------------------------------------------------------------
# the launch paths, through a stub library

class _StubLib:
    """Records each entry point's arguments; returns ``rc``."""

    def __init__(self, rc=0):
        self.calls = []
        for name in ("sb_cms_update", "sb_cms_query", "sb_cms_refresh_small",
                     "sb_cms_cols", "sb_cms_update_query"):
            setattr(self, name, self._entry(name, rc))

    def _entry(self, name, rc):
        def entry(*a):
            self.calls.append((name, a))
            return rc
        entry.__name__ = name
        return entry


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1234, raising=False)
    lib = _StubLib()
    monkeypatch.setattr(_build, "cms_rows_lib", lambda: lib)
    return lib


@pytest.mark.parametrize("two_stage", [False, True])
def test_fused_launch_is_one_call_with_its_plan(stub, two_stage):
    table, total, k, w, m = _args()
    small = torch.zeros((4, 64), dtype=torch.int32) if two_stage else None
    entry = "cms2_update_query" if two_stage else "cms_update_query"
    out = cmsrows._update_query(entry, table, small, total, k, w, m)
    assert out.shape == (64,) and out.dtype == torch.int32
    [(name, a)] = stub.calls
    assert name == "sb_cms_update_query"
    assert a[:5] == (table.data_ptr(), total.data_ptr(), k.data_ptr(),
                     w.data_ptr(), m.data_ptr())
    assert a[5] == (small.data_ptr() if two_stage else None)
    assert a[6] == out.data_ptr()
    assert a[7:] == (4, 2048, 64 if two_stage else 0, 64, 1, 256, 1, 0,
                     1234)


def test_wide_update_launch_passes_its_plan(stub, monkeypatch):
    monkeypatch.setattr(cmsrows, "_on_cuda", lambda device, what: True)
    B = cmsrows.WIDE_MIN_ROWS
    table = torch.zeros((4, 2048), dtype=torch.int32)
    k = torch.arange(B, dtype=torch.int32)
    w, m = torch.ones(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool)
    cmsrows.cms_update(table, torch.tensor(0, dtype=torch.int32), k, w, m)
    [(name, a)] = stub.calls
    assert name == "sb_cms_update"
    assert a[5:] == (4, 2048, B, B // 1024, 256, 4, 1, 1234)


@pytest.mark.parametrize("two_stage", [False, True])
def test_a_failed_fused_launch_raises(monkeypatch, stub, two_stage):
    """1 (cudaErrorInvalidValue): what the entry returns on a plan it
    cannot launch; no fallback, nothing counted."""
    failing = _StubLib(rc=1)
    monkeypatch.setattr(_build, "cms_rows_lib", lambda: failing)
    table, total, k, w, m = _args()
    small = torch.zeros((4, 64), dtype=torch.int32) if two_stage else None
    before = cmsrows.launches()
    with pytest.raises(RuntimeError, match="sb_cms_update_query kernel "
                                           "launch failed: CUDA error 1"):
        cmsrows._update_query("cms2_update_query" if two_stage else
                              "cms_update_query", table, small, total, k, w,
                              m)
    assert [n for n, _ in failing.calls] == ["sb_cms_update_query"]
    assert cmsrows.launches() == before


def test_fused_wrappers_on_the_card_launch_count_and_never_fall_back(
        monkeypatch, stub):
    """On a CUDA tensor (here: the device test patched to say so) each
    fused wrapper launches through the library in one call, adds one to
    its count and one to each kernel's it launched, and on a CUDA error
    raises without counting or running its plain version."""
    monkeypatch.setattr(cmsrows, "_on_cuda", lambda device, what: True)
    monkeypatch.setattr(cmsrows, "cms_update_query_plain", None)
    monkeypatch.setattr(cmsrows, "cms2_update_query_plain", None)
    table, total, k, w, m = _args()
    small = torch.zeros((4, 64), dtype=torch.int32)
    before = cmsrows.launches()
    kernels = cmsrows.kernel_launches()
    cmsrows.cms_update_query(table, total, k, w, m)
    cmsrows.cms2_update_query(table, small, total, k, w, m)
    cmsrows.cms_update_query(table, total, k[:0], w[:0], m[:0])  # no rows
    after = cmsrows.launches()
    grew = {n: after[n] - before[n] for n in after}
    assert grew == {"cms_update_query": 1, "cms2_update_query": 1,
                    "cms_update": 2, "cms_refresh_small": 1, "cms_query": 2,
                    "cms_cols": 0}
    assert cmsrows.kernel_launches() == kernels + 5
    assert [n for n, _ in stub.calls] == ["sb_cms_update_query"] * 2
    monkeypatch.setattr(_build, "cms_rows_lib", lambda: _StubLib(rc=700))
    for call in (lambda: cmsrows.cms_update_query(table, total, k, w, m),
                 lambda: cmsrows.cms2_update_query(table, small, total, k,
                                                   w, m)):
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            call()
    assert cmsrows.launches() == after


def test_fused_entry_takes_no_vector_loads_on_misaligned_rows(stub):
    """Keys one element into their storage cannot take 16-byte loads: at
    the wide update's rows the fused entry plans one row a thread, still
    through the hot-key table."""
    B = cmsrows.WIDE_MIN_ROWS
    table = torch.zeros((4, 2048), dtype=torch.int32)
    keys = torch.arange(B + 1, dtype=torch.int32)[1:]
    w = torch.ones(B, dtype=torch.int32)
    m = torch.ones(B, dtype=torch.bool)
    total = torch.tensor(0, dtype=torch.int32)
    assert cmsrows.launch_plan(B, entry="cms_update_query").rows_per_thread \
        == 4
    cmsrows._update_query("cms_update_query", table, None, total, keys, w,
                          m)
    [(name, a)] = stub.calls
    assert name == "sb_cms_update_query" and a[11:15] == (B // 256, 256, 1,
                                                          1)
