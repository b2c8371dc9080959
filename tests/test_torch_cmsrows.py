"""K3 (``streambench_tpu_torch.ops.cmsrows``) on the CPU.

Its plain versions against the reference's ``cms._row_cols``,
``update``, ``query`` and ``update2`` on seeded numpy inputs, bit for bit
(integers, no tolerance); its launch plan; the wrapper refusing wrong
dtypes, shapes and devices; the launch path through a stub library (a
refused launch raises and counts nothing; the plan and sizes reach the
kernel); the nvcc command.  The kernel itself runs only on the card:
``chip_smoke.py`` phase 3 holds it against these plain versions there.
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
    assert cmsrows.launches() == before
    assert set(before) == {"cms_update", "cms_query", "cms_refresh_small",
                           "cms_cols"}


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
                   "sb_cms_query", "sb_cms_refresh_small", "sb_cms_cols"):
        assert needle in src, needle
    salts = ", ".join(f"0x{s:08X}u" for s in cmsrows.SALTS[:3])
    assert salts in src

