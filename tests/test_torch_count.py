"""K1 port: the masked cell count (``streambench_tpu_torch.ops.count``).

On the CPU the wrapper runs the plain PyTorch version; it is held here
against the JAX package's Pallas kernel (interpret mode, as
``tests/test_windowcount.py`` runs it) and its scatter method, bit for bit
(every value is an integer: the tolerance is 0).  The CUDA kernel itself
is held against the plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streambench_tpu.ops import windowcount as jwc
from streambench_tpu.ops.pallas_count import count_tiles
from streambench_tpu_torch.ops import _build
from streambench_tpu_torch.ops.count import count_cells, count_cells_plain

# tiny tensors: one intra-op thread keeps these tests from crowding the
# other test workers' CPUs
torch.set_num_threads(1)


def make_case(B, C, W, seed, masked=0.3, skew=True):
    rng = np.random.default_rng(seed)
    if skew:
        camp = ((rng.zipf(1.3, B) - 1) % C).astype(np.int32)
    else:
        camp = rng.integers(0, C, B, dtype=np.int32)
    slot = rng.integers(0, W, B, dtype=np.int32)
    mask = rng.random(B) >= masked
    # masked-out rows may hold anything, as in the engine (campaign -1)
    camp[~mask & (rng.random(B) < 0.5)] = -1
    counts = rng.integers(0, 100, (C, W), dtype=np.int32)
    return counts, camp, slot, mask


CASES = [
    (8192, 100, 16, 0),     # the main path's micro-batch
    (4096, 100, 16, 1),     # the stock catchup's halved batch
    (300, 7, 5, 2),         # ragged, not a multiple of the 512-row tile
    (1, 3, 4, 3),
    (2048, 1, 1, 4),        # every counted row hits one cell
]


@pytest.mark.parametrize("B,C,W,seed", CASES)
def test_plain_matches_pallas_and_scatter(B, C, W, seed):
    counts, camp, slot, mask = make_case(B, C, W, seed)
    want_pallas = np.asarray(count_tiles(
        jnp.asarray(counts), jnp.asarray(camp), jnp.asarray(slot),
        jnp.asarray(mask), interpret=True))
    want_scatter = np.asarray(jwc.apply_count(
        jnp.asarray(counts), jnp.asarray(camp), jnp.asarray(slot),
        jnp.asarray(mask), "scatter"))
    assert np.array_equal(want_pallas, want_scatter)

    got = torch.from_numpy(counts.copy())
    out = count_cells_plain(got, torch.from_numpy(camp),
                            torch.from_numpy(slot), torch.from_numpy(mask))
    assert out is got                       # in place, returns counts
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want_pallas)


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.uint8])
def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing(
        mask_dtype):
    counts, camp, slot, mask = make_case(1000, 9, 6, seed=5)
    before = count_cells.launches
    got = torch.from_numpy(counts.copy())
    count_cells(got, torch.from_numpy(camp), torch.from_numpy(slot),
                torch.from_numpy(mask).to(mask_dtype))
    want = torch.from_numpy(counts.copy())
    count_cells_plain(want, torch.from_numpy(camp), torch.from_numpy(slot),
                      torch.from_numpy(mask))
    assert torch.equal(got, want)
    assert count_cells.launches == before


def test_out_of_plane_rows_count_nowhere_like_the_tpu_kernel():
    """Rows whose (campaign, slot) lies outside [0, C) x [0, W) add
    nothing even when masked in: the TPU kernel's one-hot rows are zero
    there, and the CUDA kernel never writes out of bounds."""
    C, W = 4, 3
    counts = np.zeros((C, W), np.int32)
    camp = np.array([0, 4, -1, 2, 3, 1], np.int32)
    slot = np.array([0, 1, 2, 3, -1, 2], np.int32)
    mask = np.ones(6, bool)
    want = np.asarray(count_tiles(
        jnp.asarray(counts), jnp.asarray(camp), jnp.asarray(slot),
        jnp.asarray(mask), interpret=True))
    got = torch.from_numpy(counts.copy())
    count_cells(got, torch.from_numpy(camp), torch.from_numpy(slot),
                torch.from_numpy(mask))
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == 2


def _args(B=16, C=3, W=4):
    return (torch.zeros(C, W, dtype=torch.int32),
            torch.zeros(B, dtype=torch.int32),
            torch.zeros(B, dtype=torch.int32),
            torch.ones(B, dtype=torch.bool))


@pytest.mark.parametrize("bad,match", [
    (lambda a: (a[0].long(), *a[1:]), "counts must be a 2-D int32"),
    (lambda a: (a[0].reshape(-1), *a[1:]), "counts must be a 2-D int32"),
    (lambda a: (a[0].t(), *a[1:]), "counts must be contiguous"),
    (lambda a: (a[0], a[1].long(), *a[2:]), "campaign must be"),
    (lambda a: (a[0], a[1], a[2].float(), a[3]), "slot must be"),
    (lambda a: (*a[:3], a[3].int()), "count_mask must be"),
    (lambda a: (a[0], a[1][:-1], *a[2:]), "slot must be 1-D"),
    (lambda a: (a[0], a[1].reshape(4, 4), *a[2:]), "campaign must be 1-D"),
    (lambda a: (a[0], a[1], torch.zeros(32, dtype=torch.int32)[::2], a[3]),
     "slot must be contiguous"),
    (lambda a: (a[0].to("meta"), *a[1:]), "campaign is on cpu, counts on"),
    (lambda a: tuple(t.to("meta") for t in a), "runs on cuda or cpu"),
], ids=["counts_int64", "counts_1d", "counts_strided", "campaign_int64",
        "slot_float", "mask_int32", "rows_mismatch", "campaign_2d",
        "slot_strided", "mixed_devices", "meta_device"])
def test_wrapper_raises_on_wrong_dtype_shape_layout_or_device(bad, match):
    with pytest.raises(ValueError, match=match):
        count_cells(*bad(_args()))


def test_kernel_build_targets_hopper_and_stays_lazy(monkeypatch):
    """The nvcc command builds csrc/count_cells.cu for sm_90a into a
    shared library; nothing is built until the kernel is first needed."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build._nvcc(_build.COUNT_CELLS_SRC)("out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-1] == _build.COUNT_CELLS_SRC
    assert _build._count_lib is None
