"""The port's block-sparse and banded aggregation against the JAX
package's ``atlite_tpu/ops/bsr_spmm.py``.

The host builders must give equal arrays.  The products (the port's
``bsr_spmm``, ``bsr_spmm_scan``, ``bsr_spmm_kernel`` on the CPU, i.e. its
plain route, and ``banded_spmm``) are held against JAX's ``bsr_spmm``,
``bsr_spmm_pallas`` (interpret mode, patched as ``tests/test_bsr.py``
patches it) and ``banded_spmm``, with x64 off.

Tolerance: float32 sums of up to a few thousand products of order 1 in
another order: rtol 1e-5, atol 2e-5.  NaN masks must be identical: the BSR
products follow the dense-in-block rule (a NaN entry times a stored zero
is NaN), the banded one the sparse rule.
"""

import unittest.mock as mock

import jax
import jax.experimental.pallas as pl
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from atlite_tpu.ops import bsr_spmm as jbs
from atlite_tpu_torch.ops import bsr_spmm as tbs

torch.set_num_threads(1)


ORIG_PALLAS_CALL = pl.pallas_call


def interp(*a, **k):
    k.setdefault("interpret", True)
    return ORIG_PALLAS_CALL(*a, **k)


def assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def random_case(nan_cells=0):
    """The 37 x 3000 x 100 case of tests/test_bsr.py, with NaN cells."""
    rng = np.random.default_rng(0)
    m = sp.random(37, 3000, density=0.02, random_state=1, format="csr")
    flat = rng.random((100, 3000)).astype(np.float32)
    flat[rng.integers(0, 100, nan_cells), rng.integers(0, 3000, nan_cells)] = np.nan
    return m, flat


def empty_row_block_case():
    """tests/test_bsr.py:151: rows 4..7 (the second 4-row block) empty."""
    B, C, T = 8, 32, 6
    rng = np.random.default_rng(3)
    m = sp.csr_matrix((rng.random(16), (np.repeat(np.arange(4), 4),
                                        rng.choice(C, 16, replace=False))), shape=(B, C))
    return m, rng.random((T, C)).astype(np.float32)


CASES = {
    "8x256": (random_case, 8, 256),
    "8x512": (random_case, 8, 512),
    "32x512": (random_case, 32, 512),
    "empty-row-block-4x8": (empty_row_block_case, 4, 8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_to_bsr_equals_jax(name):
    make, bb, bc = CASES[name]
    m, _ = make()
    got, want = tbs.to_bsr(m, bb, bc), jbs.to_bsr(m, bb, bc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("nan_cells", [0, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bsr_products_match_jax(name, nan_cells):
    make, bb, bc = CASES[name]
    m, flat = make() if make is empty_row_block_case else make(nan_cells)
    if make is empty_row_block_case and nan_cells:
        flat[2, 5] = np.nan
    bsr = jbs.to_bsr(m, bb, bc)
    with jax.enable_x64(False):
        want = np.asarray(jbs.bsr_spmm(bsr, flat))
        with mock.patch.object(pl, "pallas_call", interp):
            want_pallas = np.asarray(jbs.bsr_spmm_pallas(bsr, flat, time_tile=8))
    assert_same(want_pallas, want)
    f = torch.as_tensor(flat)
    for fn in (tbs.bsr_spmm, tbs.bsr_spmm_scan, tbs.bsr_spmm_kernel):
        assert_same(fn(tbs.to_bsr(m, bb, bc), f).numpy(), want)
    if make is empty_row_block_case:
        assert np.all(tbs.bsr_spmm_kernel(bsr, f).numpy()[:, 4:] == 0.0)


def test_bsr_dense_in_block_nan_rule():
    """A NaN cell poisons every bus of a row block that stores a block over
    it, zero entries included, as the Pallas kernel's dense dot does."""
    m = sp.csr_matrix(([1.0], ([0], [3])), shape=(4, 16))
    flat = np.ones((2, 16), dtype=np.float32)
    flat[1, 5] = np.nan  # inside the stored block, at a zero entry
    got = tbs.bsr_spmm_kernel(tbs.to_bsr(m, 4, 8), torch.as_tensor(flat)).numpy()
    assert np.isnan(got[1]).all() and not np.isnan(got[0]).any()


def test_bsr_kernel_wrapper_counts_only_launches():
    m, flat = random_case()
    before = tbs.bsr_spmm_kernel.launches
    tbs.bsr_spmm_kernel(tbs.to_bsr(m), torch.as_tensor(flat))
    assert tbs.bsr_spmm_kernel.launches == before  # CPU: the plain route
    with pytest.raises(ValueError, match="cells"):
        tbs.bsr_spmm_kernel(tbs.to_bsr(m), torch.as_tensor(flat[:, :10]))


def test_stage_bsr_row_pointer():
    m, flat = random_case()
    bsr = tbs.to_bsr(m, 8, 256)
    staged = tbs.stage_bsr(bsr, "cpu")
    ptr = staged["row_ptr"].numpy()
    assert ptr[0] == 0 and ptr[-1] == len(bsr["row_blk"]) and len(ptr) == bsr["B_pad"] // 8 + 1
    for r in range(len(ptr) - 1):
        assert (bsr["row_blk"][ptr[r]:ptr[r + 1]] == r).all()
    assert_same(tbs.bsr_spmm(staged, torch.as_tensor(flat)).numpy(),
                tbs.bsr_spmm(bsr, torch.as_tensor(flat)).numpy())
    unsorted = dict(bsr, row_blk=bsr["row_blk"][::-1].copy())
    with pytest.raises(ValueError, match="sorted"):
        tbs.stage_bsr(unsorted, "cpu")


def local_matrix(B=40, Y=32, X=48, seed=3):
    """tests/test_bsr.py:60: 5x5-cell regions at random places."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for b in range(B):
        y0, x0 = rng.integers(0, Y - 5), rng.integers(0, X - 5)
        cc = (np.arange(y0, y0 + 5)[:, None] * X + np.arange(x0, x0 + 5)[None, :]).ravel()
        rows += [b] * len(cc)
        cols += list(cc)
        vals += list(rng.random(len(cc)))
    return sp.csr_matrix((vals, (rows, cols)), shape=(B, Y * X))


def empty_rows_matrix():
    """tests/test_bsr.py:83: out-of-order band starts and empty rows."""
    m = sp.lil_matrix((5, 1000))
    m[0, 900] = 3.0
    m[2, 5] = 2.0
    return m.tocsr()


BANDED = {
    "random-16x256": (lambda: random_case()[0], 16, 256, None),
    "random-2x128": (lambda: random_case()[0], 2, 128, None),
    "local-8x128": (local_matrix, 8, 128, None),
    "local-8x128-forced": (local_matrix, 8, 128, 1536),
    "empty-rows-2x128": (empty_rows_matrix, 2, 128, None),
}


@pytest.mark.parametrize("name", sorted(BANDED))
def test_band_builders_equal_jax(name):
    make, bb, align, force_w = BANDED[name]
    m = make()
    for g, w in zip(tbs._band_layout(m.tocsr(), bb, align), jbs._band_layout(m.tocsr(), bb, align)):
        np.testing.assert_array_equal(g, w)
    assert tbs.banded_width(m, bb, align) == jbs.banded_width(m, bb, align)
    got = tbs.to_banded(m, bb, align, force_w=force_w)
    want = jbs.to_banded(m, bb, align, force_w=force_w)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("nan_cells", [0, 5])
@pytest.mark.parametrize("name", sorted(BANDED))
def test_banded_spmm_matches_jax(name, nan_cells):
    make, bb, align, force_w = BANDED[name]
    m = make()
    rng = np.random.default_rng(7)
    T, C = 17, m.shape[1]
    flat = rng.random((T, C)).astype(np.float32)
    flat[rng.integers(0, T, nan_cells), rng.integers(0, C, nan_cells)] = np.nan
    if nan_cells:
        flat[:, m.indices[0]] = np.nan  # a cell of the first stored entry, at every hour
    with jax.enable_x64(False):
        want = np.asarray(jbs.banded_spmm(jbs.to_banded(m, bb, align, force_w=force_w), flat))
    banded = tbs.to_banded(m, bb, align, force_w=force_w)
    got = tbs.banded_spmm(banded, torch.as_tensor(flat)).numpy()
    assert_same(got, want)
    staged = tbs.stage_banded(banded, torch.float32, "cpu")
    assert_same(tbs.banded_spmm(banded, torch.as_tensor(flat), staged=staged).numpy(), want)
    if nan_cells:
        assert np.isnan(got).any() and not np.isnan(got).all()  # the sparse rule


def test_banded_empty_rows_are_zero():
    banded = tbs.to_banded(empty_rows_matrix(), block_b=2, align=128)
    out = tbs.banded_spmm(banded, torch.ones((10, 1000))).numpy()
    np.testing.assert_array_equal(out[:, 1], 0.0)
    np.testing.assert_array_equal(out[:, 3:], 0.0)
    np.testing.assert_allclose(out[:, 0], 3.0)
    np.testing.assert_allclose(out[:, 2], 2.0)
