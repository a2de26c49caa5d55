"""The PyTorch port's dense aggregation against the JAX package's
``_dense_spmm`` and a scipy CSR product, with NaN cells and empty rows.

Tolerance: float32 sums over C <= 600 cells of products of order 1, taken
in different orders: rtol 1e-5, atol 1e-5.  NaN masks must be identical.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from atlite_tpu.aggregate import _dense_spmm
from atlite_tpu_torch import aggregate

torch.set_num_threads(1)


def case(T=17, C=600, B=9, seed=0, nan_cells=5, density=0.1):
    rng = np.random.default_rng(seed)
    field = rng.random((T, C), dtype=np.float32)
    field[rng.integers(0, T, nan_cells), rng.integers(0, C, nan_cells)] = np.nan
    field[:, 3] = np.nan  # one cell NaN at every hour
    matrix = rng.random((B, C), dtype=np.float32)
    matrix *= rng.random((B, C)) < density
    matrix[2] = 0.0  # an empty row
    matrix[4, 3] = 0.5  # one bus touches the all-NaN cell
    matrix[5, 3] = 0.0
    return field, matrix


def scipy_reference(field, matrix):
    """CSR product: structural zeros skip NaN cells."""
    return np.asarray((sp.csr_matrix(matrix) @ field.T.astype(np.float64)).T)


@pytest.mark.parametrize("nan_cells", [0, 5])
def test_dense_spmm_matches_jax_and_scipy(nan_cells):
    field, matrix = case(nan_cells=nan_cells)
    got = aggregate.dense_spmm(torch.as_tensor(field), torch.as_tensor(matrix)).numpy()
    with jax.enable_x64(False):
        want = np.asarray(_dense_spmm(field, matrix))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, scipy_reference(field, matrix), rtol=1e-5, atol=1e-5)
    assert np.isnan(got[:, 4]).all()  # touches the all-NaN cell
    assert not np.isnan(got[:, 2]).any() and (got[:, 2] == 0).all()  # empty row


def test_dense_spmm_struct_argument():
    field, matrix = case(seed=1)
    m = torch.as_tensor(matrix)
    f = torch.as_tensor(field)
    np.testing.assert_array_equal(
        aggregate.dense_spmm(f, m, (m != 0).float()).numpy(),
        aggregate.dense_spmm(f, m).numpy())


def test_dense_spmm_keeps_tf32_setting():
    field, matrix = case(seed=2)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        aggregate.dense_spmm(torch.as_tensor(field), torch.as_tensor(matrix))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_spmm_closure_dense():
    field, matrix = case(seed=3)
    run = aggregate.spmm_closure(sp.csr_matrix(matrix))
    got = run(torch.as_tensor(field)).numpy()
    np.testing.assert_allclose(got, scipy_reference(field, matrix), rtol=1e-5, atol=1e-5)
    # staged once per (device, dtype); a float64 field restages
    got64 = run(torch.as_tensor(field, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got64, scipy_reference(field, matrix), rtol=1e-12, atol=1e-12)


def test_spmm_closure_above_dense_limit_not_ported():
    big = sp.csr_matrix((1, aggregate._DENSE_LIMIT + 1), dtype=np.float32)
    with pytest.raises(NotImplementedError, match="banded"):
        aggregate.spmm_closure(big)
