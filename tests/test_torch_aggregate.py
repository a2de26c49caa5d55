"""The PyTorch port's aggregation against the JAX package's
``_dense_spmm``, ``spmm_closure`` (each of its three routes) and
``aggregate_matrix``, and a scipy CSR product, with NaN cells and empty
rows.

Tolerance: float32 sums over C <= 3000 cells of products of order 1,
taken in different orders: rtol 1e-5, atol 1e-5.  NaN masks must be
identical.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import atlite_tpu.aggregate as jagg
from atlite_tpu.aggregate import _dense_spmm
from atlite_tpu.dataarray import DataArray as JDataArray
from atlite_tpu_torch import aggregate
from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.ops import bsr_spmm as tbsr

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


def spy_routes(monkeypatch):
    """A list that records the route of each aggregation: "banded" for a
    call of ``banded_spmm``, "chunked" for a ``dense_spmm`` call without a
    structure matrix (one a row chunk), "dense" for one with it."""
    taken = []
    banded, dense = tbsr.banded_spmm, aggregate.dense_spmm

    def spy_banded(*args, **kwargs):
        taken.append("banded")
        return banded(*args, **kwargs)

    def spy_dense(flat, m, struct=None):
        taken.append("chunked" if struct is None else "dense")
        return dense(flat, m, struct)

    monkeypatch.setattr(tbsr, "banded_spmm", spy_banded)
    monkeypatch.setattr(aggregate, "dense_spmm", spy_dense)
    return taken


def test_spmm_closure_above_dense_limit_not_ported(monkeypatch):
    """Above the dense limit the closure routes instead of raising: a
    one-row matrix has no band structure worth using, so it takes the
    row-chunked dense route."""
    big = sp.csr_matrix(([2.0, 3.0], ([0, 0], [5, aggregate._DENSE_LIMIT])),
                        shape=(1, aggregate._DENSE_LIMIT + 1), dtype=np.float32)
    taken = spy_routes(monkeypatch)
    run = aggregate.spmm_closure(big)
    field = torch.zeros((1, aggregate._DENSE_LIMIT + 1))
    field[0, 5], field[0, -1] = 1.0, 2.0
    assert run(field).tolist() == [[8.0]]
    assert set(taken) == {"chunked"}


def local_matrix(B=1000, Y=60, X=100, seed=4):
    """Regions of 4 x 6 cells at places that grow with the bus number, so
    sorted row blocks span narrow column bands; bus 7 is empty."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for b in range(B):
        if b == 7:
            continue
        y0 = min(Y - 4, b * (Y - 4) // B + int(rng.integers(0, 2)))
        x0 = int(rng.integers(0, X - 6))
        cc = (np.arange(y0, y0 + 4)[:, None] * X + np.arange(x0, x0 + 6)[None, :]).ravel()
        rows += [b] * len(cc)
        cols += list(cc)
    vals = rng.random(len(rows)).astype(np.float32)
    return sp.csr_matrix((vals, (rows, cols)), shape=(B, Y * X))


def unbanded_matrix(B=40, C=3000, seed=5):
    """Rows spread over the whole field: no band structure."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(B), 20)
    m = sp.coo_matrix((rng.random(B * 20).astype(np.float32),
                       (rows, rng.integers(0, C, B * 20))), shape=(B, C)).tocsr()
    m.sum_duplicates()
    return m


ROUTES = {  # matrix, dense limit, grid rows
    "dense": (local_matrix, None, 60),
    "banded": (local_matrix, 1000, 60),
    "chunked": (unbanded_matrix, 1000, 30),
}


def route_field(m, nan_cells, T=19, seed=6):
    rng = np.random.default_rng(seed)
    field = rng.random((T, m.shape[1]), dtype=np.float32)
    field[rng.integers(0, T, nan_cells), rng.integers(0, m.shape[1], nan_cells)] = np.nan
    return field


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("nan_cells", [0, 6])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_spmm_closure_routes_match_jax(monkeypatch, route, nan_cells, resident):
    make, limit, _ = ROUTES[route]
    if limit is not None:
        monkeypatch.setattr(aggregate, "_DENSE_LIMIT", limit)
        monkeypatch.setattr(jagg, "_DENSE_LIMIT", limit)
    m = make()
    field = route_field(m, nan_cells)
    taken = spy_routes(monkeypatch)
    run = aggregate.spmm_closure(m, resident=resident)
    got = run(torch.as_tensor(field)).numpy()
    assert taken and set(taken) == {route}
    with jax.enable_x64(False):
        want = np.asarray(jagg.spmm_closure(m, resident=resident)(field))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, scipy_reference(field, m), rtol=1e-5, atol=1e-5)
    if nan_cells:
        assert np.isnan(got).any() and not np.isnan(got).all()  # the sparse rule
    np.testing.assert_array_equal(run(torch.as_tensor(field)).numpy(), got)  # staged once


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_aggregate_matrix_matches_jax(monkeypatch, route):
    make, limit, Y = ROUTES[route]
    if limit is not None:
        monkeypatch.setattr(aggregate, "_DENSE_LIMIT", limit)
        monkeypatch.setattr(jagg, "_DENSE_LIMIT", limit)
    m = make()
    field = route_field(m, 3).reshape(19, Y, -1)
    times = np.datetime64("2013-01-01T00", "ns") + np.arange(19) * np.timedelta64(1, "h")
    coords = {"time": times, "y": np.arange(Y), "x": np.arange(field.shape[2])}
    da = DataArray(torch.as_tensor(field), coords=coords, dims=("time", "y", "x"),
                   attrs={"units": "MW"}, name="cf")
    got = aggregate.aggregate_matrix(da, m, index=np.arange(m.shape[0]) + 10)
    with jax.enable_x64(False):
        want = jagg.aggregate_matrix(JDataArray(field, coords=coords, dims=("time", "y", "x"),
                                                attrs={"units": "MW"}, name="cf"),
                                     m, index=np.arange(m.shape[0]) + 10)
    assert got.dims == want.dims == ("bus", "time")
    assert got.attrs == want.attrs and got.name == want.name
    np.testing.assert_array_equal(got.coords["bus"], np.asarray(want.coords["bus"]))
    np.testing.assert_array_equal(got.coords["time"], np.asarray(want.coords["time"]))
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(np.asarray(want.values)))
    np.testing.assert_allclose(got.values, np.asarray(want.values), rtol=1e-5, atol=1e-5)
