"""The port's ``regrid`` against the JAX package's, on the CPU: the cases
of tests/test_gis.py (block averages of a 4-block field, several layers,
a sub-area target; nearest and bilinear on the source grid and between
its centres; descending source coordinates), every resampling (average,
nearest, bilinear, cubic, and rasterio's integer codes) on a random
field onto coarser and finer grids and across CRSs, and a cutout's wind
field, whose values lie in a torch tensor, against the same field of the
JAX package's cutout.

Both packages regrid on the host in float64: values within 1e-12
relative (NaN where JAX has NaN), coordinates equal.
"""

import jax
import numpy as np
import pytest
import torch

import atlite_tpu
from atlite_tpu.dataarray import DataArray as JDataArray
from atlite_tpu.gis.regrid import Resampling as JResampling
from atlite_tpu.gis.regrid import regrid as jregrid
import atlite_tpu_torch
from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.gis import Resampling, maybe_swap_spatial_dims
from atlite_tpu_torch.gis.regrid import regrid

torch.set_num_threads(1)

RTOL = 1e-12


def pair(values, coords, dims):
    return (DataArray(values, coords=coords, dims=dims),
            JDataArray(np.asarray(values), coords=coords, dims=dims))


def check(got, want):
    assert got.dims == want.dims
    w = np.asarray(want.values)
    assert isinstance(got.values, np.ndarray) and got.values.shape == w.shape
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(w))
    np.testing.assert_allclose(got.values, w, rtol=RTOL, atol=0)
    for d in ("x", "y"):
        np.testing.assert_array_equal(got.coords[d], np.asarray(want.coords[d]))


A, B, C, D = 0.25, 0.5, 0.3, 0.1
ONES = np.ones((4, 4))
FINE = np.block([[ONES * A, ONES * B], [ONES * C, ONES * D]])
FINE_C = np.arange(0.5, 8, 1)


@pytest.mark.parametrize("target, want", [
    (np.arange(2, 8, 4), [[A, B], [C, D]]),
    (np.arange(1, 6, 2), [[A, A, B], [A, A, B], [C, C, D]]),
], ids=["blocks", "subarea"])
@pytest.mark.parametrize("resampling", [5, "average", Resampling.average],
                         ids=["code", "name", "enum"])
def test_average_exact_blocks(target, want, resampling):
    t, j = pair(FINE, {"y": FINE_C, "x": FINE_C}, ("y", "x"))
    got = regrid(t, target, target, resampling=resampling)
    check(got, jregrid(j, target, target, resampling=resampling))
    np.testing.assert_allclose(got.values, want)


def test_average_several_layers():
    fine3 = np.stack([FINE * (k + 1) for k in range(10)])
    t, j = pair(fine3, {"z": range(10), "y": FINE_C, "x": FINE_C}, ("z", "y", "x"))
    coarse = np.arange(2, 8, 4)
    got = regrid(t, coarse, coarse, resampling=5)
    check(got, jregrid(j, coarse, coarse, resampling=5))
    np.testing.assert_array_equal(got.coords["z"], np.arange(10))
    np.testing.assert_allclose(got.values[3], 4 * np.array([[A, B], [C, D]]))


def test_nearest_and_bilinear_on_the_grid():
    v = np.arange(16, dtype=float).reshape(4, 4)
    c = np.arange(0.5, 4, 1)
    t, j = pair(v, {"y": c, "x": c}, ("y", "x"))
    for how in ("nearest", "bilinear", 0, 1):
        got = regrid(t, c, c, resampling=how)
        check(got, jregrid(j, c, c, resampling=how))
        np.testing.assert_allclose(got.values, v)
    mid = regrid(t, np.array([1.0]), np.array([0.5]), resampling="bilinear")
    check(mid, jregrid(j, np.array([1.0]), np.array([0.5]), resampling="bilinear"))
    np.testing.assert_allclose(mid.values, [[0.5]])


@pytest.mark.parametrize("resampling", ["average", "nearest", "bilinear", "cubic"])
def test_descending_coords(resampling):
    v = np.arange(16, dtype=float).reshape(4, 4)
    c = np.arange(0.5, 4, 1)
    asc, jasc = pair(v, {"y": c, "x": c}, ("y", "x"))
    desc, jdesc = pair(v[::-1, ::-1].copy(), {"y": c[::-1], "x": c[::-1]}, ("y", "x"))
    coarse = np.array([1.0, 3.0])
    got = regrid(desc, coarse, coarse, resampling=resampling)
    check(got, jregrid(jdesc, coarse, coarse, resampling=resampling))
    np.testing.assert_allclose(got.values, regrid(asc, coarse, coarse,
                                                  resampling=resampling).values)


def random_field():
    rng = np.random.default_rng(0)
    x = np.linspace(-4.0, 1.5, 23)
    y = np.linspace(56.0, 62.0, 25)
    v = rng.random((3, 25, 23))
    v[1, 4, 7] = np.nan
    return v, {"time": np.arange(3), "y": y, "x": x}, ("time", "y", "x")


@pytest.mark.parametrize("resampling", ["average", "nearest", "bilinear", "cubic"])
@pytest.mark.parametrize("step", [0.5, 0.125], ids=["coarser", "finer"])
def test_random_field(resampling, step):
    v, coords, dims = random_field()
    t, j = pair(v, coords, dims)
    dx = np.arange(-3.8, 1.3, step)
    dy = np.arange(56.2, 61.8, step)
    got = regrid(t, dx, dy, resampling=resampling)
    check(got, jregrid(j, dx, dy, resampling=resampling))
    assert got.shape == (3, len(dy), len(dx))


@pytest.mark.parametrize("resampling", ["average", "bilinear", "nearest"])
def test_across_crs(resampling):
    v, coords, dims = random_field()
    t, j = pair(v[0], {"y": coords["y"], "x": coords["x"]}, ("y", "x"))
    dx = np.arange(3.48e6, 3.84e6, 30_000.0)
    dy = np.arange(3.75e6, 4.25e6, 30_000.0)
    got = regrid(t, dx, dy, resampling=resampling, src_crs=4326, dst_crs=3035)
    check(got, jregrid(j, dx, dy, resampling=resampling, src_crs=4326, dst_crs=3035))
    assert np.isfinite(got.values).any()


def test_unknown_resampling_raises():
    t, j = pair(FINE, {"y": FINE_C, "x": FINE_C}, ("y", "x"))
    for fn, da in ((regrid, t), (jregrid, j)):
        with pytest.raises(NotImplementedError, match="lanczos"):
            fn(da, FINE_C, FINE_C, resampling="lanczos")


def test_cutout_field_in_a_tensor():
    """A prepared cutout's wind speed (torch values on the cutout's device)
    regridded onto 0.5 and 0.125 deg, against the JAX cutout's field."""
    kw = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 62), time="2013-01-01")
    tc = atlite_tpu_torch.Cutout(device="cpu", **kw).prepare(features=["wind"])
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **kw).prepare(features=["wind"])
    g = tc.grid_desc
    t = DataArray(torch.as_tensor(tc.data["wnd100m"][:4]),
                  coords={"time": g.time[:4], "y": g.y, "x": g.x}, dims=("time", "y", "x"))
    j = JDataArray(np.asarray(jc.data["wnd100m"])[:4],
                   coords={"time": jc.grid_desc.time[:4], "y": jc.grid_desc.y,
                           "x": jc.grid_desc.x}, dims=("time", "y", "x"))
    np.testing.assert_array_equal(t.to_numpy(), np.asarray(j.values))
    for step in (0.5, 0.125):
        dx = np.arange(-3.75, 1.3, step)
        dy = np.arange(56.25, 61.8, step)
        for how in ("average", "bilinear"):
            check(regrid(t, dx, dy, resampling=how), jregrid(j, dx, dy, resampling=how))


def test_namespace_helpers():
    assert Resampling.average == JResampling.average == "average"
    v = np.arange(12, dtype=float).reshape(3, 4)
    da = DataArray(v, coords={"y": [2.0, 1.0, 0.0], "x": [0.0, 1.0, 2.0, 3.0]},
                   dims=("y", "x"))
    out = maybe_swap_spatial_dims(da)
    assert list(out.coords["y"]) == [0.0, 1.0, 2.0]
    np.testing.assert_array_equal(out.values, v[::-1])
    assert maybe_swap_spatial_dims(out) is out
