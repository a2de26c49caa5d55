"""The continental harness (``bench_continental.py``) at its toy scale,
composed from the port's own calls on the CPU: prepare into an ``.atc``
store -> reopen (memory maps) -> indicator matrix of 8 x 16 regions ->
streamed int16 wind and PV with the banded bus aggregation -> the first
48 h against resident calls -> availability at 2 km in EPSG:3035 with
the host path as cross-check.  Bounds are the harness's own: wind within
3e-3 of max, PV p999 within 3e-3 and max within 2e-2 of max,
availability device against host within 2e-2.  The resident wind of the
first 48 h also equals the JAX package's within 1e-5 of its max (float32,
JAX with x64 off)."""

import jax
import numpy as np
import scipy.sparse as sp
import torch

import atlite_tpu
from atlite_tpu_torch import Cutout, ExclusionContainer
from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.gis.crs import transform_points
from atlite_tpu_torch.gis.geometry import box
from atlite_tpu_torch.gis.kernels import availability_matrix_device
from atlite_tpu_torch.gis.raster import Raster

torch.set_num_threads(2)

T_HOURS, NY, NX = 14 * 24, 61, 121
REGIONS_Y, REGIONS_X = 8, 16
N_AVAIL_SHAPES = 4
AVAIL_RES_M = 2000.0
TIME_SLICE = slice("2013-01-01", "2013-01-14")
EXTENT = (-12.0, 18.0, 35.0, 60.0)
CHUNK = 48


def test_continental_pipeline_at_toy_scale(tmp_path):
    x0, x1, y0, y1 = EXTENT
    dx, dy = (x1 - x0) / (NX - 1), (y1 - y0) / (NY - 1)
    grid = dict(module="synthetic", x=slice(x0, x1 + dx / 2), y=slice(y0, y1 + dy / 2),
                dx=dx, dy=dy, time=TIME_SLICE)
    Cutout(tmp_path / "europe", device="cpu", **grid).prepare(
        features=["wind", "influx", "temperature"])
    c = Cutout(tmp_path / "europe", device="cpu")
    T, (Y, X) = len(c.grid_desc.time), c.shape
    assert (T, Y, X) == (T_HOURS, NY, NX)
    assert isinstance(c.data["wnd100m"], np.memmap)

    gx, gy = np.linspace(x0, x1, REGIONS_X + 1), np.linspace(y0, y1, REGIONS_Y + 1)
    names = [f"r{iy}_{ix}" for iy in range(REGIONS_Y) for ix in range(REGIONS_X)]
    bounds = [(gx[ix], gy[iy], gx[ix + 1], gy[iy + 1])
              for iy in range(REGIONS_Y) for ix in range(REGIONS_X)]
    matrix = sp.csr_matrix(c.indicatormatrix(dict(zip(names, (box(*b) for b in bounds)))))
    B = matrix.shape[0]
    assert B == REGIONS_Y * REGIONS_X

    kw = dict(matrix=matrix, index=names, aggregate_time=None, time_chunk=CHUNK,
              stream_pack="int16")
    wind = c.wind("Vestas_V112_3MW", **kw).values
    pv = c.pv(panel="CSi", orientation="latitude_optimal", **kw).values
    assert wind.shape == pv.shape == (B, T)
    assert np.isfinite(wind).all() and np.isfinite(pv).all()

    sub = c.sel(time=slice("2013-01-01", "2013-01-02"))
    w48 = sub.wind("Vestas_V112_3MW", matrix=matrix, index=names, aggregate_time=None).values
    p48 = sub.pv(panel="CSi", orientation="latitude_optimal", matrix=matrix, index=names,
                 aggregate_time=None).values
    assert np.abs(wind[:, :48] - w48).max() < 3e-3 * np.abs(w48).max()
    pv_diff, pmax = np.abs(pv[:, :48] - p48), np.abs(p48).max()
    assert np.quantile(pv_diff, 0.999) < 3e-3 * pmax
    assert pv_diff.max() < 2e-2 * pmax

    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **grid).prepare(features=["wind"])
        jw = np.asarray(jc.wind("Vestas_V112_3MW", matrix=matrix, aggregate_time=None).values)
    np.testing.assert_allclose(w48, jw[:, :48], rtol=0, atol=1e-5 * np.abs(jw).max())

    ex_, ey_ = transform_points(np.array([x0, x0, x1, x1, (x0 + x1) / 2]),
                                np.array([y0, y1, y0, y1, y1]), 4326, 3035)
    RX = int((ex_.max() - ex_.min() + 1e4) / AVAIL_RES_M) + 2
    RY = int((ey_.max() - ey_.min() + 1e4) / AVAIL_RES_M) + 2
    rng = np.random.default_rng(0)
    landuse = Raster(rng.integers(1, 6, (RY, RX)).astype(np.uint8),
                     Affine(AVAIL_RES_M, 0, ex_.min() - 5e3 - 37.0, 0, -AVAIL_RES_M,
                            ey_.max() + 5e3 + 37.0), 3035, 255)
    sx, sy = np.linspace(x0 + 0.5, x1 - 3.5, 8), np.linspace(y0 + 0.5, y1 - 3.5, 5)
    shapes = [box(x, y, x + 3.0, y + 3.0) for y in sy for x in sx][:N_AVAIL_SHAPES]

    def excluder():
        exc = ExclusionContainer(3035, res=AVAIL_RES_M)
        exc.add_raster(landuse, codes=[4, 5])
        return exc

    avail = availability_matrix_device(c, shapes, excluder())
    assert avail.shape == (N_AVAIL_SHAPES, Y, X) and np.isfinite(avail).all()
    host = c.availabilitymatrix(shapes, excluder(), backend="host").values
    assert np.abs(avail - host).max() < 2e-2
