"""Regridding of cutout fields between resolutions / CRSs (counterpart of
``atlite_tpu/gis/regrid.py``).

atlite's ``regrid`` (its gis.py:765-871) drives rasterio.warp.reproject
under apply_ufunc; this one needs no GDAL:

- 'average'  : exact area-weighted overlap for grids in one CRS (block-exact
  for integer ratios, the conformance case of atlite's test_gis.py:251-292),
  scatter-mean of source pixel centers across CRSs,
- 'bilinear' : gather + bilinear weights at destination cell centers with
  edge clamping (atlite pads with mode='edge', gis.py:829-836),
- 'cubic'    : Keys cubic convolution (a=-0.5), edge-clamped,
- 'nearest'  : gather of the nearest source pixel.

It runs on the host in numpy, as in the JAX package: regridding is a
data-preparation step, run once per ingest, and its gathers read each
source value a few times at most.  A DataArray whose values lie on a card
is read back first; the result holds host values.  The coordinate
arrays are plain numpy (the port imports no pandas).
"""

from __future__ import annotations

import numpy as np

from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.dataarray import DataArray
from atlite_tpu_torch.gis.crs import transform_points
from atlite_tpu_torch.gis.raster import Raster, reproject_average


class Resampling:
    """Name-compatible stand-in for rasterio.enums.Resampling."""

    average = "average"
    bilinear = "bilinear"
    nearest = "nearest"
    cubic = "cubic"


# rasterio.enums.Resampling integer codes, as atlite's callers pass them
_RESAMPLING_CODES = {0: "nearest", 1: "bilinear", 2: "cubic", 5: "average"}


def _cubic_weights(frac):
    """Keys cubic-convolution weights, a=-0.5 (GDAL 'cubic')."""
    a = -0.5
    t = frac
    w0 = a * (t + 1) ** 3 - 5 * a * (t + 1) ** 2 + 8 * a * (t + 1) - 4 * a
    w1 = (a + 2) * t**3 - (a + 3) * t**2 + 1
    w2 = (a + 2) * (1 - t) ** 3 - (a + 3) * (1 - t) ** 2 + 1
    w3 = a * (2 - t) ** 3 - 5 * a * (2 - t) ** 2 + 8 * a * (2 - t) - 4 * a
    return np.stack([w0, w1, w2, w3])


def _as_transform(x, y):
    """Affine of an ascending-coordinate grid (atlite gis.py:781-788)."""
    dx = float(x[-1] - x[0]) / float(len(x) - 1) if len(x) > 1 else 1.0
    dy = float(y[-1] - y[0]) / float(len(y) - 1) if len(y) > 1 else 1.0
    return Affine(dx, 0, float(x[0]) - dx / 2, 0, dy, float(y[0]) - dy / 2)


def regrid(da, dimx, dimy, resampling="bilinear", src_crs=4326, dst_crs=4326):
    """Interpolate DataArray ``da`` with dims (..., y, x) onto new 1-D
    coordinate arrays ``dimx``/``dimy`` (atlite gis.py:791-871)."""
    if isinstance(resampling, int):
        resampling = _RESAMPLING_CODES.get(resampling, resampling)
    dimx = np.asarray(dimx)
    dimy = np.asarray(dimy)
    src_x = np.asarray(da.coords["x"], dtype=float)
    src_y = np.asarray(da.coords["y"], dtype=float)
    values = np.asarray(da.to_numpy(), dtype=float)

    # normalize to ascending source coordinates (atlite's
    # maybe_swap_spatial_dims, gis.py:765-778)
    if len(src_x) > 1 and src_x[0] > src_x[-1]:
        src_x = src_x[::-1]
        values = values[..., ::-1]
    if len(src_y) > 1 and src_y[0] > src_y[-1]:
        src_y = src_y[::-1]
        values = values[..., ::-1, :]

    lead_shape = values.shape[:-2]
    flat = values.reshape((-1,) + values.shape[-2:])
    dst_shape = (len(dimy), len(dimx))
    dst_transform = _as_transform(dimx, dimy)

    if resampling == "average":
        src_transform = _as_transform(src_x, src_y)
        out = np.stack([
            reproject_average(
                Raster(plane, src_transform, src_crs, nodata=None),
                dst_transform, dst_crs, dst_shape, nodata=np.nan,
            )
            for plane in flat
        ])
    elif resampling == "cubic":
        xq2, yq2 = np.meshgrid(dimx, dimy)
        xs, ys = transform_points(xq2.ravel(), yq2.ravel(), dst_crs, src_crs)
        fx = np.interp(xs, src_x, np.arange(len(src_x)))
        fy = np.interp(ys, src_y, np.arange(len(src_y)))
        x0 = np.floor(fx).astype(int)
        y0 = np.floor(fy).astype(int)
        wx = _cubic_weights(np.clip(fx - x0, 0.0, 1.0))  # (4, P)
        wy = _cubic_weights(np.clip(fy - y0, 0.0, 1.0))
        out = np.zeros((flat.shape[0], fx.size))
        for dy in range(4):
            iy = np.clip(y0 + dy - 1, 0, len(src_y) - 1)
            for dx_ in range(4):
                ix = np.clip(x0 + dx_ - 1, 0, len(src_x) - 1)
                out += flat[:, iy, ix] * (wy[dy] * wx[dx_])[None, :]
        out = out.reshape((flat.shape[0],) + dst_shape)
    elif resampling in ("bilinear", "nearest"):
        # destination centers in source fractional index space, edge-clamped
        xq2, yq2 = np.meshgrid(dimx, dimy)
        xs, ys = transform_points(xq2.ravel(), yq2.ravel(), dst_crs, src_crs)
        fx = np.interp(xs, src_x, np.arange(len(src_x)))
        fy = np.interp(ys, src_y, np.arange(len(src_y)))
        if resampling == "nearest":
            ix = np.clip(np.rint(fx).astype(int), 0, len(src_x) - 1)
            iy = np.clip(np.rint(fy).astype(int), 0, len(src_y) - 1)
            out = flat[:, iy, ix].reshape((flat.shape[0],) + dst_shape)
        else:
            x0 = np.clip(np.floor(fx).astype(int), 0, len(src_x) - 2)
            y0 = np.clip(np.floor(fy).astype(int), 0, len(src_y) - 2)
            wx = np.clip(fx - x0, 0.0, 1.0)
            wy = np.clip(fy - y0, 0.0, 1.0)
            v00 = flat[:, y0, x0]
            v01 = flat[:, y0, x0 + 1]
            v10 = flat[:, y0 + 1, x0]
            v11 = flat[:, y0 + 1, x0 + 1]
            out = (
                v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
                + v10 * (1 - wx) * wy + v11 * wx * wy
            ).reshape((flat.shape[0],) + dst_shape)
    else:
        raise NotImplementedError(f"resampling {resampling!r}")

    out = out.reshape(lead_shape + dst_shape)
    coords = {d: da.coords[d] for d in da.dims[:-2] if d in da.coords}
    coords["y"] = dimy
    coords["x"] = dimx
    return DataArray(out, coords=coords, dims=da.dims[:-2] + ("y", "x"),
                     attrs=da.attrs, name=da.name)
