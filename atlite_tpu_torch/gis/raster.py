"""Raster containers, rasterization and resampling primitives (counterpart
of ``atlite_tpu/gis/raster.py``, host numpy as there).

They take the place of the GDAL/rasterio operations atlite delegates to
native libraries (its gis.py:197-373):

- ``Raster``: in-memory raster = array + affine transform + CRS + nodata,
  loadable from .npz (``data``/``transform``/``crs``/``nodata`` keys) or a
  GeoTIFF, the framework's raster interchange formats,
- ``geometry_mask``: polygon rasterization by pixel-center containment
  (rasterio.features.geometry_mask semantics, all_touched=False), by the
  C++ engine when it builds and numpy otherwise,
- ``reproject_nearest``: gather-based nearest resampling onto a target
  grid (rasterio ``Resampling.nearest``, the default of projected_mask),
- ``reproject_average``: area-average downsampling (rasterio
  ``Resampling.average``; exact overlap weights for axis-aligned grids in
  one CRS, centre-point scatter-mean across CRSs).

``overlap_matrix`` is the separable building block that the device path
(``gis.kernels``) shares, so both backends downsample by the same weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from atlite_tpu_torch.core.grid import Affine
from atlite_tpu_torch.gis import geometry as G
from atlite_tpu_torch.gis.crs import normalize_crs, transform_points


@dataclass
class Raster:
    data: np.ndarray  # (rows, cols)
    transform: Affine  # pixel (col,row) -> (x,y) of pixel's top-left corner
    crs: object = 4326
    nodata: float = 255

    @property
    def shape(self):
        return self.data.shape

    @property
    def res(self):
        return abs(self.transform.a), abs(self.transform.e)

    @property
    def bounds(self):
        rows, cols = self.data.shape
        x0, y0 = self.transform * (0, 0)
        x1, y1 = self.transform * (cols, rows)
        return (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))

    def pixel_centers(self):
        rows, cols = self.data.shape
        cc, rr = np.meshgrid(np.arange(cols) + 0.5, np.arange(rows) + 0.5)
        x = self.transform.a * cc + self.transform.b * rr + self.transform.c
        y = self.transform.d * cc + self.transform.e * rr + self.transform.f
        return x, y

    @classmethod
    def open(cls, path):
        path = Path(path)
        if path.suffix == ".npz":
            import ast

            z = np.load(path, allow_pickle=True)
            crs = 4326
            if "crs" in z:
                crs = z["crs"].ravel()[0]
                if isinstance(crs, (str, np.str_)):
                    # tuple projection keys / 'cea' are stored as repr
                    try:
                        crs = ast.literal_eval(str(crs))
                    except (ValueError, SyntaxError):
                        crs = str(crs)
                    if isinstance(crs, list):
                        crs = tuple(crs)
                else:
                    crs = crs.item() if hasattr(crs, "item") else crs
            nodata = None
            if "nodata" in z:
                raw = z["nodata"].ravel()[0]
                nodata = None if raw is None else float(raw)
            return cls(z["data"], Affine(*np.asarray(z["transform"]).ravel()[:6]),
                       crs, nodata)
        if path.suffix.lower() in (".tif", ".tiff", ".gtiff"):
            from atlite_tpu_torch.gis.geotiff import read_geotiff

            return read_geotiff(path)
        raise ValueError(
            f"unsupported raster format {path.suffix!r}; use GeoTIFF or "
            ".npz with data/transform/crs/nodata entries"
        )

    def save(self, path):
        # crs: ints stay ints; tuple keys / 'cea' strings go through repr
        # (parsed back with ast.literal_eval on open).  nodata=None is a
        # normal state and must survive the round-trip.
        crs = normalize_crs(self.crs)
        crs_arr = (np.asarray(crs) if isinstance(crs, int)
                   else np.asarray(repr(crs)))
        np.savez_compressed(
            path, data=self.data, transform=np.asarray(self.transform),
            crs=crs_arr,
            nodata=np.asarray(self.nodata, dtype=object),
        )


def padded_transform_and_shape(bounds, res):
    """Snap bounds outward to the res lattice (atlite gis.py:186-194)."""
    left, bottom = (np.floor(b / res) * res for b in bounds[:2])
    right, top = (np.floor(b / res) * res + res for b in bounds[2:])
    shape = int(round((top - bottom) / res)), int(round((right - left) / res))
    return Affine(res, 0, left, 0, -res, top), shape


def pad_extent(src, src_transform, dst_transform, src_crs, dst_crs,
               mode="constant"):
    """Pad ``src`` by one destination-cell equivalent (atlite
    gis.py:233-260) so average-resampling sees the src's surroundings
    (zeros for masks, edge values for fields) instead of dropping them.

    Returns (padded_src, padded_transform)."""
    src = np.asarray(src)
    if src.size == 0:
        return src, src_transform
    x0, y0 = src_transform * (0, 0)
    x1, y1 = src_transform * (1, 1)
    cx, cy = transform_points(np.array([x0, x1]), np.array([y0, y1]),
                              src_crs, dst_crs)
    covered_res = min(abs(cx[1] - cx[0]), abs(cy[1] - cy[0]))
    pad = int(abs(dst_transform.a) // covered_res * 1.1)
    if pad == 0:
        return src, src_transform
    npad = ((0, 0),) * (src.ndim - 2) + ((pad, pad), (pad, pad))
    padded = np.pad(src, npad, mode=mode)
    t = list(src_transform)
    t[2] -= pad * t[0]
    t[5] -= pad * t[4]
    return padded, Affine(*t)


def geometry_mask(geometries, shape, transform, invert=False):
    """True outside the geometries (rasterio.features.geometry_mask default);
    invert=True -> True inside.  Membership = pixel-center containment."""
    rows, cols = shape
    cc, rr = np.meshgrid(np.arange(cols) + 0.5, np.arange(rows) + 0.5)
    x = (transform.a * cc + transform.b * rr + transform.c).ravel()
    y = (transform.d * cc + transform.e * rr + transform.f).ravel()
    inside = np.zeros(rows * cols, dtype=bool)
    if (isinstance(geometries, (G.Geometry,))
            or hasattr(geometries, "__geo_interface__")
            or (isinstance(geometries, dict) and "type" in geometries)):
        geometries = [geometries]  # single geometry (incl. GeoJSON dicts)
    from atlite_tpu_torch import native

    use_native = native.get_lib() is not None
    for geom in geometries:
        geom = G.parse_geometry(geom)
        if use_native:
            polys = geom.polygons if isinstance(geom, G.MultiPolygon) else [geom]
            for p in polys:
                buf = native.points_in_polygon(p, x, y)
                inside |= buf.astype(bool)
        else:
            inside |= G.points_in_polygon(geom, x, y)
    inside = inside.reshape(rows, cols)
    return inside if invert else ~inside


def projected_mask(raster: Raster, geom, transform=None, shape=None, crs=None,
                   allow_no_overlap=False, nodata=None, geom_crs=None):
    """Crop ``raster`` to a geometry (pixels outside -> nodata) and
    optionally reproject the crop onto a target grid (atlite
    gis.py:197-230, rasterio.mask(crop=True) + warp.reproject semantics).

    Returns ``(masked_array, crop_transform)`` — or the reprojected array
    on the target (transform, shape, crs) when ``transform`` is given and
    differs from the crop's.
    """
    nodata = raster.nodata if nodata is None else nodata
    if nodata is None:
        # atlite's projected_mask defaults to 255 when no nodata
        # is declared (gis.py:204) — np.where(outside, None, ...) would
        # otherwise produce an object array / TypeError
        nodata = 255
    geoms = geom if isinstance(geom, (list, tuple)) else [geom]
    geoms = [G.parse_geometry(g) for g in geoms]
    if geom_crs is not None and normalize_crs(geom_crs) != normalize_crs(raster.crs):
        from atlite_tpu_torch.gis.geometry import transform_geometry

        geoms = [transform_geometry(g, geom_crs, raster.crs) for g in geoms]

    bounds = np.array([g.bounds for g in geoms])
    total = (bounds[:, 0].min(), bounds[:, 1].min(),
             bounds[:, 2].max(), bounds[:, 3].max())
    inv = raster.transform.inverse
    corners_c = [inv.a * x + inv.b * y + inv.c
                 for x in total[::2] for y in total[1::2]]
    corners_r = [inv.d * x + inv.e * y + inv.f
                 for x in total[::2] for y in total[1::2]]
    c0 = int(np.floor(min(corners_c)))
    c1 = int(np.ceil(max(corners_c)))
    r0 = int(np.floor(min(corners_r)))
    r1 = int(np.ceil(max(corners_r)))
    c0w, c1w = max(c0, 0), min(c1, raster.shape[1])
    r0w, r1w = max(r0, 0), min(r1, raster.shape[0])

    if c0w >= c1w or r0w >= r1w:
        if not allow_no_overlap:
            raise ValueError(
                "Input shapes do not overlap raster. Set allow_no_overlap=True "
                "to ignore (atlite gis.py:209-215)."
            )
        crop_transform, crop_shape = padded_transform_and_shape(total, raster.res[0])
        masked = np.full(crop_shape, nodata, dtype=np.asarray(raster.data).dtype)
    else:
        x0, y0 = raster.transform * (c0w, r0w)
        crop_transform = Affine(raster.transform.a, raster.transform.b, x0,
                                raster.transform.d, raster.transform.e, y0)
        window = np.asarray(raster.data)[r0w:r1w, c0w:c1w]
        outside = geometry_mask(geoms, window.shape, crop_transform)
        masked = np.where(outside, nodata, window)

    if transform is None or (tuple(transform) == tuple(crop_transform)
                             and masked.shape == tuple(shape or masked.shape)):
        return masked, crop_transform

    assert shape is not None and crs is not None
    out = reproject_nearest(
        Raster(masked, crop_transform, raster.crs, nodata),
        transform, crs, shape, nodata=nodata,
    )
    return out, transform


def _dst_pixel_of_points(x, y, dst_transform, dst_shape):
    """Map point coords to integer dst pixel indices (or -1 outside)."""
    inv = dst_transform.inverse
    col = inv.a * x + inv.b * y + inv.c
    row = inv.d * x + inv.e * y + inv.f
    ci = np.floor(col).astype(np.int64)
    ri = np.floor(row).astype(np.int64)
    ok = (ci >= 0) & (ci < dst_shape[1]) & (ri >= 0) & (ri < dst_shape[0])
    return ri, ci, ok


def overlap_matrix(start_s, step_s, n_s, start_d, step_d, n_d):
    """(n_d, n_s) matrix of interval overlap lengths between a source and a
    destination 1-D cell lattice (cells [start + i*step, start + (i+1)*step]).

    This is the separable building block of exact area-weighted average
    resampling: out = Wy @ src @ Wx.T — two small matmuls, which is also
    the formulation the device path (``gis.kernels``) uses."""
    se = start_s + step_s * np.arange(n_s + 1)
    de = start_d + step_d * np.arange(n_d + 1)
    slo, shi = np.minimum(se[:-1], se[1:]), np.maximum(se[:-1], se[1:])
    dlo, dhi = np.minimum(de[:-1], de[1:]), np.maximum(de[:-1], de[1:])
    return np.clip(
        np.minimum(dhi[:, None], shi[None, :]) - np.maximum(dlo[:, None], slo[None, :]),
        0.0, None,
    )


def reproject_average(src: Raster, dst_transform, dst_crs, dst_shape,
                      nodata=np.nan):
    """Average-resample src onto the destination grid.

    Same-CRS axis-aligned grids use exact area-weighted overlap (GDAL
    Resampling.average semantics incl. fractional pixel contributions — the
    conformance case of atlite's test_gis.py:251-292 and the
    availability-matrix equality of its test_gis.py:335-348).  Cross-CRS
    falls back to center-point scatter-mean (GDAL itself approximates here).
    """
    from atlite_tpu_torch.gis.crs import normalize_crs as _n

    vals = np.asarray(src.data, dtype=float)
    valid = ~np.isnan(vals)
    if src.nodata is not None and not np.isnan(src.nodata):
        valid &= vals != src.nodata

    if _n(src.crs) == _n(dst_crs):
        st, dt = src.transform, dst_transform
        assert st.b == 0 and st.d == 0 and dt.b == 0 and dt.d == 0
        Wx = overlap_matrix(st.c, st.a, src.shape[1], dt.c, dt.a, dst_shape[1])
        Wy = overlap_matrix(st.f, st.e, src.shape[0], dt.f, dt.e, dst_shape[0])
        v = np.where(valid, vals, 0.0)
        num = Wy @ v @ Wx.T
        den = Wy @ valid.astype(float) @ Wx.T
        with np.errstate(invalid="ignore"):
            out = num / den
        out[den <= 0] = nodata
        return out

    x, y = src.pixel_centers()
    xd, yd = transform_points(x.ravel(), y.ravel(), src.crs, dst_crs)
    ri, ci, ok = _dst_pixel_of_points(xd, yd, dst_transform, dst_shape)
    ok &= valid.ravel()
    vflat = vals.ravel()
    flat = ri[ok] * dst_shape[1] + ci[ok]
    sums = np.bincount(flat, weights=vflat[ok], minlength=dst_shape[0] * dst_shape[1])
    counts = np.bincount(flat, minlength=dst_shape[0] * dst_shape[1])
    with np.errstate(invalid="ignore"):
        out = sums / counts
    out[counts == 0] = nodata
    return out.reshape(dst_shape)


def reproject_nearest(src: Raster, dst_transform, dst_crs, dst_shape,
                      nodata=None):
    """Nearest-neighbour resampling: destination pixel centers gather the
    enclosing source pixel's value (rasterio Resampling.nearest).

    Fast path: same CRS, same pixel size, integer-aligned origins reduce
    to a pure slice/pad — the common availability case (exclusion raster
    already at the excluder's res/crs) skips the 2x transform + gather
    over every destination pixel entirely.
    """
    nodata = src.nodata if nodata is None else nodata
    rows, cols = dst_shape

    st, dt = src.transform, dst_transform
    if (normalize_crs(src.crs) == normalize_crs(dst_crs)
            and st.b == 0 and st.d == 0 and dt.b == 0 and dt.d == 0
            and st.a == dt.a and st.e == dt.e and st.a != 0 and st.e != 0):
        off_c = (dt.c - st.c) / st.a
        off_r = (dt.f - st.f) / st.e
        if (abs(off_c - round(off_c)) < 1e-9 and
                abs(off_r - round(off_r)) < 1e-9):
            c0, r0 = int(round(off_c)), int(round(off_r))
            out = np.full(dst_shape, nodata,
                          dtype=np.asarray(src.data).dtype)
            sr0, sr1 = max(r0, 0), min(r0 + rows, src.shape[0])
            sc0, sc1 = max(c0, 0), min(c0 + cols, src.shape[1])
            if sr0 < sr1 and sc0 < sc1:
                out[sr0 - r0:sr1 - r0, sc0 - c0:sc1 - c0] = \
                    np.asarray(src.data)[sr0:sr1, sc0:sc1]
            return out
    if (normalize_crs(src.crs) == normalize_crs(dst_crs)
            and st.b == 0 and st.d == 0 and dt.b == 0 and dt.d == 0):
        # separable fast path (any pixel-size ratio): with both lattices
        # axis-aligned in the same CRS, the nearest source column depends
        # only on the destination column and likewise for rows — two 1-D
        # index arrays replace the meshgrid + 2-D gather over every
        # destination pixel (the hot spot of the availability mask build)
        inv = st.inverse
        x = dt.a * (np.arange(cols) + 0.5) + dt.c
        y = dt.e * (np.arange(rows) + 0.5) + dt.f
        ci = np.floor(inv.a * x + inv.c).astype(np.int64)
        ri = np.floor(inv.e * y + inv.f).astype(np.int64)
        okc = (ci >= 0) & (ci < src.shape[1])
        okr = (ri >= 0) & (ri < src.shape[0])
        out = np.full(dst_shape, nodata, dtype=np.asarray(src.data).dtype)
        if okr.any() and okc.any():
            out[np.ix_(okr, okc)] = \
                np.asarray(src.data)[ri[okr]][:, ci[okc]]
        return out
    cc, rr = np.meshgrid(np.arange(cols) + 0.5, np.arange(rows) + 0.5)
    x = dst_transform.a * cc + dst_transform.b * rr + dst_transform.c
    y = dst_transform.d * cc + dst_transform.e * rr + dst_transform.f
    xs, ys = transform_points(x.ravel(), y.ravel(), dst_crs, src.crs)
    inv = src.transform.inverse
    ci = np.floor(inv.a * xs + inv.b * ys + inv.c).astype(np.int64)
    ri = np.floor(inv.d * xs + inv.e * ys + inv.f).astype(np.int64)
    ok = (ci >= 0) & (ci < src.shape[1]) & (ri >= 0) & (ri < src.shape[0])
    out = np.full(rows * cols, nodata, dtype=np.asarray(src.data).dtype)
    out[ok] = np.asarray(src.data)[ri[ok], ci[ok]]
    return out.reshape(dst_shape)


def binary_dilation(mask: np.ndarray, iterations: int) -> np.ndarray:
    """4-connected binary dilation (scipy's; atlite gis.py:317)."""
    from scipy.ndimage import binary_dilation as _bd

    return _bd(mask, iterations=iterations)
