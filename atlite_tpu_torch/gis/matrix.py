"""Sparse spatial matrices: indicator and intersection (counterpart of
``atlite_tpu/gis/matrix.py``).

The grid is used directly: a shape's bbox maps to a (row, col) window of
cells in O(1), and the exact cell ∩ shape areas come from Sutherland–Hodgman
clipping against the cell boxes (the C++ engine in ``native`` when it
builds, numpy otherwise).  Columns run row-major over (y, x), as the
cutout's cells do.

Shapes come as a list, a dict, a pandas-like Series (``.items()`` and
``.index``, read duck-typed: the port imports no pandas), a FeatureCollection
(``__geo_interface__``, e.g. a GeoDataFrame) or one geometry.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import scipy.sparse as sp

from atlite_tpu_torch import native
from atlite_tpu_torch.aggregate import spdiag  # noqa: F401  (re-exported, as in atlite)
from atlite_tpu_torch.gis import geometry as G
from atlite_tpu_torch.gis.crs import normalize_crs


def _is_series(shapes):
    """A pandas-like Series: labelled items, no columns."""
    return (hasattr(shapes, "items") and hasattr(shapes, "index")
            and not hasattr(shapes, "columns") and not isinstance(shapes, Mapping))


def _features(shapes):
    """The features of a FeatureCollection, or None."""
    if isinstance(shapes, Mapping):
        return None
    gi = getattr(shapes, "__geo_interface__", None)
    if isinstance(gi, dict) and gi.get("type") == "FeatureCollection":
        return gi["features"]
    return None


def _iter_shapes(shapes):
    """Yield (label, Geometry) from a list, dict, Series-like, a
    FeatureCollection or a single geometry."""
    features = None if _is_series(shapes) else _features(shapes)
    if _is_series(shapes) or isinstance(shapes, Mapping):
        items = shapes.items()
    elif features is not None:
        # rows of a GeoDataFrame-style collection, with their ids
        items = [(f.get("id", i), f["geometry"]) for i, f in enumerate(features)]
    elif isinstance(shapes, G.Geometry) or hasattr(shapes, "__geo_interface__"):
        items = [(0, shapes)]
    else:
        items = enumerate(shapes)
    for k, v in items:
        yield k, G.parse_geometry(v)


def _label_array(labels):
    """Labels as a 1-d array; mixed types stay objects (numpy would turn
    ``["x", 1]`` into strings)."""
    labels = list(labels)
    a = np.asarray(labels)
    if a.ndim != 1 or (a.dtype.kind in "US" and not all(isinstance(v, str) for v in labels)):
        a = np.empty(len(labels), dtype=object)
        a[:] = labels
    return a


def shapes_index(shapes):
    """The row labels of a shape collection, in ``_iter_shapes``' order:
    a Series-like's own ``.index``, a dict's keys, a FeatureCollection's
    ids, else ``0..n-1``."""
    if _is_series(shapes):
        return shapes.index
    if isinstance(shapes, Mapping):
        return _label_array(shapes)
    features = _features(shapes)
    if features is not None:
        # the same per-feature order as _iter_shapes, or the matrix rows
        # and their labels disagree
        return _label_array(f.get("id", i) for i, f in enumerate(features))
    if isinstance(shapes, G.Geometry) or hasattr(shapes, "__geo_interface__"):
        return np.arange(1)
    return np.arange(len(shapes))


def _grid_window(grid, bounds, pad=0):
    """Index window of the grid cells whose boxes may overlap ``bounds``."""
    xmin, ymin, xmax, ymax = bounds
    dx2, dy2 = grid.dx / 2, grid.dy / 2
    i0 = np.searchsorted(grid.x, xmin - dx2 - pad, side="left")
    i1 = np.searchsorted(grid.x, xmax + dx2 + pad, side="right")
    j0 = np.searchsorted(grid.y, ymin - dy2 - pad, side="left")
    j1 = np.searchsorted(grid.y, ymax + dy2 + pad, side="right")
    return i0, i1, j0, j1


def _window_areas_numpy(geom, x0, dx, wx, y0, dy, wy):
    """(wy, wx) |geom ∩ cell| by the numpy clipper, cell by cell."""
    areas = np.zeros((wy, wx))
    for j in range(wy):
        ylo = y0 + j * dy
        for i in range(wx):
            xlo = x0 + i * dx
            areas[j, i] = G.polygon_box_area(geom, xlo, ylo, xlo + dx, ylo + dy)
    return areas


def _shape_window_areas(grid, geom):
    """(i0, j0, (wy, wx) areas) of |geom ∩ cell| over the geometry's grid
    window, by the C++ engine when it is loaded, else by numpy."""
    i0, i1, j0, j1 = _grid_window(grid, geom.bounds)
    wx, wy = i1 - i0, j1 - j0
    if wx <= 0 or wy <= 0:
        return i0, j0, np.zeros((0, 0))
    x0 = grid.x[i0] - grid.dx / 2
    y0 = grid.y[j0] - grid.dy / 2
    if native.get_lib() is None:
        return i0, j0, _window_areas_numpy(geom, x0, grid.dx, wx, y0, grid.dy, wy)
    areas = np.zeros((wy, wx))
    for p in geom.polygons if isinstance(geom, G.MultiPolygon) else [geom]:
        native.polygon_cell_areas(p, x0, grid.dx, wx, y0, grid.dy, wy, out=areas)
    return i0, j0, areas


def compute_indicatormatrix(grid, shapes, orig_crs=4326, dest_crs=4326):
    """I[i, j] = |shape_i ∩ cell_j| / |cell_j| as a scipy LIL matrix of
    (shapes, Y * X).

    grid: the cutout's ``Grid`` (its cells, in ``orig_crs``); shapes:
    polygons in ``dest_crs``, reprojected into ``orig_crs``.
    """
    orig_crs, dest_crs = normalize_crs(orig_crs), normalize_crs(dest_crs)
    nx, ny = len(grid.x), len(grid.y)
    cell_area = grid.dx * grid.dy
    if cell_area == 0:
        # dx/dy are 0 on a single column or row: the areas would divide by 0
        raise ValueError("indicator matrix needs a grid with at least 2 columns and "
                         f"2 rows (dx={grid.dx}, dy={grid.dy})")
    rows, cols, vals = [], [], []
    for i, (_, geom) in enumerate(_iter_shapes(shapes)):
        if dest_crs != orig_crs:
            geom = G.transform_geometry(geom, dest_crs, orig_crs)
        i0, j0, areas = _shape_window_areas(grid, geom)
        jj, ii = np.nonzero(areas > 0)
        rows.append(np.full(len(jj), i, dtype=np.int64))
        cols.append((jj + j0) * nx + (ii + i0))
        vals.append(areas[jj, ii] / cell_area)
    cat = lambda parts, dt: np.concatenate(parts) if parts else np.zeros(0, dt)  # noqa: E731
    return sp.coo_matrix(
        (cat(vals, float), (cat(rows, np.int64), cat(cols, np.int64))),
        shape=(len(shapes_index(shapes)), ny * nx), dtype=float).tolil()


def _line_window_hits(grid, coords, i0, i1, j0, j1):
    """(wy, wx) bool: the cells of the window that a polyline touches,
    by the Liang–Barsky test of every segment against every cell box in
    one array pass (the same float64 operations as
    ``geometry.segment_intersects_box``, so the same decisions)."""
    ylo = grid.y[j0:j1] - grid.dy / 2
    yhi = grid.y[j0:j1] + grid.dy / 2
    xlo = grid.x[i0:i1] - grid.dx / 2
    xhi = grid.x[i0:i1] + grid.dx / 2
    p0, p1 = coords[:-1], coords[1:]
    sx, sy = p0[:, 0][:, None, None], p0[:, 1][:, None, None]
    dx = (p1[:, 0] - p0[:, 0])[:, None, None]
    dy = (p1[:, 1] - p0[:, 1])[:, None, None]
    X0, X1 = xlo[None, None, :], xhi[None, None, :]
    Y0, Y1 = ylo[None, :, None], yhi[None, :, None]
    ok = np.ones((len(p0), len(ylo), len(xlo)), dtype=bool)
    t0 = np.zeros(ok.shape)
    t1 = np.ones(ok.shape)
    for p, q in ((-dx, sx - X0), (dx, X1 - sx), (-dy, sy - Y0), (dy, Y1 - sy)):
        p, q = np.broadcast_to(p, ok.shape), np.broadcast_to(q, ok.shape)
        ok &= (p != 0) | (q >= 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            r = q / p
        t0 = np.where(p < 0, np.maximum(t0, r), t0)
        t1 = np.where(p > 0, np.minimum(t1, r), t1)
    return (ok & (t0 <= t1)).any(axis=0)


def compute_intersectionmatrix(grid, shapes, orig_crs=4326, dest_crs=4326):
    """Boolean shape/cell intersection matrix (area or boundary contact)
    as a scipy LIL matrix of (shapes, Y * X); lines are tested segment by
    cell in one array pass, other geometries cell by cell."""
    orig_crs, dest_crs = normalize_crs(orig_crs), normalize_crs(dest_crs)
    nx, ny = len(grid.x), len(grid.y)
    rows, cols = [], []
    for i, (_, geom) in enumerate(_iter_shapes(shapes)):
        if dest_crs != orig_crs:
            geom = G.transform_geometry(geom, dest_crs, orig_crs)
        gb = geom.bounds
        i0, i1, j0, j1 = _grid_window(grid, gb)
        if i1 <= i0 or j1 <= j0:
            continue
        # the bbox test of each row and column, as geometry_intersects_box
        # makes it first
        ylo, yhi = grid.y[j0:j1] - grid.dy / 2, grid.y[j0:j1] + grid.dy / 2
        xlo, xhi = grid.x[i0:i1] - grid.dx / 2, grid.x[i0:i1] + grid.dx / 2
        near = (~((gb[3] < ylo) | (gb[1] > yhi)))[:, None] & \
            (~((gb[2] < xlo) | (gb[0] > xhi)))[None, :]
        if isinstance(geom, G.LineString) and len(geom.coords) > 1:
            hits = near & _line_window_hits(grid, geom.coords, i0, i1, j0, j1)
        else:
            hits = np.zeros(near.shape, dtype=bool)
            for j, ii in zip(*np.nonzero(near)):
                hits[j, ii] = G.geometry_intersects_box(geom, xlo[ii], ylo[j], xhi[ii], yhi[j])
        jj, ii = np.nonzero(hits)
        rows.append(np.full(len(jj), i, dtype=np.int64))
        cols.append((jj + j0) * nx + (ii + i0))
    r = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    c = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    return sp.coo_matrix((np.ones(len(r)), (r, c)),
                         shape=(len(shapes_index(shapes)), ny * nx), dtype=float).tolil()
