"""The port's GIS slice against the JAX package, on the CPU: indicator and
intersection matrices, the C++ cell-area engine against the numpy
clipper, CRS transforms, cell areas, layouts, and ``shapes=`` aggregation
through ``convert_and_aggregate``.

Inputs are made from numpy seeds.  Tolerances:
- matrices: the same sparsity pattern and values within 1e-12 relative
  (both sides run the same float64 host code); intersection matrices
  exactly equal;
- the C++ engine against numpy: 1e-12 absolute in squared degrees, as
  tests/test_native.py holds the JAX package's engine (the two sum the
  shoelace in another order; cells here are 6.25e-2 squared degrees);
- ``transform_points``: 1e-9 relative;
- cell areas: 1e-12 relative;
- ``shapes=`` conversions: 1e-5 * max|JAX|, JAX with x64 off, NaN masks
  identical.
"""

import logging
import warnings

import jax
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import atlite_tpu
from atlite_tpu.gis import crs as jcrs
from atlite_tpu.gis import geometry as JG
from atlite_tpu.gis import matrix as jmatrix
from atlite_tpu_torch import Cutout, native
from atlite_tpu_torch.gis import crs as tcrs
from atlite_tpu_torch.gis import geometry as TG
from atlite_tpu_torch.gis import matrix as tmatrix

torch.set_num_threads(1)

BOUNDS = dict(module="synthetic", x=slice(-4, 1.5), y=slice(56, 61), time="2013-01-01")
FEATURES = ["wind", "influx", "temperature"]


@pytest.fixture(scope="module")
def pair():
    with jax.enable_x64(False):
        jc = atlite_tpu.Cutout(None, **BOUNDS).prepare(features=FEATURES)
    return jc, Cutout(device="cpu", **BOUNDS).prepare(features=FEATURES)


def to_jax(geom):
    """The same geometry as a JAX-package engine object."""
    return JG.parse_geometry(geom.__geo_interface__)


class Collection:
    """A GeoDataFrame-like FeatureCollection (ids on some features)."""

    def __init__(self, geoms, ids):
        self.__geo_interface__ = {"type": "FeatureCollection", "features": [
            {"type": "Feature", "geometry": g.__geo_interface__, **({"id": i} if i is not None
                                                                     else {})}
            for g, i in zip(geoms, ids)]}


def random_boxes(g, n, seed):
    rng = np.random.default_rng(seed)
    lo = rng.uniform([g.x[0] - 0.4, g.y[0] - 0.4], [g.x[-1], g.y[-1]], (n, 2))
    size = rng.uniform(0.05, 1.6, (n, 2))
    return [TG.box(x, y, x + w, y + h) for (x, y), (w, h) in zip(lo, size)]


def matrix_cases(g):
    """name -> shapes: the cases of tests/test_gis.py (corner cell,
    partial overlap), random boxes, a MultiPolygon with a hole, a
    Series, a dict and a FeatureCollection."""
    dx, dy = g.dx, g.dy
    corner = TG.box(g.x[0] - dx / 2, g.y[0] - dy / 2, g.x[0] + dx / 2, g.y[0] + dy / 2)
    last2 = TG.box(g.x[-2] - dx / 2, g.y[-1] - dy / 2, g.x[-2] + dx / 2, g.y[-1] + dy / 2)
    cx, cy = g.x[5] + dx / 2, g.y[5] + dy / 2
    shifted = TG.box(cx - dx / 2, cy - dy / 2, cx + dx / 2, cy + dy / 2)
    holed = TG.MultiPolygon([
        TG.Polygon([(-3.9, 56.2), (-1.1, 56.3), (-1.4, 58.8), (-3.6, 59.1)],
                   [[(-3.0, 57.0), (-2.0, 57.1), (-2.2, 58.0)]]),
        TG.Polygon([(0.1, 59.0), (1.4, 59.2), (0.8, 60.7)]),
    ])
    boxes = random_boxes(g, 12, seed=3)
    return {
        "corner_cells": [corner, last2],
        "partial_overlap": [shifted],
        "random_boxes": boxes,
        "multipolygon_with_hole": [holed],
        "series": pd.Series(boxes[:4], index=["a", "b", "c", "d"]),
        "dict": dict(zip([10, 30, 20], boxes[4:7])),
        "feature_collection": Collection(boxes[7:10] + [holed], ["x", None, "z", 7]),
        "single_geometry": holed,
    }


def jax_shapes(shapes):
    if isinstance(shapes, pd.Series):
        return shapes.map(to_jax)
    if isinstance(shapes, dict):
        return {k: to_jax(v) for k, v in shapes.items()}
    if isinstance(shapes, (Collection, TG.Geometry)):
        return shapes
    return [to_jax(s) for s in shapes]


def assert_same_matrix(got, want, rtol=1e-12):
    got, want = sp.csr_matrix(got), sp.csr_matrix(want)
    assert got.shape == want.shape
    got.sort_indices()
    want.sort_indices()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=rtol, atol=0)


@pytest.mark.parametrize("case", sorted(matrix_cases(Cutout(device="cpu", **BOUNDS).grid_desc)))
def test_indicatormatrix_equals_jax(pair, case):
    jc, tc = pair
    shapes = matrix_cases(tc.grid_desc)[case]
    got = tc.indicatormatrix(shapes)
    want = jc.indicatormatrix(jax_shapes(shapes))
    assert isinstance(got, sp.lil_matrix)
    assert_same_matrix(got, want)
    assert got.nnz > 0
    np.testing.assert_array_equal(np.asarray(tmatrix.shapes_index(shapes)),
                                  np.asarray(jmatrix.shapes_index(jax_shapes(shapes))))


def test_indicatormatrix_cases_of_the_jax_tests(pair):
    _, tc = pair
    g = tc.grid_desc
    cases = matrix_cases(g)
    ind = tc.indicatormatrix(cases["corner_cells"])
    assert np.isclose(ind[0, 0], 1.0) and np.isclose(ind[1, g.ncells - 2], 1.0)
    np.testing.assert_allclose(np.asarray(ind.sum(axis=1)).ravel(), 1.0)
    vals = np.asarray(tc.indicatormatrix(cases["partial_overlap"]).todense()).ravel()
    np.testing.assert_allclose(vals[vals > 0], [0.25] * 4)


def test_indicatormatrix_through_shapes_crs(pair):
    """Shapes given in EPSG:3035 are reprojected onto the lon/lat grid."""
    jc, tc = pair
    shapes = matrix_cases(tc.grid_desc)["random_boxes"] + \
        matrix_cases(tc.grid_desc)["multipolygon_with_hole"]
    projected = [TG.transform_geometry(s, 4326, 3035) for s in shapes]
    got = tc.indicatormatrix(projected, shapes_crs=3035)
    want = jc.indicatormatrix([to_jax(s) for s in projected], shapes_crs=3035)
    assert_same_matrix(got, want)
    # a round trip through 3035 moves the boxes' edges by far less than a cell
    direct = tc.indicatormatrix(shapes).toarray()
    assert np.abs(got.toarray() - direct).max() < 1e-6


def test_indicatormatrix_needs_two_cells_each_way():
    c = Cutout(device="cpu", module="synthetic", x=slice(0, 0.1), y=slice(50, 51),
               time="2013-01-01")
    with pytest.raises(ValueError, match="at least 2 columns"):
        c.indicatormatrix([TG.box(0, 50, 1, 51)])


def random_lines(g, n, seed):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        k = 2 + i % 5
        start = rng.uniform([g.x[0] - 0.3, g.y[0] - 0.3], [g.x[-1] + 0.3, g.y[-1] + 0.3])
        steps = rng.normal(0.0, 0.6, (k - 1, 2))
        if i % 7 == 0:
            steps[:, 1] = 0.0  # horizontal
        if i % 7 == 1:
            steps[:, 0] = 0.0
        lines.append(TG.LineString(np.vstack([start, start + np.cumsum(steps, axis=0)])))
    return lines


def test_intersectionmatrix_equals_jax(pair):
    """Random polylines (horizontal and vertical ones on cell edges and
    centres among them), the line of tests/test_gis.py, a point, a
    one-point line, a polygon and a line outside the grid: the same
    cells, exactly."""
    jc, tc = pair
    g = tc.grid_desc
    shapes = random_lines(g, 60, seed=4) + [
        TG.LineString([(g.x[0], g.y[3]), (g.x[-1], g.y[3])]),
        TG.LineString([(g.x[2] + g.dx / 2, g.y[0]), (g.x[2] + g.dx / 2, g.y[-1])]),
        TG.Point(g.x[4] + g.dx / 2, g.y[7]),
        TG.LineString([(-1.0, 58.0)]),
        matrix_cases(g)["multipolygon_with_hole"][0],
        TG.LineString([(100.0, 10.0), (101.0, 10.0)]),
    ]
    got = tc.intersectionmatrix(shapes)
    want = jc.intersectionmatrix([to_jax(s) for s in shapes])
    assert_same_matrix(got, want, rtol=0)
    rows = sp.csr_matrix(got)[60]
    assert rows.nnz == len(g.x) and np.all(rows.indices // len(g.x) == 3)
    assert sp.csr_matrix(got)[-1].nnz == 0


def test_intersectionmatrix_through_shapes_crs(pair):
    jc, tc = pair
    lines = [TG.transform_geometry(s, 4326, 3035) for s in random_lines(tc.grid_desc, 12, 5)]
    assert_same_matrix(tc.intersectionmatrix(lines, shapes_crs=3035),
                       jc.intersectionmatrix([to_jax(s) for s in lines], shapes_crs=3035), rtol=0)


def test_engine_against_numpy(pair, monkeypatch):
    """``_shape_window_areas`` by the C++ engine and by numpy, called
    directly, on random boxes, triangles and the holed MultiPolygon."""
    _, tc = pair
    g = tc.grid_desc
    assert native.get_lib() is not None  # g++ builds it here
    assert native.library_path().parent.name == "native"
    rng = np.random.default_rng(6)
    shapes = random_boxes(g, 8, seed=7) + matrix_cases(g)["multipolygon_with_hole"] + [
        TG.Polygon(rng.uniform([g.x[0], g.y[0]], [g.x[-1], g.y[-1]], (3, 2)))
        for _ in range(8)]
    engine = [tmatrix._shape_window_areas(g, s) for s in shapes]
    monkeypatch.setattr(native, "get_lib", lambda: None)
    plain = [tmatrix._shape_window_areas(g, s) for s in shapes]
    for (i0, j0, a), (p0, q0, b) in zip(engine, plain):
        assert (i0, j0) == (p0, q0) and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        assert (a > 0).sum() > 0


def test_engine_that_does_not_build_warns_once(monkeypatch, caplog, tmp_path):
    """Without g++ the loader returns None, logs one warning and the
    matrices fall back to numpy."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.get_lib() is None
        assert native.get_lib() is None
    assert len([r for r in caplog.records if "did not build" in r.getMessage()]) == 1
    c = Cutout(device="cpu", **BOUNDS)
    vals = np.asarray(c.indicatormatrix(matrix_cases(c.grid_desc)["partial_overlap"]).todense())
    np.testing.assert_allclose(vals[vals > 0], [0.25] * 4)


CRS_CASES = [(4326, 3035), (3035, 4326), (4326, "cea"), ("cea", 4326), (4326, 32632),
             (32632, 4326), (4326, 3857), (3857, 4326), (3035, 32632)]


@pytest.mark.parametrize("src, dst", CRS_CASES, ids=[f"{a}-{b}" for a, b in CRS_CASES])
def test_transform_points_equals_jax(src, dst):
    rng = np.random.default_rng(8)
    lon, lat = rng.uniform(-10, 30, 200), rng.uniform(35, 70, 200)
    x, y = jcrs.transform_points(lon, lat, 4326, src)
    got = tcrs.transform_points(x, y, src, dst)
    want = jcrs.transform_points(x, y, src, dst)
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_, w, rtol=1e-9)
    assert tcrs.normalize_crs("EPSG:3035") == jcrs.normalize_crs("EPSG:3035") == 3035
    assert tcrs.normalize_crs({"proj": "cea"}) == jcrs.normalize_crs({"proj": "cea"})


def test_area_equals_jax(pair):
    """The cases of tests/test_gis.py: the lon/lat cells sum to the
    extent, 3035 cells are 2e8-8e8 m^2 and shrink northwards."""
    jc, tc = pair
    g = tc.grid_desc
    area = tc.area()
    assert area.dims == ("y", "x")
    extent = (g.x[0] - g.dx / 2, g.x[-1] + g.dx / 2, g.y[0] - g.dy / 2, g.y[-1] + g.dy / 2)
    assert np.isclose(area.values.sum(), (extent[1] - extent[0]) * (extent[3] - extent[2]),
                      rtol=1e-9)
    np.testing.assert_allclose(area.values, np.asarray(jc.area().values), rtol=1e-12)
    a3035 = tc.area(crs=3035).values
    assert a3035.min() > 2e8 and a3035.max() < 8e8 and a3035[0].mean() > a3035[-1].mean()
    np.testing.assert_allclose(a3035, np.asarray(jc.area(crs=3035).values), rtol=1e-12)


def test_layouts_equal_jax(pair):
    jc, tc = pair
    np.testing.assert_array_equal(tc.uniform_layout().values, jc.uniform_layout().values)
    np.testing.assert_allclose(tc.uniform_density_layout(2.5, crs=3035).values,
                               np.asarray(jc.uniform_density_layout(2.5, crs=3035).values),
                               rtol=1e-12)
    g = tc.grid_desc
    rng = np.random.default_rng(9)
    table = pd.DataFrame({"x": np.r_[g.x[0], rng.uniform(g.x[0], g.x[-1], 30)],
                          "y": np.r_[g.y[0], rng.uniform(g.y[0], g.y[-1], 30)],
                          "Capacity": rng.uniform(1, 50, 31), "p_nom": rng.uniform(1, 9, 31)})
    for col in ("Capacity", "p_nom"):
        want = np.asarray(jc.layout_from_capacity_list(table, col=col).values)
        got = tc.layout_from_capacity_list(table, col=col)
        assert got.dims == ("y", "x")
        np.testing.assert_array_equal(got.values, want)
        as_dict = {k: table[k].tolist() for k in table}
        np.testing.assert_array_equal(tc.layout_from_capacity_list(as_dict, col=col).values,
                                      want)


def wind(c, **kw):
    return c.wind("Vestas_V112_3MW", **kw)


def pv(c, **kw):
    return c.pv("CSi", {"slope": 30.0, "azimuth": 180.0}, **kw)


def both(pair, conv, shapes, **kw):
    jc, tc = pair
    fn = {"wind": wind, "pv": pv}[conv]
    jkw = dict(kw)
    if "layout" in kw:
        jkw["layout"] = jc.uniform_density_layout(*kw["layout"])
        kw["layout"] = tc.uniform_density_layout(*kw["layout"])
    with jax.enable_x64(False), warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        want = fn(jc, shapes=jax_shapes(shapes), **jkw)
    got = fn(tc, shapes=shapes, **kw)
    return got, want


def assert_close(got, want):
    if isinstance(want, tuple):
        for g_, w in zip(got, want):
            assert_close(g_, w)
        return
    w = np.asarray(want.values)
    assert got.dims == want.dims and got.values.shape == w.shape
    for d in want.dims:
        if d != "time":
            np.testing.assert_array_equal(np.asarray(got.coords[d]), np.asarray(want.coords[d]))
    assert got.attrs.get("units") == want.attrs.get("units")
    np.testing.assert_array_equal(np.isnan(got.values), np.isnan(w))
    ok = ~np.isnan(w)
    assert np.abs(got.values[ok] - w[ok]).max() <= 1e-5 * np.abs(w[ok]).max()


SHAPES_CASES = {
    "per_unit": dict(per_unit=True, aggregate_time=None),
    "per_unit_streamed": dict(per_unit=True, aggregate_time=None, time_chunk=7),
    "layout_capacity": dict(layout=(3.0, 3035), return_capacity=True, aggregate_time=None),
    "layout_streamed_sum": dict(layout=(3.0, None), aggregate_time="sum", time_chunk=10),
    "shapes_crs_3035": dict(shapes_crs=3035, per_unit=True, aggregate_time="mean"),
}


@pytest.mark.parametrize("case", sorted(SHAPES_CASES))
@pytest.mark.parametrize("conv", ["wind", "pv"])
def test_shapes_aggregation_equals_jax(pair, conv, case):
    g = pair[1].grid_desc
    boxes = random_boxes(g, 6, seed=10) + matrix_cases(g)["multipolygon_with_hole"]
    kw = dict(SHAPES_CASES[case])
    if kw.get("shapes_crs") == 3035:
        boxes = [TG.transform_geometry(b, 4326, 3035) for b in boxes]
    shapes = pd.Series(boxes, index=pd.Index([f"r{i}" for i in range(len(boxes))], name="region"))
    got, want = both(pair, conv, shapes, **kw)
    assert_close(got, want)
    res = got[0] if isinstance(got, tuple) else got
    assert res.dims[0] == "region"
    np.testing.assert_array_equal(res.coords["region"], shapes.index)


def test_shapes_equals_its_matrix(pair):
    """shapes= gives the bits of matrix= with the shapes' indicator matrix;
    a list of shapes is labelled 0..n-1."""
    _, tc = pair
    shapes = random_boxes(tc.grid_desc, 5, seed=11)
    got = wind(tc, shapes=shapes, aggregate_time=None)
    want = wind(tc, matrix=tc.indicatormatrix(shapes), aggregate_time=None)
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.coords["bus"], np.arange(5))


def test_matrix_and_shapes_raise(pair):
    for c in pair:
        shapes = [JG.box(-3, 57, -1, 59) if isinstance(c, atlite_tpu.Cutout)
                  else TG.box(-3, 57, -1, 59)]
        m = sp.csr_matrix((1, c.shape[0] * c.shape[1]))
        with pytest.raises(ValueError, match="ambiguous"):
            wind(c, matrix=m, shapes=shapes, aggregate_time=None)



def test_gis_namespace_equals_jax():
    """The names the port's ``gis`` exports are the JAX ``gis``'s."""
    import atlite_tpu.gis as jgis

    import atlite_tpu_torch.gis as tgis

    for name in tgis.__all__:
        assert hasattr(jgis, name), name
    c = Cutout(device="cpu", **BOUNDS)
    boxes = random_boxes(c.grid_desc, 3, seed=12)
    assert_same_matrix(tgis.compute_indicatormatrix(c.grid_desc, boxes),
                       jgis.compute_indicatormatrix(c.grid_desc, jax_shapes(boxes)))
